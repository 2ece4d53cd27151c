"""Text assembler for RV32IM + Zfinx + the Vortex SIMT extension.

The software-stack analogue of the paper's Fig 3: kernels are written as
assembly text against the intrinsic layer; `__if pred` / `__else` /
`__endif` structured-divergence macros expand to split/join exactly as the
paper's C macros do (including the two-join shape an if-without-else needs
for IPDOM balance).

Syntax:
    label:              # defines a label
    addi t0, t0, 1      # registers by ABI name or xN
    lw   a0, 4(a1)      # loads/stores with offset(base) form
    beq  a0, a1, label  # branch targets are labels
    li   t0, 1234       # pseudo: li, la, mv, not, neg, j, ret, nop, halt
    %tid, %wid, %nt, %nw, %cycle as csrr pseudo ops: tid rd
    __if t0             # divergence macros (nestable)
    __else
    __endif
    bar 0, 4            # barrier id 0, wait for 4 warps
    .word 0xdeadbeef    # literal data / raw encodings

A copy of ``repro.runtime.asm``, importing the port's ``isa``.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.simt import isa
from repro_torch.core.simt.isa import reg


class AsmError(ValueError):
    pass


def _imm(tok: str, labels: Dict[str, int], pc: Optional[int] = None,
         pcrel: bool = False) -> int:
    tok = tok.strip()
    if tok in labels:
        return labels[tok] - pc if pcrel else labels[tok]
    try:
        return int(tok, 0)
    except ValueError:
        raise AsmError(f"bad immediate/label {tok!r}")


_MEM_RE = re.compile(r"^(-?\w+)\((\w+)\)$")


def assemble(src: str, *, base: int = 0) -> np.ndarray:
    """Two-pass assembly -> np.uint32 instruction words."""
    # pass 0: tokenize, expand structured macros
    lines: List[Tuple[str, List[str]]] = []
    if_stack: List[Tuple[int, bool]] = []      # (id, has_else)
    uid = [0]

    def expand(mnem: str, args: List[str]) -> List[Tuple[str, List[str]]]:
        if mnem == "__if":
            uid[0] += 1
            if_stack.append((uid[0], False))
            return [("split", [args[0], f"__else_{uid[0]}"])]
        if mnem == "__else":
            i, _ = if_stack.pop()
            if_stack.append((i, True))
            return [("join", [f"__endif_{i}"]), (f"__else_{i}:", [])]
        if mnem == "__endif":
            i, has_else = if_stack.pop()
            if has_else:
                return [("join", [f"__endif_{i}"]), (f"__endif_{i}:", [])]
            # no else: then-join targets the second join; both carry the
            # reconvergence offset for the empty-else fast path
            return [("join", [f"__endif_{i}"]), (f"__else_{i}:", []),
                    ("join", [f"__endif_{i}"]), (f"__endif_{i}:", [])]
        return [(mnem, args)]

    for raw in src.splitlines():
        line = raw.split("#")[0].strip()
        if not line:
            continue
        while ":" in line.split()[0] if line else False:
            head, _, rest = line.partition(":")
            lines.append((head.strip() + ":", []))
            line = rest.strip()
            if not line:
                break
        if not line:
            continue
        parts = line.replace(",", " ").split()
        for item in expand(parts[0].lower(), parts[1:]):
            if item[0].endswith(":"):
                lines.append(item)
            else:
                lines.append(item)
    if if_stack:
        raise AsmError("unbalanced __if/__endif")

    # pass 1: label addresses (account for multi-word pseudos)
    def n_words(mnem: str, args: List[str]) -> int:
        if mnem.endswith(":"):
            return 0
        if mnem == "li":
            v = int(args[1], 0)
            return 1 if -2048 <= v < 2048 else 2
        if mnem == "la":
            return 2
        return 1

    labels: Dict[str, int] = {}
    pc = base
    for mnem, args in lines:
        if mnem.endswith(":"):
            labels[mnem[:-1]] = pc
        else:
            pc += 4 * n_words(mnem, args)

    # pass 2: encode
    words: List[int] = []
    pc = base
    for mnem, args in lines:
        if mnem.endswith(":"):
            continue
        ws = _encode_one(mnem, args, labels, pc)
        words.extend(ws)
        pc += 4 * len(ws)
    return np.asarray(words, np.uint32)


def _encode_one(m: str, a: List[str], labels, pc) -> List[int]:
    E = isa.encode

    # ---- pseudo instructions ----------------------------------------------
    if m == "nop":
        return [E("addi", rd=0, rs1=0, imm=0)]
    if m == "mv":
        return [E("addi", rd=reg(a[0]), rs1=reg(a[1]), imm=0)]
    if m == "not":
        return [E("xori", rd=reg(a[0]), rs1=reg(a[1]), imm=-1)]
    if m == "neg":
        return [E("sub", rd=reg(a[0]), rs1=0, rs2=reg(a[1]))]
    if m == "seqz":
        return [E("sltiu", rd=reg(a[0]), rs1=reg(a[1]), imm=1)]
    if m == "snez":
        return [E("sltu", rd=reg(a[0]), rs1=0, rs2=reg(a[1]))]
    if m == "j":
        return [E("jal", rd=0, imm=_imm(a[0], labels, pc, pcrel=True))]
    if m == "jal" and len(a) == 1:
        return [E("jal", rd=1, imm=_imm(a[0], labels, pc, pcrel=True))]
    if m == "ret":
        return [E("jalr", rd=0, rs1=1, imm=0)]
    if m == "halt":                      # warp exit
        return [E("ecall")]
    if m == "li":
        v = _imm(a[1], labels)
        if -2048 <= v < 2048:
            return [E("addi", rd=reg(a[0]), rs1=0, imm=v)]
        hi = (v + 0x800) >> 12
        lo = v - (hi << 12)
        return [E("lui", rd=reg(a[0]), imm=hi & 0xFFFFF),
                E("addi", rd=reg(a[0]), rs1=reg(a[0]), imm=lo)]
    if m == "la":
        v = _imm(a[1], labels)
        hi = (v + 0x800) >> 12
        lo = v - (hi << 12)
        return [E("lui", rd=reg(a[0]), imm=hi & 0xFFFFF),
                E("addi", rd=reg(a[0]), rs1=reg(a[0]), imm=lo)]
    # csr pseudos (the vx_* intrinsics of Fig 2)
    csr_map = {"tid": isa.CSR_TID, "wid": isa.CSR_WID, "nt": isa.CSR_NT,
               "nw": isa.CSR_NW, "cid": isa.CSR_CID, "rdcycle": isa.CSR_CYCLE}
    if m in csr_map:
        return [E("csrrs", rd=reg(a[0]), rs1=0, imm=csr_map[m])]

    # ---- vortex instructions ----------------------------------------------
    if m == "tmc":
        return [E("tmc", rs1=reg(a[0]))]
    if m == "wspawn":
        return [E("wspawn", rs1=reg(a[0]), rs2=reg(a[1]))]
    if m == "split":
        off = _imm(a[1], labels, pc, pcrel=True) if len(a) > 1 else 4
        return [E("split", rs1=reg(a[0]), imm=off)]
    if m == "join":
        off = _imm(a[0], labels, pc, pcrel=True) if a else 4
        return [E("join", imm=off)]
    if m == "bar":
        return [E("bar", rs1=reg(a[0]), rs2=reg(a[1]))]

    if m == ".word":
        return [_imm(a[0], labels) & 0xFFFFFFFF]

    ent = isa.ITAB.get(m)
    if ent is None:
        raise AsmError(f"unknown mnemonic {m!r}")
    fmt = ent[0]
    if fmt == "B":
        return [E(m, rs1=reg(a[0]), rs2=reg(a[1]),
                  imm=_imm(a[2], labels, pc, pcrel=True))]
    if fmt == "J":
        return [E(m, rd=reg(a[0]), imm=_imm(a[1], labels, pc, pcrel=True))]
    if fmt == "U":
        return [E(m, rd=reg(a[0]), imm=_imm(a[1], labels))]
    if fmt == "S":
        mm = _MEM_RE.match(a[1])
        if not mm:
            raise AsmError(f"store needs off(base): {a}")
        return [E(m, rs1=reg(mm.group(2)), rs2=reg(a[0]),
                  imm=_imm(mm.group(1), labels))]
    if fmt == "I" and ent[1] == isa.OP_LOAD:
        mm = _MEM_RE.match(a[1])
        if not mm:
            raise AsmError(f"load needs off(base): {a}")
        return [E(m, rd=reg(a[0]), rs1=reg(mm.group(2)),
                  imm=_imm(mm.group(1), labels))]
    if m == "jalr":
        return [E(m, rd=reg(a[0]), rs1=reg(a[1]),
                  imm=_imm(a[2], labels) if len(a) > 2 else 0)]
    if m == "ecall":
        return [E(m)]
    if fmt in ("I", "Ishamt", "Icsr"):
        return [E(m, rd=reg(a[0]), rs1=reg(a[1]), imm=_imm(a[2], labels))]
    if fmt == "R":
        return [E(m, rd=reg(a[0]), rs1=reg(a[1]), rs2=reg(a[2]))]
    raise AsmError(f"cannot encode {m} {a}")
