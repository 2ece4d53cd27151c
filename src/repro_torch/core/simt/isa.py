"""RISC-V RV32IM (+ Zfinx float subset) + the five Vortex SIMT instructions.

Real RV32 encodings (R/I/S/B/U/J formats).  The Vortex extension lives on
the CUSTOM-0 opcode (0x0B) — the same major opcode the actual Vortex RTL
uses — with funct3 selecting:

    funct3  instr                 operands
    0       tmc   %numT           rs1 = thread count
    1       wspawn %numW, %PC     rs1 = warp count, rs2 = entry PC
    2       split %pred, off      rs1 = per-lane predicate, B-imm = offset
                                  of the ELSE path (Table I's bare form +
                                  the target the paper's hardware takes
                                  from the adjacent compiler branch; we
                                  fold it into the instruction — same
                                  information, one instruction)
    3       join
    4       bar   %barID, %numW   rs1 = barrier id (MSB -> global),
                                  rs2 = warps to wait for

Floats follow the Zfinx convention (float operands live in x-registers):
a documented simplification that keeps the register file identical to the
paper's (one 32-entry GPR per thread) while letting Rodinia kernels use
float math.  CSRs expose the SIMT geometry exactly like the Vortex runtime
(vx_getTid & friends in Fig 2).

A copy of ``repro.core.simt.isa`` (the port imports nothing of
``repro``).
"""
from __future__ import annotations

from typing import Dict

# ---------------------------------------------------------------------------
# major opcodes
# ---------------------------------------------------------------------------

OP_LUI = 0x37
OP_AUIPC = 0x17
OP_JAL = 0x6F
OP_JALR = 0x67
OP_BRANCH = 0x63
OP_LOAD = 0x03
OP_STORE = 0x23
OP_IMM = 0x13
OP_OP = 0x33
OP_SYSTEM = 0x73
OP_CUSTOM0 = 0x0B          # Vortex SIMT extension
OP_FP = 0x53               # Zfinx float ops

# Vortex funct3
VX_TMC, VX_WSPAWN, VX_SPLIT, VX_JOIN, VX_BAR = 0, 1, 2, 3, 4

# CSR numbers (match the Vortex runtime's intrinsics)
CSR_TID = 0xCC0      # lane (thread) id          vx_getTid
CSR_WID = 0xCC1      # warp id                   vx_getWid
CSR_NT = 0xCC2       # threads per warp          vx_getNT
CSR_NW = 0xCC3       # warps per core            vx_getNW
CSR_CID = 0xCC4      # core id
CSR_CYCLE = 0xB00

REG_NAMES = {f"x{i}": i for i in range(32)}
REG_NAMES.update({
    "zero": 0, "ra": 1, "sp": 2, "gp": 3, "tp": 4,
    "t0": 5, "t1": 6, "t2": 7, "s0": 8, "fp": 8, "s1": 9,
    "a0": 10, "a1": 11, "a2": 12, "a3": 13, "a4": 14, "a5": 15,
    "a6": 16, "a7": 17,
    **{f"s{i}": 16 + i for i in range(2, 12)},
    "t3": 28, "t4": 29, "t5": 30, "t6": 31,
})


def reg(name: str) -> int:
    if isinstance(name, int):
        return name
    n = REG_NAMES.get(name.lower())
    if n is None:
        raise ValueError(f"unknown register {name!r}")
    return n


# ---------------------------------------------------------------------------
# format encoders
# ---------------------------------------------------------------------------

def _check_range(v: int, lo: int, hi: int, what: str):
    if not lo <= v <= hi:
        raise ValueError(f"{what} {v} out of range [{lo},{hi}]")


def enc_r(opcode, rd, funct3, rs1, rs2, funct7=0) -> int:
    return ((funct7 & 0x7F) << 25) | ((rs2 & 31) << 20) | ((rs1 & 31) << 15) \
        | ((funct3 & 7) << 12) | ((rd & 31) << 7) | opcode


def enc_i(opcode, rd, funct3, rs1, imm) -> int:
    _check_range(imm, -2048, 4095, "I-imm")       # allow unsigned CSR addr
    return ((imm & 0xFFF) << 20) | ((rs1 & 31) << 15) | ((funct3 & 7) << 12) \
        | ((rd & 31) << 7) | opcode


def enc_s(opcode, funct3, rs1, rs2, imm) -> int:
    _check_range(imm, -2048, 2047, "S-imm")
    return (((imm >> 5) & 0x7F) << 25) | ((rs2 & 31) << 20) \
        | ((rs1 & 31) << 15) | ((funct3 & 7) << 12) \
        | ((imm & 0x1F) << 7) | opcode


def enc_b(opcode, funct3, rs1, rs2, imm) -> int:
    _check_range(imm, -4096, 4094, "B-imm")
    if imm & 1:
        raise ValueError("B-imm must be even")
    return (((imm >> 12) & 1) << 31) | (((imm >> 5) & 0x3F) << 25) \
        | ((rs2 & 31) << 20) | ((rs1 & 31) << 15) | ((funct3 & 7) << 12) \
        | (((imm >> 1) & 0xF) << 8) | (((imm >> 11) & 1) << 7) | opcode


def enc_u(opcode, rd, imm) -> int:
    return ((imm & 0xFFFFF) << 12) | ((rd & 31) << 7) | opcode


def enc_j(opcode, rd, imm) -> int:
    _check_range(imm, -(1 << 20), (1 << 20) - 2, "J-imm")
    return (((imm >> 20) & 1) << 31) | (((imm >> 1) & 0x3FF) << 21) \
        | (((imm >> 11) & 1) << 20) | (((imm >> 12) & 0xFF) << 12) \
        | ((rd & 31) << 7) | opcode


# ---------------------------------------------------------------------------
# instruction table: mnemonic -> (format, encoder args)
# ---------------------------------------------------------------------------

# (format, opcode, funct3, funct7)
ITAB: Dict[str, tuple] = {
    # RV32I
    "lui":   ("U", OP_LUI),
    "auipc": ("U", OP_AUIPC),
    "jal":   ("J", OP_JAL),
    "jalr":  ("I", OP_JALR, 0),
    "beq":   ("B", OP_BRANCH, 0), "bne": ("B", OP_BRANCH, 1),
    "blt":   ("B", OP_BRANCH, 4), "bge": ("B", OP_BRANCH, 5),
    "bltu":  ("B", OP_BRANCH, 6), "bgeu": ("B", OP_BRANCH, 7),
    "lb":    ("I", OP_LOAD, 0), "lh": ("I", OP_LOAD, 1),
    "lw":    ("I", OP_LOAD, 2),
    "lbu":   ("I", OP_LOAD, 4), "lhu": ("I", OP_LOAD, 5),
    "sb":    ("S", OP_STORE, 0), "sh": ("S", OP_STORE, 1),
    "sw":    ("S", OP_STORE, 2),
    "addi":  ("I", OP_IMM, 0), "slti": ("I", OP_IMM, 2),
    "sltiu": ("I", OP_IMM, 3), "xori": ("I", OP_IMM, 4),
    "ori":   ("I", OP_IMM, 6), "andi": ("I", OP_IMM, 7),
    "slli":  ("Ishamt", OP_IMM, 1, 0x00),
    "srli":  ("Ishamt", OP_IMM, 5, 0x00),
    "srai":  ("Ishamt", OP_IMM, 5, 0x20),
    "add":   ("R", OP_OP, 0, 0x00), "sub": ("R", OP_OP, 0, 0x20),
    "sll":   ("R", OP_OP, 1, 0x00), "slt": ("R", OP_OP, 2, 0x00),
    "sltu":  ("R", OP_OP, 3, 0x00), "xor": ("R", OP_OP, 4, 0x00),
    "srl":   ("R", OP_OP, 5, 0x00), "sra": ("R", OP_OP, 5, 0x20),
    "or":    ("R", OP_OP, 6, 0x00), "and": ("R", OP_OP, 7, 0x00),
    "ecall": ("I", OP_SYSTEM, 0),
    "csrrs": ("Icsr", OP_SYSTEM, 2),
    "csrrw": ("Icsr", OP_SYSTEM, 1),
    # RV32M
    "mul":   ("R", OP_OP, 0, 0x01), "mulh": ("R", OP_OP, 1, 0x01),
    "mulhsu": ("R", OP_OP, 2, 0x01), "mulhu": ("R", OP_OP, 3, 0x01),
    "div":   ("R", OP_OP, 4, 0x01), "divu": ("R", OP_OP, 5, 0x01),
    "rem":   ("R", OP_OP, 6, 0x01), "remu": ("R", OP_OP, 7, 0x01),
    # Zfinx subset (floats in x-regs)
    "fadd.s": ("R", OP_FP, 0, 0x00), "fsub.s": ("R", OP_FP, 0, 0x04),
    "fmul.s": ("R", OP_FP, 0, 0x08), "fdiv.s": ("R", OP_FP, 0, 0x0C),
    "fsqrt.s": ("R", OP_FP, 0, 0x2C),
    "fmin.s": ("R", OP_FP, 0, 0x14), "fmax.s": ("R", OP_FP, 1, 0x14),
    "feq.s": ("R", OP_FP, 2, 0x50), "flt.s": ("R", OP_FP, 1, 0x50),
    "fle.s": ("R", OP_FP, 0, 0x50),
    "fcvt.w.s": ("R", OP_FP, 0, 0x60),   # float -> int (truncate)
    "fcvt.s.w": ("R", OP_FP, 0, 0x68),   # int -> float
    # Vortex SIMT extension (CUSTOM-0)
    "tmc":    ("R", OP_CUSTOM0, VX_TMC, 0),
    "wspawn": ("R", OP_CUSTOM0, VX_WSPAWN, 0),
    "split":  ("B", OP_CUSTOM0, VX_SPLIT),
    # join carries the reconvergence offset (used only when the popped
    # else-entry is empty — the all-true uniform case; see machine.py).
    # The paper's HW gets the same information by re-executing the
    # compiler's branch at split-PC+4 (§IV-C); we fold it into the imm.
    "join":   ("B", OP_CUSTOM0, VX_JOIN),
    "bar":    ("R", OP_CUSTOM0, VX_BAR, 0),
}


def encode(mnemonic: str, *, rd=0, rs1=0, rs2=0, imm=0) -> int:
    ent = ITAB[mnemonic]
    fmt = ent[0]
    if fmt == "U":
        return enc_u(ent[1], rd, imm)
    if fmt == "J":
        return enc_j(ent[1], rd, imm)
    if fmt == "B":
        return enc_b(ent[1], ent[2], rs1, rs2, imm)
    if fmt == "S":
        return enc_s(ent[1], ent[2], rs1, rs2, imm)
    if fmt == "I":
        return enc_i(ent[1], rd, ent[2], rs1, imm)
    if fmt == "Icsr":
        return enc_i(ent[1], rd, ent[2], rs1, imm)
    if fmt == "Ishamt":
        return enc_i(ent[1], rd, ent[2], rs1, (ent[3] << 5) | (imm & 31))
    if fmt == "R":
        return enc_r(ent[1], rd, ent[2], rs1, rs2, ent[3])
    raise ValueError(fmt)
