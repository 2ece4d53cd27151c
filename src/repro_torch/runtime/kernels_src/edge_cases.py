"""Programs that drive the SIMT machine through the corners where an
exact reproduction of the JAX machine can break (see
``core/simt/machine.py``): float edge values through every ALU op,
stores whose masked-off lanes alias active lanes' words, sub-word
stores from several lanes into one word, a store pair aliasing dmem and
smem, and IPDOM stacks deeper than the configured depth.

Each function returns the assembly text and, where it needs one, the
data-memory image; both machines (the plain loop and the CUDA kernel,
and the JAX machine in the tests) run the same words.  Every program
is a few thousand cycles at most.
"""
from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import numpy as np

# u32 patterns: a denormal, -0, 1.0, 2^-126 (2 - 2^-23) (tiny when
# halved), 2.0, a quiet NaN with a payload, a negative signalling NaN,
# +inf, -1 (a negative quiet NaN as a float), 3e9 (saturates fcvt.w.s)
EDGE_WORDS = (0x00000001, 0x80000000, 0x3F800000, 0x00FFFFFF, 0x40000000,
              0x7FC12345, 0xFF812345, 0x7F800000, 0xFFFFFFFF, 0x4F32D05E)
EDGE_OPS = ("fadd.s", "fsub.s", "fmul.s", "fdiv.s", "fsqrt.s", "fmin.s",
            "fmax.s", "feq.s", "flt.s", "fle.s", "fcvt.w.s", "fcvt.s.w",
            "mul", "mulh", "mulhsu", "mulhu", "div", "divu", "rem", "remu",
            "sll", "srl", "sra", "slt", "sltu")
A_BASE, B_BASE, OUT_BASE = 0x1000, 0x2000, 0x4000


def alu_edges(words: Sequence[int] = EDGE_WORDS,
              ops: Sequence[str] = EDGE_OPS,
              dmem_words: int = 1 << 16) -> Tuple[str, np.ndarray, int]:
    """Every op of `ops` on every ordered pair (a, b) of `words`, a warp's
    lanes taking one pair each.  Result of op k for pair i lands at byte
    ``OUT_BASE + 4 * (k * n + i)``.  Returns (asm, dmem image, n pairs)."""
    pairs = list(itertools.product(words, repeat=2))
    n = len(pairs)
    image = np.zeros(dmem_words, np.int64)
    image[A_BASE // 4: A_BASE // 4 + n] = [a for a, _ in pairs]
    image[B_BASE // 4: B_BASE // 4 + n] = [b for _, b in pairs]
    body = "\n".join(f"    {op} a2, a0, a1\n    sw a2, 0(t3)\n"
                     f"    add t3, t3, t4" for op in ops)
    src = f"""
    nt   t0
    tmc  t0
    tid  s6
    nt   s3
    li   s4, {n}
    li   s1, 0
_loop:
    bge  s1, s4, _done
    add  s2, s1, s6          # pair index
    slt  t0, s2, s4
    __if t0
    slli t1, s2, 2
    li   t2, {A_BASE}
    add  t2, t2, t1
    lw   a0, 0(t2)
    li   t2, {B_BASE}
    add  t2, t2, t1
    lw   a1, 0(t2)
    li   t3, {OUT_BASE}
    add  t3, t3, t1
    li   t4, {4 * n}
{body}
    __endif
    add  s1, s1, s3
    j    _loop
_done:
    halt
"""
    return src, image.astype(np.uint32).view(np.int32), n


# Needs 4 lanes at least.  (1) In a then-path of lanes 0, 1, lanes 0..3
# store to word (tid & 1): masked-off lanes 2, 3 alias lanes 0, 1 and
# write their old words back, undoing both stores.  (2) sb and sh from
# every lane into one word at byte offset tid: each merges into the same
# old word, so only the highest lane's bytes stay (sh at offset 3 keeps
# one byte).  (3) lane t stores to address t * 0x10000000: lane 0 to
# dmem word 0, lanes 1-3 to smem word 0, which also aliases dmem word 0
# (so lane 3 writes dmem's old word back) and each other.  (4) sub-word
# loads of what (2) left, signed and unsigned.
ALIAS_STORES = """
    nt   t0
    tmc  t0
    tid  t1
    li   s0, 0x400
    andi t2, t1, 1
    slli t2, t2, 2
    add  t3, s0, t2
    addi t4, t1, 100
    slti t5, t1, 2
    __if t5
    sw   t4, 0(t3)
    __endif
    li   s1, 0x500
    add  t3, s1, t1
    addi t4, t1, 0xF1
    sb   t4, 0(t3)
    li   s1, 0x600
    add  t3, s1, t1
    li   t4, -2
    sub  t4, t4, t1
    sh   t4, 0(t3)
    li   t6, 0x10000000
    mul  t2, t1, t6
    addi t4, t1, 7
    sw   t4, 0(t2)
    lw   a0, 0(t2)
    li   s1, 0x500
    add  t3, s1, t1
    lb   a1, 0(t3)
    lbu  a2, 0(t3)
    li   s1, 0x600
    andi t5, t1, 2
    add  t3, s1, t5
    lh   a3, 0(t3)
    lhu  a4, 0(t3)
    slli t5, t1, 2
    li   s2, 0x700
    add  t5, s2, t5
    sw   a0, 0(t5)
    sw   a1, 16(t5)
    sw   a2, 32(t5)
    sw   a3, 48(t5)
    sw   a4, 64(t5)
    halt
"""

# Three nested divergent ifs: with ipdom_depth 2 the pushes past the
# depth are dropped and the pops read the last entry again (the JAX
# machine's scatter-drop / gather-clamp), so control flow goes astray;
# the run ends at max_cycles or when the warp halts, the same way on
# both machines.
IPDOM_OVERFLOW = """
    nt   t0
    tmc  t0
    tid  t1
    li   t6, 0
    slti t2, t1, 3
    __if t2
    addi t6, t6, 1
    slti t3, t1, 2
    __if t3
    addi t6, t6, 10
    slti t4, t1, 1
    __if t4
    addi t6, t6, 100
    __endif
    __endif
    __else
    addi t6, t6, 1000
    __endif
    slli t2, t1, 2
    li   t3, 0x200
    add  t2, t2, t3
    sw   t6, 0(t2)
    halt
"""
