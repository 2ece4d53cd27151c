"""Intrinsic layer — the Fig 2 `vx_*` API as assembler mnemonics.

The paper implements each intrinsic as two instructions (the encoded word +
ret) so no compiler changes are needed; our assembler gives each one a
mnemonic instead, which is the same contract (kernel code never constructs
encodings by hand):

    paper intrinsic        asm mnemonic        hardware
    vx_getTid()            tid rd              CSR 0xCC0
    vx_getWid()            wid rd              CSR 0xCC1
    vx_getNT()             nt rd               CSR 0xCC2
    vx_getNW()             nw rd               CSR 0xCC3
    vx_getCoreId()         cid rd              CSR 0xCC4
    vx_tmc(n)              tmc rs1             CUSTOM-0 f3=0
    vx_wspawn(n, pc)       wspawn rs1, rs2     CUSTOM-0 f3=1
    vx_split(pred)         split rs1, off      CUSTOM-0 f3=2
    vx_join()              join                CUSTOM-0 f3=3
    vx_barrier(id, n)      bar rs1, rs2        CUSTOM-0 f3=4

Fig 3's `__if/__else/__endif` divergence macros are provided by the
assembler (runtime/asm.py) and expand to split/join with the IPDOM-balanced
two-join shape.

A copy of ``repro.runtime.intrinsics``.
"""
from __future__ import annotations

INTRINSICS = ("tid", "wid", "nt", "nw", "cid", "tmc", "wspawn", "split",
              "join", "bar")
MACROS = ("__if", "__else", "__endif")
