"""pocl_spawn: the paper's §III-A.3 work-group mapping, faithfully.

The five steps of the paper's runtime routine:
  1. query the hardware resources (NW warps x NT threads) — done with the
     intrinsic CSRs inside the boot stub,
  2. divide the requested work among them,
  3. assign each warp a range of global IDs,
  4. spawn the warps / activate the threads (wspawn + tmc),
  5. each warp loops over its assigned IDs running the kernel body with a
     fresh global_id (Fig 4's per-warp loop).

Mapping (documented): OpenCL work-items are linearized; warp w's lane t
executes global ids  gid = (w*NT + t) + k*(NW*NT)  for k = 0,1,...  —
work-groups of size NT ride on single warps, so intra-group synchronization
is free (lockstep) and `bar` provides the cross-group (global) barrier,
exactly the structural split the paper describes.

The twin of ``repro.runtime.spawn``: both spawn functions run the
machine on `device` (``cuda`` unless told ``"cpu"``), and a
`LaunchResult` copies its words back from there.

ABI for kernel bodies (asm text fragments):
  s0 = kernel-args base pointer   s2 = global id (per lane)
  s4 = N (total work-items, args word 0)
  s1, s6 = scratch the stub owns (warp base, tid);  body may clobber
  t0-t6, a0-a7, s7-s11.  Bodies run under an __if(gid < N) guard.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.simt import machine
from repro_torch.core.simt.machine import MachineConfig
from repro_torch.device import DeviceLike
from repro_torch.runtime.asm import assemble

ARG_BASE = 0x80          # kernel argument words live here
DATA_BASE = 0x1000       # buffer allocations start here


BOOT = """
_start:
    nw   a0
    la   a1, _kmain
    wspawn a0, a1
    j    _kmain
_kmain:
    nt   t0
    tmc  t0              # activate all lanes (step 4)
    nt   t2
    nw   t3
    wid  t1
    li   s0, {arg_base}
    lw   s4, 0(s0)       # N
    mul  s3, t3, t2      # stride = NW*NT   (step 2)
    mul  s1, t1, t2      # warp base = wid*NT (step 3)
    tid  s6
_loop:
    bge  s1, s4, _done   # warp-uniform: base is lane-invariant
    add  s2, s1, s6      # gid = base + tid (step 5)
    slt  t0, s2, s4
    __if t0
{body}
    __endif
    add  s1, s1, s3
    j    _loop
_done:
    li   a0, 0
    nw   a1
    bar  a0, a1          # global barrier: all warps finish together
    halt
"""


class Allocator:
    """Bump allocator for device buffers in data memory."""

    def __init__(self, base: int = DATA_BASE):
        self.ptr = base
        self.image: Dict[int, np.ndarray] = {}

    def alloc(self, arr_or_words) -> int:
        if isinstance(arr_or_words, int):
            arr = np.zeros(arr_or_words, np.int32)
        else:
            arr = np.asarray(arr_or_words)
            if arr.dtype == np.float32:
                arr = arr.view(np.int32)
            arr = arr.astype(np.int32).ravel()
        addr = self.ptr
        self.image[addr] = arr
        self.ptr += 4 * len(arr)
        self.ptr = (self.ptr + 15) & ~15        # line-align
        return addr

    def build_dmem(self, words: int) -> np.ndarray:
        img = np.zeros(words, np.int32)
        for addr, arr in self.image.items():
            img[addr // 4: addr // 4 + len(arr)] = arr
        return img


@dataclasses.dataclass
class LaunchResult:
    state: machine.State
    stats: Dict[str, int]

    def words(self, addr: int, n: int) -> np.ndarray:
        """`n` words from byte address `addr`, copied to the host."""
        return machine.read_words(self.state, addr, n)

    def floats(self, addr: int, n: int) -> np.ndarray:
        return self.words(addr, n).view(np.float32)


def f32_bits(x: float) -> int:
    return int(np.float32(x).view(np.int32))


def pocl_spawn(mc: MachineConfig, body_asm: str, args: Sequence[int],
               n_items: int, alloc: Optional[Allocator] = None,
               prologue: str = "", epilogue: str = "",
               dmem_init=None, label: Optional[str] = None,
               device: DeviceLike = None) -> LaunchResult:
    """Launch `body_asm` over n_items work-items (the paper's pocl_spawn).

    args word 0 is always N; caller args follow from word 1.
    prologue/epilogue: asm outside the per-gid __if guard (e.g. barrier
    phases for multi-phase kernels).  dmem_init: carry device memory over
    from a previous launch (multi-kernel pipelines, e.g. gaussian's
    Fan1/Fan2; a numpy array or a tensor).  label: kernel name for
    per-launch telemetry (LaunchLog entries, `simt:launch:<label>` trace
    spans).  device: where the machine runs (None: ``cuda``)."""
    alloc = alloc or Allocator()
    argwords = [n_items] + [int(a) for a in args]
    src = BOOT.format(arg_base=ARG_BASE, body=prologue + body_asm + epilogue)
    prog = assemble(src)
    if isinstance(dmem_init, torch.Tensor):
        dmem_init = dmem_init.cpu().numpy()
    dmem = (np.array(dmem_init, np.int32) if dmem_init is not None
            else alloc.build_dmem(mc.dmem_words))
    dmem[ARG_BASE // 4: ARG_BASE // 4 + len(argwords)] = argwords
    st = machine.run(mc, prog, dmem_image=dmem, label=label, device=device)
    stats = machine.stats_dict(st)
    if stats["cycles"] >= mc.max_cycles:
        raise RuntimeError("kernel did not terminate within max_cycles")
    return LaunchResult(state=st, stats=stats)


def raw_spawn(mc: MachineConfig, src: str, alloc: Optional[Allocator] = None,
              argwords: Sequence[int] = (),
              label: Optional[str] = None,
              device: DeviceLike = None) -> LaunchResult:
    """Launch a fully hand-written program (kernels that manage their own
    warp loop / barrier structure, e.g. BFS and tiled sgemm)."""
    alloc = alloc or Allocator()
    prog = assemble(src)
    dmem = alloc.build_dmem(mc.dmem_words)
    if argwords:
        aw = list(map(int, argwords))
        dmem[ARG_BASE // 4: ARG_BASE // 4 + len(aw)] = aw
    st = machine.run(mc, prog, dmem_image=dmem, label=label, device=device)
    stats = machine.stats_dict(st)
    if stats["cycles"] >= mc.max_cycles:
        raise RuntimeError("kernel did not terminate within max_cycles")
    return LaunchResult(state=st, stats=stats)
