"""The SIMT machine's cycle loop as one CUDA kernel launch.

``simt_machine(mc, imem, st)`` runs the machine of state `st` (CUDA
tensors) to completion with one launch of ``csrc/simt_machine.cu`` and
returns the final state; the input state is left as it was.  Its plain
version is ``repro_torch.core.simt.machine.run_plain``; the machine's
``run`` calls this for CUDA states and the plain loop for CPU ones.
``launches`` counts kernel launches.

The kernel holds a Vortex warp's lanes in one CUDA warp, so it takes at
most ``MAX_THREADS`` threads per warp; its state, all but dmem, lives in
shared memory and must fit there.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.simt.machine import (M32, STAT_KEYS, MachineConfig,
                                           State, check_config)
from repro_torch.kernels import build

SOURCE = "src/repro_torch/csrc/simt_machine.cu"
MAX_THREADS = 32        # one CUDA warp holds the T lanes
_INTS = ("W", "T", "D", "NB", "MW", "SW", "sets", "tag_shift", "banks",
         "miss_latency", "miss_pipeline", "max_cycles", "imem_len")
_PTRS = ("imem", "pc", "active", "stalled_until", "at_barrier", "visible",
         "tmask", "gpr", "ipdom_pc", "ipdom_mask", "ipdom_ft", "ipdom_sp",
         "bar_count", "bar_release", "dmem", "smem", "tags", "tvalid", "lru",
         "counters")
_U32 = ("pc", "ipdom_pc")      # int64 tensors of u32 values in the State
_TOO_BIG = -1                   # simt_run: the state exceeds shared memory

launches = 0


class _Params(ctypes.Structure):
    """csrc/simt_machine.cu `SimtParams`, field for field."""
    _fields_ = ([(n, ctypes.c_int) for n in _INTS]
                + [(n, ctypes.c_void_p) for n in _PTRS])


def _check(mc: MachineConfig, imem: torch.Tensor, st: State) -> None:
    check_config(mc)
    if mc.threads > MAX_THREADS:
        raise ValueError(f"the SIMT kernel holds a warp's lanes in one CUDA "
                         f"warp: threads <= {MAX_THREADS}, got {mc.threads}")
    if not 0 < mc.max_cycles < 2**31:
        raise ValueError(f"max_cycles {mc.max_cycles} must fit the int32 "
                         f"cycle counter")
    dev = st.pc.device
    tensors = [imem, *(t for t in st if isinstance(t, torch.Tensor)),
               *st.stats.values()]
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"the SIMT kernel needs the program and state on "
                         f"one CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if imem.dtype != torch.int32 or imem.ndim != 1 or imem.numel() == 0:
        raise TypeError(f"imem must be a non-empty 1-d int32 tensor, got "
                        f"{imem.dtype} {tuple(imem.shape)}")
    W, T, D, NB = mc.warps, mc.threads, mc.ipdom_depth, mc.barriers
    shapes = dict(pc=(W,), active=(W,), stalled_until=(W,), at_barrier=(W,),
                  visible=(W,), tmask=(W, T), gpr=(W, T, 32),
                  ipdom_pc=(W, D), ipdom_mask=(W, D, T), ipdom_ft=(W, D),
                  ipdom_sp=(W,), bar_count=(NB,), bar_release=(NB, W),
                  dmem=(mc.dmem_words,), smem=(mc.smem_words,),
                  tags=(mc.sets, 2), tvalid=(mc.sets, 2), lru=(mc.sets,))
    for name, shape in shapes.items():
        got = getattr(st, name)
        if tuple(got.shape) != shape:
            raise ValueError(f"state.{name} has shape {tuple(got.shape)}, "
                             f"the config needs {shape}")


def simt_machine(mc: MachineConfig, imem: torch.Tensor, st: State) -> State:
    """Run the machine to completion in one kernel launch (see module)."""
    global launches
    _check(mc, imem, st)
    bufs = {}
    for name in State._fields:
        if name in ("cycle", "stats"):
            continue
        t = getattr(st, name)
        if name in _U32:        # u32 values -> their int32 bit patterns
            t = (t - ((t >> 31) << 32)).to(torch.int32)
        else:
            t = t.clone()
        bufs[name] = t.contiguous()
    bufs["counters"] = torch.stack(
        [st.stats[k] for k in STAT_KEYS] + [st.cycle]).to(torch.int32)
    bufs["imem"] = imem.contiguous()
    p = _Params(W=mc.warps, T=mc.threads, D=mc.ipdom_depth, NB=mc.barriers,
                MW=mc.dmem_words, SW=mc.smem_words, sets=mc.sets,
                tag_shift=mc.tag_shift, banks=mc.cache_banks,
                miss_latency=mc.miss_latency,
                miss_pipeline=mc.miss_pipeline, max_cycles=mc.max_cycles,
                imem_len=imem.numel(),
                **{n: bufs[n].data_ptr() for n in _PTRS})
    fn = build.function("simt_machine", "simt_run",
                        [ctypes.POINTER(_Params), ctypes.c_void_p])
    with torch.cuda.device(st.pc.device):
        err = fn(ctypes.byref(p), torch.cuda.current_stream().cuda_stream)
    if err == _TOO_BIG:
        need = build.function("simt_machine", "simt_smem_bytes",
                              [ctypes.POINTER(_Params)])
        raise ValueError(f"the SIMT kernel keeps the state in shared memory: "
                         f"{need(ctypes.byref(p))} bytes for {mc} exceed "
                         f"what a block of this card can have")
    build.check(err, "simt_run")
    launches += 1
    out = {n: bufs[n].to(torch.int64) & M32 if n in _U32 else bufs[n]
           for n in State._fields if n not in ("cycle", "stats")}
    c = bufs["counters"]
    return State(**out, cycle=c[len(STAT_KEYS)],
                 stats={k: c[i] for i, k in enumerate(STAT_KEYS)})
