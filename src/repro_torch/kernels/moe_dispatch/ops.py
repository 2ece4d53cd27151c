"""MoE dispatch wrapper: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

``moe_dispatch(eidx, x, E, C)`` takes the router's top-k experts eidx
[T, k] (int64, as ``torch.topk`` gives them) and the tokens x [T, d] and
returns the capacity buffer [E, C, d], each pair's slot ``dest_tk``
[T*k] int32 (E*C for a dropped pair) and the per-expert ``counts`` [E]
int32, all bit-exact with ``moe_dispatch_ref``: one launch in place of
the eager sort, the inverse map and the gather.  ``launches`` counts
kernel launches only.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_dispatch.ref import moe_dispatch_ref

SOURCE = "src/repro_torch/csrc/moe_dispatch.cu"
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

launches = 0


def moe_dispatch(eidx: torch.Tensor, x: torch.Tensor, E: int, C: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return moe_dispatch_ref(eidx, x, E, C)
    return moe_dispatch_cuda(eidx, x, E, C)


def moe_dispatch_cuda(eidx: torch.Tensor, x: torch.Tensor, E: int, C: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global launches
    if x.device.type != "cuda" or eidx.device != x.device:
        raise ValueError("moe_dispatch kernel needs CUDA tensors on one "
                         f"device, got {x.device} and {eidx.device}")
    if eidx.dtype != torch.int64:
        raise TypeError(f"eidx must be int64 (torch.topk's indices), got "
                        f"{eidx.dtype}")
    if x.dim() != 2 or eidx.dim() != 2 or eidx.shape[0] != x.shape[0] \
            or E < 1 or C < 1:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, eidx "
                         f"{tuple(eidx.shape)} for E={E}, C={C}")
    (T, d), k = x.shape, eidx.shape[1]
    if not (x.is_contiguous() and eidx.is_contiguous()):
        raise ValueError("moe_dispatch kernel needs contiguous x and eidx")
    if (d * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError("moe_dispatch kernel needs 16-byte aligned rows "
                         f"(d={d}, dtype={x.dtype})")
    buf = torch.empty((E, C, d), dtype=x.dtype, device=x.device)
    dest_tk = torch.empty(T * k, dtype=torch.int32, device=x.device)
    counts = torch.empty(E, dtype=torch.int32, device=x.device)
    fn = build.function("moe_dispatch", "moe_dispatch_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(eidx.data_ptr(), x.data_ptr(), buf.data_ptr(),
                 dest_tk.data_ptr(), counts.data_ptr(), T, k, E, C,
                 d * x.element_size() // 16,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "moe_dispatch_fwd")
    launches += 1
    return buf, dest_tk, counts
