"""MoE gather wrapper: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

x [T, d] and slot_token [E*C] int32 (the token each capacity slot
holds; -1, or any value outside [0, T), marks an empty slot) give the
capacity buffer [E, C, d], bit-exact with ``moe_gather_ref``.
``launches`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_dispatch.ref import moe_gather_ref

SOURCE = "src/repro_torch/csrc/moe_dispatch.cu"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

launches = 0


def moe_gather(x: torch.Tensor, slot_token: torch.Tensor, E: int,
               C: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return moe_gather_ref(x, slot_token, E, C)
    return moe_gather_cuda(x, slot_token, E, C)


def moe_gather_cuda(x: torch.Tensor, slot_token: torch.Tensor, E: int,
                    C: int) -> torch.Tensor:
    global launches
    if x.device.type != "cuda" or slot_token.device != x.device:
        raise ValueError("moe_gather kernel needs CUDA tensors on one "
                         f"device, got {x.device} and {slot_token.device}")
    if slot_token.dtype != torch.int32:
        raise TypeError(f"slot_token must be int32, got {slot_token.dtype}")
    if x.dim() != 2 or slot_token.shape != (E * C,):
        raise ValueError(f"bad shapes x {tuple(x.shape)}, slot_token "
                         f"{tuple(slot_token.shape)} for E={E}, C={C}")
    T, d = x.shape
    if not (x.is_contiguous() and slot_token.is_contiguous()):
        raise ValueError("moe_gather kernel needs contiguous x, slot_token")
    if (d * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError("moe_gather kernel needs 16-byte aligned rows "
                         f"(d={d}, dtype={x.dtype})")
    out = torch.empty((E, C, d), dtype=x.dtype, device=x.device)
    fn = build.function("moe_dispatch", "moe_gather_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), slot_token.data_ptr(), out.data_ptr(), T,
                 E * C, d * x.element_size() // 16,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "moe_gather_fwd")
    launches += 1
    return out
