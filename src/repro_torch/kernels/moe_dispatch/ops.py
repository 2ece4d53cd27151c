"""MoE dispatch wrapper: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

``moe_dispatch(eidx, x, E, C)`` takes the router's top-k experts eidx
[T, k] (int64, as ``torch.topk`` gives them) and the tokens x [T, d] and
returns the capacity buffer [E, C, d], each pair's slot ``dest_tk``
[T*k] int32 (E*C for a dropped pair) and the per-expert ``counts`` [E]
int32, all bit-exact with ``moe_dispatch_ref``: one launch in place of
the eager sort, the inverse map and the gather.  ``launches`` counts
kernel launches only.

Gradients: on CUDA, when grad mode is on and x requires grad, the call
runs as a ``torch.autograd.Function``: dest_tk and counts are not
differentiable, only dest_tk and T are saved, and the backward is the
kernel ``moe_dispatch_bwd`` (``moe_dispatch_bwd_cuda``, counted in
``bwd_launches``): a gather-sum of each token's buffer rows, bit-exact
with ``moe_dispatch_bwd_ref``.  On the CPU plain autograd runs through
``moe_dispatch_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import build
from repro_torch.kernels.moe_dispatch.ref import moe_dispatch_ref

SOURCE = "src/repro_torch/csrc/moe_dispatch.cu"
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
MAX_TOP_K = 32               # csrc/moe_dispatch.cu kMaxK: a lane per pair

launches = 0
bwd_launches = 0


class _MoeDispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eidx, x, E, C):
        buf, dest_tk, counts = moe_dispatch_cuda(eidx, x, E, C)
        ctx.mark_non_differentiable(dest_tk, counts)
        ctx.save_for_backward(dest_tk)
        ctx.T, ctx.k = x.shape[0], eidx.shape[1]
        return buf, dest_tk, counts

    @staticmethod
    def backward(ctx, dbuf, _ddest, _dcounts):
        dest_tk, = ctx.saved_tensors
        return None, moe_dispatch_bwd_cuda(dbuf, dest_tk, ctx.T, ctx.k), \
            None, None


def _moe_dispatch(eidx: torch.Tensor, x: torch.Tensor, E: int, C: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return moe_dispatch_ref(eidx, x, E, C)
    if torch.is_grad_enabled() and x.requires_grad:
        return _MoeDispatch.apply(eidx, x, E, C)
    return moe_dispatch_cuda(eidx, x, E, C)


moe_dispatch = obs.instrument_kernel("moe_dispatch", _moe_dispatch)


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


def moe_dispatch_bwd_cuda(dbuf: torch.Tensor, dest_tk: torch.Tensor, T: int,
                          k: int) -> torch.Tensor:
    """The backward kernel: dx [T, d] in dbuf's dtype from the buffer's
    gradient dbuf [E, C, d] (made contiguous) and the forward's dest_tk
    [T*k] int32."""
    global bwd_launches
    if dbuf.device.type != "cuda" or dest_tk.device != dbuf.device:
        raise ValueError("moe_dispatch_bwd kernel needs CUDA tensors on one "
                         f"device, got {dbuf.device} and {dest_tk.device}")
    if dbuf.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"moe_dispatch_bwd takes bf16 or fp32, got "
                        f"{dbuf.dtype}")
    if dbuf.dim() != 3 or dest_tk.dtype != torch.int32 \
            or dest_tk.shape != (T * k,) or not 0 < k <= MAX_TOP_K:
        raise ValueError(f"bad shapes dbuf {tuple(dbuf.shape)}, dest_tk "
                         f"{tuple(dest_tk.shape)} {dest_tk.dtype} for T={T}, "
                         f"k={k}")
    dbuf, dest_tk = dbuf.contiguous(), dest_tk.contiguous()
    E, C, d = dbuf.shape
    if (d * dbuf.element_size()) % 16 or dbuf.data_ptr() % 16:
        raise ValueError("moe_dispatch_bwd kernel needs 16-byte aligned rows "
                         f"(d={d}, dtype={dbuf.dtype})")
    dx = torch.empty((T, d), dtype=dbuf.dtype, device=dbuf.device)
    fn = build.function("moe_dispatch", "moe_dispatch_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(dbuf.device):
        err = fn(dbuf.data_ptr(), dest_tk.data_ptr(), dx.data_ptr(), T, k,
                 E * C, d * dbuf.element_size() // 16,
                 int(dbuf.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "moe_dispatch_bwd")
    bwd_launches += 1
    return dx
