"""RMSNorm wrappers: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors.  Rank-polymorphic over leading dims, like the JAX
``repro.kernels.rmsnorm.ops.rmsnorm``.

Two forms of one kernel: ``rmsnorm(x, scale)`` and the fused
``add_rmsnorm(x, h, scale) -> (s, y)`` with ``s = x + h`` (bit-exact
with torch's add) and ``y = rmsnorm(s)``.  ``launches`` counts kernel
launches of both forms, ``launches_by_form`` each form's (the CPU path
never bumps either).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import add_rmsnorm_ref, rmsnorm_ref

SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
MAX_ROW_BYTES = 512 * 8 * 16   # csrc/rmsnorm.cu: kMaxThreads x kMaxVec words

launches = 0
launches_by_form = {"rmsnorm": 0, "add_rmsnorm": 0}


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x: [..., d]; scale: [d] -> [..., d] in x's dtype."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    return rmsnorm_cuda(x, scale, eps)


rmsnorm = obs.instrument_kernel("rmsnorm", _rmsnorm)


def _add_rmsnorm(x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, h: [..., d]; scale: [d] -> (x + h, rmsnorm(x + h))."""
    if x.device.type == "cpu":
        return add_rmsnorm_ref(x, h, scale, eps)
    return add_rmsnorm_cuda(x, h, scale, eps)


add_rmsnorm = obs.instrument_kernel("add_rmsnorm", _add_rmsnorm)


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    return _launch(x, None, scale, eps)[1]


def add_rmsnorm_cuda(x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch(x, h, scale, eps)


def _launch(x: torch.Tensor, h: Optional[torch.Tensor], scale: torch.Tensor,
            eps: float) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    global launches
    form = "rmsnorm" if h is None else "add_rmsnorm"
    ins = [x, scale] + ([] if h is None else [h])
    if x.device.type != "cuda" or any(t.device != x.device for t in ins):
        raise ValueError(f"{form} kernel needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in ins]}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ins):
        raise TypeError(f"{form} kernel takes fp32 or bf16 tensors of one "
                        f"dtype, got {[t.dtype for t in ins]}")
    d = x.shape[-1]
    if scale.shape != (d,) or (h is not None and h.shape != x.shape):
        raise ValueError(f"{form}: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}"
                         + ("" if h is None else f", h {tuple(h.shape)}"))
    if not all(t.is_contiguous() for t in ins):
        raise ValueError(f"{form} kernel needs contiguous inputs")
    row = d * x.element_size()
    if row % 16 or any(t.data_ptr() % 16 for t in ins):
        raise ValueError(f"{form} kernel needs 16-byte aligned rows "
                         f"(d={d}, dtype={x.dtype})")
    if row > MAX_ROW_BYTES:
        raise ValueError(f"{form} kernel holds rows of at most "
                         f"{MAX_ROW_BYTES} bytes in registers, got d={d} "
                         f"in {x.dtype}")
    y = torch.empty_like(x)
    s = None if h is None else torch.empty_like(x)
    fn = build.function("rmsnorm", "rmsnorm_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), None if h is None else h.data_ptr(),
                 scale.data_ptr(), None if s is None else s.data_ptr(),
                 y.data_ptr(), x.numel() // d, d, float(eps),
                 _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
    build.check(err, f"rmsnorm_fwd ({form})")
    launches += 1
    launches_by_form[form] += 1
    return s, y
