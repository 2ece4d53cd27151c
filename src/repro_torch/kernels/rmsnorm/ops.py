"""RMSNorm wrapper: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors.  Rank-polymorphic over leading dims, like the JAX
``repro.kernels.rmsnorm.ops.rmsnorm``.

``launches`` counts kernel launches only (the CPU path never bumps it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
             ctypes.c_void_p]

launches = 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: [..., d]; scale: [d] -> [..., d] in x's dtype."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    return rmsnorm_cuda(x, scale, eps)


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    global launches
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm kernel needs CUDA tensors on one "
                         f"device, got {x.device} and {scale.device}")
    if x.dtype not in _DTYPES or scale.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes fp32 or bf16 x with scale "
                        f"of the same dtype, got {x.dtype}, {scale.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale must be [{d}], got {tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and scale")
    if (d * x.element_size()) % 16 or x.data_ptr() % 16 \
            or scale.data_ptr() % 16:
        raise ValueError("rmsnorm kernel needs 16-byte aligned rows "
                         f"(d={d}, dtype={x.dtype})")
    out = torch.empty_like(x)
    rows = x.numel() // d
    fn = build.function("rmsnorm", "rmsnorm_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
                 float(eps), _DTYPES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "rmsnorm_fwd")
    launches += 1
    return out
