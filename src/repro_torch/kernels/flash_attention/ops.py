"""Flash-attention forward wrapper: the CUDA kernel for CUDA tensors,
the plain version for CPU tensors.

Layout contract: [B,S,H,D] queries and [B,Sk,KV,D] keys/values, read by
the kernel through their strides (no transposes, unlike the JAX
``repro.kernels.flash_attention.ops``); the output is a new contiguous
[B,S,H,D] tensor.  ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = "src/repro_torch/csrc/flash_attention.cu"
HEAD_DIMS = tuple(range(16, 129, 16))    # bf16 rows of 16-byte words
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_ARGTYPES = ([_P] * 4 + [_I] * 6 + [_L] * 9
             + [_I, _I, ctypes.c_float, _I, _P])

launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B,S,H,D]; k,v: [B,Sk,KV,D] -> [B,S,H,D]."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    global launches
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention kernel needs CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes fp32 or bf16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         "not match (GQA needs H % KV == 0)")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    for t in (q, k, v):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                st * t.element_size() % 16 for st in t.stride()[:3]):
            raise ValueError("flash_attention kernel needs unit stride on D "
                             "and 16-byte aligned pointers and strides")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    fn = build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, Sk, H, KV, D,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 int(causal), int(window or 0), 1.0 / (D ** 0.5),
                 _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention_fwd")
    launches += 1
    return out
