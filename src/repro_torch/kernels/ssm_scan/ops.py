"""SSD intra-chunk wrapper: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

cum [B,nc,Q,H], xdt [B,nc,Q,H,P] and Bc/Cc [B,nc,Q,N], all fp32, give
y_intra [B,nc,Q,H,P] and S_chunk [B,nc,H,N,P] in fp32, as
``ssd_intra_ref``.  The kernel takes any Q from 1 to 256 (the model's
chunk is any divisor of the sequence length up to 256), P and N
multiples of 4 up to 128.  One launch writes both outputs, a block per
(chunk, head), with the products on the tensor cores in 3xTF32 (about
fp32 accuracy).  ``launches`` counts wrapper calls that launched the
kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels.ssm_scan.ref import ssd_intra_ref

SOURCE = "src/repro_torch/csrc/ssm_scan.cu"
MAX_DIM = 128
MAX_Q = 256
_I, _P = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_P] * 6 + [_I] * 5 + [_P]

launches = 0


def _ssd_intra(cum: torch.Tensor, xdt: torch.Tensor, Bc: torch.Tensor,
               Cc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if cum.device.type == "cpu":
        return ssd_intra_ref(cum, xdt, Bc, Cc)
    return ssd_intra_cuda(cum, xdt, Bc, Cc)


ssd_intra = obs.instrument_kernel("ssd_intra", _ssd_intra)


def ssd_intra_cuda(cum: torch.Tensor, xdt: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    refuse_grad("ssd_intra", cum, xdt, Bc, Cc)
    ts = (cum, xdt, Bc, Cc)
    if cum.device.type != "cuda" or any(t.device != cum.device for t in ts):
        raise ValueError("ssd_intra kernel needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("ssd_intra kernel takes fp32 inputs, got "
                        f"{[t.dtype for t in ts]}")
    if cum.dim() != 4 or xdt.dim() != 5 or Bc.dim() != 4 \
            or Cc.shape != Bc.shape:
        raise ValueError(f"bad ranks: cum {tuple(cum.shape)}, xdt "
                         f"{tuple(xdt.shape)}, B {tuple(Bc.shape)}, "
                         f"C {tuple(Cc.shape)}")
    B, nc, Q, H = cum.shape
    P, N = xdt.shape[-1], Bc.shape[-1]
    if tuple(xdt.shape[:4]) != (B, nc, Q, H) \
            or tuple(Bc.shape[:3]) != (B, nc, Q):
        raise ValueError(f"shapes do not match: cum {tuple(cum.shape)}, "
                         f"xdt {tuple(xdt.shape)}, B {tuple(Bc.shape)}")
    if not 0 < Q <= MAX_Q:
        raise ValueError(f"chunk length Q={Q} must be in [1, {MAX_Q}]")
    if P % 4 or N % 4 or not 0 < P <= MAX_DIM or not 0 < N <= MAX_DIM:
        raise ValueError(f"P={P} and N={N} must be multiples of 4 in "
                         f"[4, {MAX_DIM}]")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError("ssd_intra kernel needs contiguous, 16-byte "
                         "aligned inputs")
    y = torch.empty((B, nc, Q, H, P), dtype=torch.float32,
                    device=cum.device)
    S = torch.empty((B, nc, H, N, P), dtype=torch.float32,
                    device=cum.device)
    fn = build.function("ssm_scan", "ssd_intra_fwd", _ARGTYPES)
    with torch.cuda.device(cum.device):
        err = fn(cum.data_ptr(), xdt.data_ptr(), Bc.data_ptr(),
                 Cc.data_ptr(), y.data_ptr(), S.data_ptr(), B * nc, Q, H,
                 N, P, torch.cuda.current_stream().cuda_stream)
    build.check(err, "ssd_intra_fwd")
    launches += 1
    return y, S
