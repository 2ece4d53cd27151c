"""Shared building blocks: the twin of ``repro.models.common``.

``rmsnorm`` and ``add_rmsnorm`` dispatch to the kernel wrappers, which
launch the CUDA kernel for CUDA tensors and run the plain version for
CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ops import add_rmsnorm as _add_rmsnorm_op
from repro_torch.kernels.rmsnorm.ops import rmsnorm as _rmsnorm_op

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 statistics, output in x's dtype."""
    return _rmsnorm_op(x, scale, eps)


def add_rmsnorm(x: torch.Tensor, h: Optional[torch.Tensor],
                scale: torch.Tensor, eps: float = 1e-5
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the pre-norm after it, in one kernel:
    (s = x + h, rmsnorm(s)).  h None (no branch pending, the first
    norm of a stack): (x, rmsnorm(x))."""
    if h is None:
        return x, _rmsnorm_op(x, scale, eps)
    return _add_rmsnorm_op(x, h, scale, eps)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S].  Split
    halves, angles in fp32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                # [D/2]
    angles = positions[..., :, None].float() * freqs      # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                 # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu in fp32, cast back to gate's dtype, times up."""
    return F.silu(gate.float()).to(gate.dtype) * up


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def padded_vocab(vocab: int, multiple: int = 128) -> int:
    return pad_to_multiple(vocab, multiple)
