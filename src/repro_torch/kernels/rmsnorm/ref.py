"""Plain PyTorch RMSNorm: the twin of ``repro.models.common.rmsnorm``
(fp32 statistics, output in x's dtype)."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def add_rmsnorm_ref(x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-5):
    """The residual add and the norm after it: (s = x + h, rmsnorm(s))."""
    s = x + h
    return s, rmsnorm_ref(s, scale, eps)
