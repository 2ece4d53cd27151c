"""Plain PyTorch RMSNorm: the twin of ``repro.models.common.rmsnorm``
(fp32 statistics, output in x's dtype), and the plain versions of the
kernels of its rows split over ranks (``row_*_ref``: each rank's
statistic, reduced by the caller, then its columns normalised)."""
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


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5):
    """The backward of ``rmsnorm_ref``: (dx in x's dtype, dscale in
    scale's dtype), with r = rsqrt(mean(x^2) + eps) recomputed from x and
    dscale = sum over rows of dy * x * r in fp32."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    dyf = dy.float()
    dscale = (dyf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    dxhat = dyf * scale.float()
    dx = r * (dxhat - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dscale.to(scale.dtype)


def add_rmsnorm_bwd_ref(s: torch.Tensor, ds, dy, scale: torch.Tensor,
                        eps: float = 1e-5):
    """The backward of ``add_rmsnorm_ref`` from its saved sum s: (dh,
    dscale), where dh (= dx) is ds plus the norm's gradient, that one
    rounded to s's dtype first as autograd of the plain version rounds
    it.  Either of ds, dy may be None (that output took no gradient);
    dscale is None when dy is."""
    if dy is None:
        return ds, None
    dn, dscale = rmsnorm_bwd_ref(s, scale, dy, eps)
    return (dn if ds is None else ds + dn), dscale


def row_stat_ref(x: torch.Tensor, dy=None, scale=None) -> torch.Tensor:
    """The per-row fp32 statistic of the norm of rows split over ranks,
    over this rank's columns: sum(x^2), or sum(dy * scale * x) when `dy`
    is given (the backward's)."""
    xf = x.float()
    if dy is None:
        return xf.square().sum(dim=-1)
    return (dy.float() * scale.float() * xf).sum(dim=-1)


def row_fwd_ref(x: torch.Tensor, ss: torch.Tensor, scale: torch.Tensor,
                d_total: int, eps: float = 1e-5) -> torch.Tensor:
    """``rmsnorm_ref`` of this rank's columns of rows d_total wide, from
    `ss`, the rows' sums of squares over every rank's columns."""
    r = torch.rsqrt(ss[..., None] / d_total + eps)
    return (x.float() * r * scale.float()).to(x.dtype)


def row_bwd_ref(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                ss: torch.Tensor, dot: torch.Tensor, d_total: int,
                eps: float = 1e-5):
    """``rmsnorm_bwd_ref`` on this rank's columns, from the whole rows'
    sums of squares `ss` and of dy * scale * x `dot`: (dx, dscale), the
    dscale of this rank's rows (a partial sum over the ranks that hold
    other rows)."""
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt(ss[..., None] / d_total + eps)
    c = r * r * dot[..., None] / d_total
    dx = r * (dyf * scale.float() - xf * c)
    dscale = (dyf * (xf * r)).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
