"""Plain PyTorch SSD intra-chunk block: the twin of
``repro.kernels.ssm_scan.ref.ssd_intra_ref`` (direct math, the whole
[B,nc,Q,Q,H] decay tensor at once)."""
from __future__ import annotations

from typing import Tuple

import torch


def ssd_intra_ref(cum: torch.Tensor, xdt: torch.Tensor, Bc: torch.Tensor,
                  Cc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cum: [B,nc,Q,H]; xdt: [B,nc,Q,H,P]; Bc/Cc: [B,nc,Q,N] ->
    (y_intra [B,nc,Q,H,P], S_chunk [B,nc,H,N,P]) fp32."""
    Q = cum.shape[2]
    cum = cum.float()
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    CB = torch.einsum("bnqs,bnks->bnqk", Cc.float(), Bc.float())
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=cum.device))
    M = torch.where(tri[None, None, :, :, None], CB[..., None] * decay,
                    torch.zeros((), device=cum.device))
    y = torch.einsum("bnqkh,bnkhp->bnqhp", M, xdt.float())
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)
    S = torch.einsum("bnkh,bnks,bnkhp->bnhsp", dec_end, Bc.float(),
                     xdt.float())
    return y, S
