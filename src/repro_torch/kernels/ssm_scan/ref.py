"""Plain PyTorch SSD intra-chunk block: the twin of
``repro.kernels.ssm_scan.ref.ssd_intra_ref`` (direct math, the whole
[B,nc,Q,Q,H] decay tensor at once), and its gradient written out
(``ssd_intra_bwd_ref``), the plain version of the backward kernel."""
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


def head_group(Bsz: int, nc: int, Q: int, H: int,
               decay_budget: int = 32 * 1024 * 1024) -> int:
    """Heads a group of the plain SSD (``models.ssm.ssd_chunked`` and
    ``ssd_intra_bwd_ref``): the [B,nc,Q,Q,Hg] decay tensor stays under
    `decay_budget` elements, and Hg divides H."""
    hg = min(H, max(1, int(decay_budget // max(1, Bsz * nc * Q * Q))))
    while H % hg:
        hg -= 1
    return hg


def ssd_intra_bwd_ref(cum: torch.Tensor, xdt: torch.Tensor,
                      Bc: torch.Tensor, Cc: torch.Tensor, dy: torch.Tensor,
                      dS: torch.Tensor,
                      decay_budget: int = 32 * 1024 * 1024
                      ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``ssd_intra_ref`` for the output gradients dy
    [B,nc,Q,H,P] and dS [B,nc,H,N,P]: (dcum, dxdt, dB, dC), in fp32 (in
    fp64 for fp64 inputs).

    Per head, with L = tril(exp(cum_q - cum_k)) (masked before exp, so
    steep decay gives no inf), M = (C Bᵀ) ∘ L and dec_end_k =
    exp(cum_{Q-1} - cum_k):

    - dM = dy xdtᵀ (only its entries on the mask matter);
    - dxdt = Mᵀ dy + dec_end ∘ (B dS);
    - dCB = Σ_h dM ∘ L, then dC = dCB B and dB = dCBᵀ C
      + Σ_h dec_end ∘ (xdt dSᵀ);
    - dcum = rowsum(dM ∘ M) - colsum(dM ∘ M) - w, with w_k = dec_end_k
      Σ_p xdt_kp (B dS)_kp, and Σ_k w_k added at Q-1.

    Heads go in the groups of ``head_group``."""
    Bsz, nc, Q, H = cum.shape
    dt = torch.promote_types(cum.dtype, torch.float32)
    cum, xdt, Bc, Cc, dy, dS = (t.to(dt) for t in
                                (cum, xdt, Bc, Cc, dy, dS))
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=cum.device))[None, None, :, :, None]
    CB = torch.einsum("bnqs,bnks->bnqk", Cc, Bc)
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)                # [B,nc,Q,H]
    dCB = torch.zeros_like(CB)
    dB = torch.zeros_like(Bc)
    dcum, dxdt = torch.empty_like(cum), torch.empty_like(xdt)
    hg = head_group(Bsz, nc, Q, H, decay_budget)
    for g0 in range(0, H, hg):
        hs = slice(g0, g0 + hg)
        c, x, g, s, e = (cum[..., hs], xdt[:, :, :, hs], dy[:, :, :, hs],
                         dS[:, :, hs], dec_end[..., hs])
        diff = c[:, :, :, None, :] - c[:, :, None, :, :]        # [..q,k,h]
        L = torch.exp(torch.where(tri, diff, torch.full_like(diff,
                                                             -torch.inf)))
        M = CB[..., None] * L
        dM = torch.einsum("bnqhp,bnkhp->bnqkh", g, x)
        dCB += (dM * L).sum(-1)
        BdS = torch.einsum("bnks,bnhsp->bnkhp", Bc, s)
        dxdt[:, :, :, hs] = (torch.einsum("bnqkh,bnqhp->bnkhp", M, g)
                             + e[..., None] * BdS)
        dB += torch.einsum("bnkh,bnkhp,bnhsp->bnks", e, x, s)
        W = dM * M
        w = e * (x * BdS).sum(-1)                               # [B,nc,Q,hg]
        dc = W.sum(3) - W.sum(2) - w
        dc[:, :, -1] += w.sum(2)
        dcum[..., hs] = dc
    dC = torch.einsum("bnqk,bnks->bnqs", dCB, Bc)
    dB += torch.einsum("bnqk,bnqs->bnks", dCB, Cc)
    return dcum, dxdt, dB, dC
