"""Plain PyTorch attention: the twin of
``repro.kernels.flash_attention.ref.attention_ref`` (naive full matrix,
fp32 softmax), in the model's [B, S, H, D] layout."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: [B,S,H,D]; k,v: [B,Sk,KV,D] -> [B,S,H,D].  Query position i
    and key position j share one origin: causal keeps j <= i, a window
    keeps i - j < window."""
    B, S, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / (D ** 0.5)
    pos_q = torch.arange(S, device=q.device)[:, None]
    pos_k = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(S, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos_q >= pos_k
    if window is not None:
        mask &= (pos_q - pos_k) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)
