"""Plain PyTorch attention: the twin of
``repro.kernels.flash_attention.ref.attention_ref`` (naive full matrix,
fp32 softmax), in the model's [B, S, H, D] layout; and the plain
versions of the training kernels: ``flash_fwd_ref`` (the forward with
its fp32 row log-sum-exp) and ``flash_bwd_ref`` (the FA-2 recompute
backward of ``repro.models.attention._flash_bwd``), both chunked so that
their memory stays bounded at long sequences."""
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


def _mask(i0: int, i1: int, j0: int, j1: int, causal: bool,
          window: Optional[int], device) -> Optional[torch.Tensor]:
    """[i1 - i0, j1 - j0] bool: query i may read key j (None: all)."""
    if not causal and window is None:
        return None
    d = (torch.arange(i0, i1, device=device)[:, None]
         - torch.arange(j0, j1, device=device)[None, :])
    ok = torch.ones_like(d, dtype=torch.bool)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return ok


def _skip(i0: int, i1: int, j0: int, j1: int, causal: bool,
          window: Optional[int]) -> bool:
    """True when no (i, j) of the chunk pair is on the mask."""
    return (causal and j0 > i1 - 1) or (window is not None
                                        and i0 - (j1 - 1) >= window)


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  chunk: int = 512):
    """The forward with its row LSE: (out [B,S,H,D] in q's dtype, lse
    fp32 [B,H,S] of the scaled scores), by the online softmax over key
    chunks (the forward of ``flash_attention_jnp``).  Peak extra memory
    is a few fp32 [B, H, chunk, chunk] blocks."""
    B, S, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, S, KV, G, D)
    outs, lses = [], []
    for i0 in range(0, S, chunk):
        i1 = min(S, i0 + chunk)
        qi = qg[:, i0:i1].float()
        m = torch.full((B, KV, G, i1 - i0), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, i1 - i0), device=q.device)
        acc = torch.zeros((B, KV, G, i1 - i0, D), device=q.device)
        for j0 in range(0, Sk, chunk):
            j1 = min(Sk, j0 + chunk)
            if _skip(i0, i1, j0, j1, causal, window):
                continue
            s = torch.einsum("bqkgd,bckd->bkgqc", qi,
                             k[:, j0:j1].float()) * scale
            ok = _mask(i0, i1, j0, j1, causal, window, q.device)
            if ok is not None:
                s = torch.where(ok, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p, v[:, j0:j1].float())
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).permute(0, 3, 1, 2, 4)
                    .reshape(B, i1 - i0, H, D))
        lses.append((m + torch.log(l)).reshape(B, H, i1 - i0))
    return torch.cat(outs, dim=1).to(q.dtype), torch.cat(lses, dim=2)


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  *, causal: bool = True, window: Optional[int] = None,
                  chunk: int = 512):
    """FA-2 recompute backward, as ``repro.models.attention._flash_bwd``:
    delta = rowsum(dO * O); per (query chunk, key chunk) on the mask,
    P = exp(S - lse), dV += P^T dO, dS = P (dO V^T - delta) scale,
    dQ += dS K, dK += dS^T Q; fp32 throughout, (dq, dk, dv) in the
    inputs' dtypes.  lse: fp32 [B,H,S].  Peak extra memory is a few fp32
    [B, H, chunk, chunk] blocks plus fp32 dq, dk, dv."""
    B, S, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, S, KV, G, D)
    dog = do.reshape(B, S, KV, G, D)
    delta = (dog.float() * out.reshape(B, S, KV, G, D).float()).sum(-1)
    delta = delta.permute(0, 2, 3, 1)                     # [B,KV,G,S]
    lse_g = lse.reshape(B, KV, G, S)
    dq = torch.zeros((B, S, KV, G, D), device=q.device)
    dk = torch.zeros((B, Sk, KV, D), device=q.device)
    dv = torch.zeros((B, Sk, KV, D), device=q.device)
    for i0 in range(0, S, chunk):
        i1 = min(S, i0 + chunk)
        qi, doi = qg[:, i0:i1].float(), dog[:, i0:i1].float()
        lse_i = lse_g[..., i0:i1, None]
        del_i = delta[..., i0:i1, None]
        for j0 in range(0, Sk, chunk):
            j1 = min(Sk, j0 + chunk)
            if _skip(i0, i1, j0, j1, causal, window):
                continue
            kc, vc = k[:, j0:j1].float(), v[:, j0:j1].float()
            s = torch.einsum("bqkgd,bckd->bkgqc", qi, kc) * scale
            p = torch.exp(s - lse_i)
            ok = _mask(i0, i1, j0, j1, causal, window, q.device)
            if ok is not None:
                p = torch.where(ok, p, torch.zeros_like(p))
            dv[:, j0:j1] += torch.einsum("bkgqc,bqkgd->bckd", p, doi)
            dp = torch.einsum("bqkgd,bckd->bkgqc", doi, vc)
            ds = p * (dp - del_i) * scale
            dq[:, i0:i1] += torch.einsum("bkgqc,bckd->bqkgd", ds, kc)
            dk[:, j0:j1] += torch.einsum("bkgqc,bqkgd->bckd", ds, qi)
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
