"""Mamba2 (SSD) mixer, chunked state-space-duality form: the twin of
``repro.models.ssm``.

State layout: [B, H, N, P] (heads, ssm state, head dim).

``ssd_chunked`` on CUDA tensors runs the intra-chunk block through the
SSD kernel (``kernels/ssm_scan``: y_intra and the chunk states) and
keeps the short inter-chunk scan and y_inter in torch; under grad the
intra-chunk block's backward is a kernel too (``ssd_intra_bwd``), the
rest plain autograd.  On CPU tensors
it is the plain twin of the JAX function, head groups and all: heads
go in groups so that the [B,nc,Q,Q,Hg] decay tensor stays under
`decay_budget` elements.

``mamba2_forward`` in 'decode' mode writes the SSM and conv states of
the cache IN PLACE for the slot ids in `rows` (all when None); the
other modes return new states, as the JAX function does.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan.ops import ssd_intra
from repro_torch.kernels.ssm_scan.ref import head_group
from repro_torch.models import params as P
from repro_torch.models.common import rmsnorm


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim P, state N)."""
    di = cfg.ssm.expand * cfg.d_model
    Pd = cfg.ssm.head_dim
    return di, di // Pd, Pd, cfg.ssm.d_state


def mamba2_spec(cfg: ModelConfig) -> Dict[str, P.Leaf]:
    """``init_mamba2``: the depthwise conv weights have fan-in W; A_log,
    D and dt_bias stay fp32."""
    d = cfg.d_model
    di, H, _, N = ssm_dims(cfg)
    w = cfg.ssm.d_conv
    return {
        "w_z": P.dense(d, di, fan_in=d), "w_x": P.dense(d, di, fan_in=d),
        "w_B": P.dense(d, N, fan_in=d), "w_C": P.dense(d, N, fan_in=d),
        "w_dt": P.dense(d, H, fan_in=d),
        "conv_x": P.dense(di, w, fan_in=w),
        "conv_B": P.dense(N, w, fan_in=w),
        "conv_C": P.dense(N, w, fan_in=w),
        "A_log": P.zeros(H, fp32=True),
        "D": P.ones(H, fp32=True),
        "dt_bias": P.zeros(H, fp32=True),
        "norm": P.ones(di),
        "w_out": P.dense(di, d, fan_in=di),
    }


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """x: [B, L, C]; w: [C, W] depthwise.  Returns (y, new_state).

    state: [B, W-1, C] trailing context for decode continuation."""
    B, L, C = x.shape
    W = w.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = torch.zeros((B, L, C), dtype=torch.float32, device=x.device)
    for i in range(W):
        y = y + xp[:, i:i + L, :].float() * w[:, i].float()
    new_state = xp[:, xp.shape[1] - (W - 1):, :]
    return F.silu(y).to(x.dtype), new_state


# ---------------------------------------------------------------------------
# chunked SSD
# ---------------------------------------------------------------------------

def _inter_chunk(y_intra, S, cum, Cc, s0):
    """The inter-chunk recurrence over chunk states S [B,nc,H,N,P] and
    y_inter; returns (y [B,nc,Q,H,P], final_state [B,H,N,P])."""
    chunk_decay = torch.exp(cum[:, :, -1, :])                # [B,nc,H]
    state = s0
    prev = []
    for n in range(S.shape[1]):
        prev.append(state)                          # state entering chunk n
        state = state * chunk_decay[:, n, :, None, None] + S[:, n]
    prev_states = torch.stack(prev, dim=1)                  # [B,nc,H,N,P]
    y_inter = torch.einsum("bnqs,bnhsp,bnqh->bnqhp", Cc, prev_states,
                           torch.exp(cum))
    return y_intra + y_inter, state


def _ssd_head_group(cum, xdt, Bc, Cc, CB, tri, s0):
    """The plain SSD of one head group: cum [B,nc,Q,Hg]; xdt
    [B,nc,Q,Hg,P]; Bc/Cc [B,nc,Q,N]; CB [B,nc,Q,Q]; s0 [B,Hg,N,P]."""
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    M = torch.where(tri[None, None, :, :, None], CB[..., None] * decay,
                    torch.zeros((), device=cum.device))
    y_intra = torch.einsum("bnqkh,bnkhp->bnqhp", M, xdt)
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)
    S = torch.einsum("bnkh,bnks,bnkhp->bnhsp", dec_end, Bc, xdt)
    return _inter_chunk(y_intra, S, cum, Cc, s0)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                decay_budget: int = 32 * 1024 * 1024):
    """Chunked state-space-duality scan.

    x:  [B, L, H, P]   (conv'd, activated inputs)
    dt: [B, L, H]      (softplus'd step sizes, fp32)
    A:  [H]            (negative, fp32)
    Bm,Cm: [B, L, N]   (single group, broadcast over heads)
    Returns (y [B, L, H, P] fp32, final_state [B, H, N, P] fp32).
    The chunk length Q is the largest divisor of L up to `chunk`.
    """
    Bsz, L, H, Pd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    while L % Q:
        Q -= 1
    nc = L // Q

    a = (dt * A[None, None, :]).reshape(Bsz, nc, Q, H)           # log decay
    cum = torch.cumsum(a, dim=2)                                 # [B,nc,Q,H]
    xdt = (x.float() * dt[..., None]).reshape(Bsz, nc, Q, H, Pd)
    Bc = Bm.float().reshape(Bsz, nc, Q, N)
    Cc = Cm.float().reshape(Bsz, nc, Q, N)
    s0 = (torch.zeros((Bsz, H, N, Pd), dtype=torch.float32,
                      device=x.device) if init_state is None
          else init_state.float())

    if x.device.type == "cuda":
        y_intra, S = ssd_intra(cum.contiguous(), xdt.contiguous(),
                               Bc.contiguous(), Cc.contiguous())
        y, final_state = _inter_chunk(y_intra, S, cum, Cc, s0)
        return y.reshape(Bsz, L, H, Pd), final_state

    # plain path: heads in groups so the decay tensor stays in budget
    hg = head_group(Bsz, nc, Q, H, decay_budget)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    CB = torch.einsum("bnqs,bnks->bnqk", Cc, Bc)                 # shared
    ys, finals = [], []
    for g0 in range(0, H, hg):
        hs = slice(g0, g0 + hg)
        y_g, fin_g = _ssd_head_group(cum[..., hs], xdt[:, :, :, hs], Bc, Cc,
                                     CB, tri, s0[:, hs])
        ys.append(y_g)
        finals.append(fin_g)
    y = torch.cat(ys, dim=3)
    return y.reshape(Bsz, L, H, Pd), torch.cat(finals, dim=1)


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """One-token SSD update.  x: [B,1,H,P]; dt: [B,1,H]; Bm/Cm: [B,1,N].
    state: [B,H,N,P] -> (y [B,1,H,P], new_state) in fp32."""
    dtf = dt[:, 0].float()                                       # [B,H]
    dec = torch.exp(dtf * A[None, :])                            # [B,H]
    xdt = x[:, 0].float() * dtf[..., None]                       # [B,H,P]
    Bv = Bm[:, 0].float()                                        # [B,N]
    Cv = Cm[:, 0].float()
    new_state = (state.float() * dec[:, :, None, None]
                 + torch.einsum("bs,bhp->bhsp", Bv, xdt))
    y = torch.einsum("bs,bhsp->bhp", Cv, new_state)
    return y[:, None], new_state


# ---------------------------------------------------------------------------
# full mixer forward
# ---------------------------------------------------------------------------

def mamba2_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                   cfg: ModelConfig, *, mode: str,
                   cache: Optional[Dict[str, Any]] = None,
                   rows: Optional[torch.Tensor] = None):
    """x: [B, S, d] -> (y [B, S, d], new_cache).

    cache: {"ssm": [B,H,N,P] fp32, "conv_x": [B,W-1,di],
            "conv_B": [B,W-1,N], "conv_C": [B,W-1,N]}.  'decode' reads
    it and writes the new states into it in place, for the slot ids in
    `rows` (all when None); 'prefill' and 'train' start from it when
    given and return new states.
    """
    B, S, d = x.shape
    di, H, Pd, N = ssm_dims(cfg)

    z = x @ p["w_z"]                                             # [B,S,di]
    xi = x @ p["w_x"]
    Bm = x @ p["w_B"]
    Cm = x @ p["w_C"]
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])      # [B,S,H]
    A = -torch.exp(p["A_log"])                                   # [H]

    cs = cache or {}
    xi, cx = causal_conv(xi, p["conv_x"], cs.get("conv_x"))
    Bm, cB = causal_conv(Bm, p["conv_B"], cs.get("conv_B"))
    Cm, cC = causal_conv(Cm, p["conv_C"], cs.get("conv_C"))

    xh = xi.reshape(B, S, H, Pd)
    if mode == "decode":
        y, ssm_state = ssd_decode_step(cs["ssm"], xh, dt, A, Bm, Cm)
    else:
        y, ssm_state = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm.chunk,
                                   init_state=cs.get("ssm"))

    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, di).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    out = y @ p["w_out"]

    new_cache = None
    if mode == "decode":
        for name, new in (("ssm", ssm_state), ("conv_x", cx),
                          ("conv_B", cB), ("conv_C", cC)):
            if rows is None:
                cs[name].copy_(new)
            else:
                b = rows.to(device=x.device, dtype=torch.long)
                cs[name][b] = new[b].to(cs[name].dtype)
        new_cache = cs
    elif mode == "prefill":
        new_cache = {"ssm": ssm_state, "conv_x": cx, "conv_B": cB,
                     "conv_C": cC}
    return out, new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    di, H, Pd, N = ssm_dims(cfg)
    W = cfg.ssm.d_conv
    return {
        "ssm": torch.zeros((batch, H, N, Pd), dtype=torch.float32,
                           device=device),
        "conv_x": torch.zeros((batch, W - 1, di), dtype=dtype,
                              device=device),
        "conv_B": torch.zeros((batch, W - 1, N), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, W - 1, N), dtype=dtype, device=device),
    }
