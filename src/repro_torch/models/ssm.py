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

Placed x and weights (DTensors, a partitioned step) run the same
mixer body through ``_Placed``'s placement steps: each rank runs the
heads of its ``ssm_inner`` shard, the SSD through the kernel's DTensor
entry, and the gated norm as the norm of rows split over ``model``
(``rmsnorm_split``), as GSPMD partitions the JAX mixer.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.rmsnorm.ops import rmsnorm_split
from repro_torch.kernels.ssm_scan.ops import ssd_intra
from repro_torch.kernels.ssm_scan.ref import head_group
from repro_torch.models import params as P
from repro_torch.models.common import rmsnorm
from repro_torch.roofline import op_cost


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
    inner, rep = ("embed", "ssm_inner"), ("embed", None)  # ``mamba2_specs``
    return {
        "w_z": P.dense(d, di, fan_in=d, axes=inner),
        "w_x": P.dense(d, di, fan_in=d, axes=inner),
        "w_B": P.dense(d, N, fan_in=d, axes=rep),
        "w_C": P.dense(d, N, fan_in=d, axes=rep),
        "w_dt": P.dense(d, H, fan_in=d, axes=rep),
        "conv_x": P.dense(di, w, fan_in=w, axes=("ssm_inner", None)),
        "conv_B": P.dense(N, w, fan_in=w, axes=(None, None)),
        "conv_C": P.dense(N, w, fan_in=w, axes=(None, None)),
        "A_log": P.zeros(H, fp32=True, axes=(None,)),
        "D": P.ones(H, fp32=True, axes=(None,)),
        "dt_bias": P.zeros(H, fp32=True, axes=(None,)),
        "norm": P.norm(di, "ssm_inner"),
        "w_out": P.dense(di, d, fan_in=di, axes=("ssm_inner", "embed")),
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
                decay_budget: int = 32 * 1024 * 1024,
                head_placements=None):
    """Chunked state-space-duality scan.

    x:  [B, L, H, P]   (conv'd, activated inputs)
    dt: [B, L, H]      (softplus'd step sizes, fp32)
    A:  [H]            (negative, fp32)
    Bm,Cm: [B, L, N]   (single group, broadcast over heads)
    Returns (y [B, L, H, P] fp32, final_state [B, H, N, P] fp32).
    The chunk length Q is the largest divisor of L up to `chunk`.

    Placed (a partitioned mixer): x, dt, A and `init_state` are a
    rank's local rows and heads, Bm and Cm DTensors whole over the
    heads' mesh dims, and `head_placements` the placements of a
    [B, nc, Q, H] tensor of the rank's heads.  The intra-chunk block
    runs through the SSD kernel's DTensor entry, the inter-chunk scan
    on the local heads; the results are local.
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
    Bc = Bm.float().reshape(Bm.shape[0], nc, Q, N)
    Cc = Cm.float().reshape(Cm.shape[0], nc, Q, N)
    s0 = (torch.zeros((Bsz, H, N, Pd), dtype=torch.float32,
                      device=x.device) if init_state is None
          else init_state.float())

    if shd.is_placed(Bm):
        cum_d, xdt_d = (shd.from_local(t.contiguous(), Bc, head_placements)
                        for t in (cum, xdt))
        y_intra, S = ssd_intra(cum_d, xdt_d, Bc.contiguous(),
                               Cc.contiguous())
        Cl = Cc.to_local(grad_placements=shd.partial_grads(Cc, xdt_d))
        y, final_state = _inter_chunk(y_intra.to_local(), S.to_local(),
                                      cum, Cl, s0)
        return y.reshape(Bsz, L, H, Pd), final_state

    if x.device.type != "cpu" or op_cost.plain_route():
        # the kernel's route: CUDA, meta (the dry run), and the CPU during
        # an op-cost walk, so that every device counts alike
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
    given and return new states.  Placed x runs the same body on each
    rank's heads (``_Placed``); whole x takes ``_Whole``'s identities.
    """
    pl = _Placed(rows) if shd.is_placed(x) else _Whole(rows)
    _, _, Pd, _ = ssm_dims(cfg)
    z, xi, Bm, Cm, dtr = (pl.mm(x, p[n]) for n in
                          ("w_z", "w_x", "w_B", "w_C", "w_dt"))
    heads = pl.head_cut(xi, Pd)

    def on_heads(w):       # a leaf used on the rank's heads
        return heads(pl.used(w, xi))

    cs = cache or {}
    xl, cx = causal_conv(pl.local(xi), pl.used(p["conv_x"], xi),
                         pl.state(cs, "conv_x"))
    bc, new_bc = [], []
    for t, name in ((Bm, "conv_B"), (Cm, "conv_C")):
        y, st = causal_conv(pl.local(t), pl.used(p[name], t),
                            pl.state(cs, name))
        bc.append(pl.back(y, t))
        new_bc.append(st)
    Bm, Cm = bc
    dt = F.softplus(on_heads(dtr).float() + on_heads(p["dt_bias"]))
    A = -torch.exp(on_heads(p["A_log"]))                         # [H]

    xh = xl.reshape(*xl.shape[:2], -1, Pd)
    s0 = pl.local(cs.get("ssm"))
    if mode == "decode":
        y, ssm_state = ssd_decode_step(s0, xh, dt, A, pl.local(Bm),
                                       pl.local(Cm))
    else:
        y, ssm_state = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm.chunk,
                                   init_state=s0,
                                   head_placements=pl.moved(xi, 2, 3))

    y = y + on_heads(p["D"])[None, None, :, None] * xh.float()
    y = y.reshape(xl.shape).to(x.dtype)
    y = y * F.silu(pl.local(z).float()).to(x.dtype)
    y = pl.norm(pl.back(y, xi), p["norm"], cfg.norm_eps)
    out = pl.mm(y, p["w_out"])

    new_cache = None
    if mode == "decode":
        for name, new in (("ssm", ssm_state), ("conv_x", cx),
                          ("conv_B", new_bc[0]), ("conv_C", new_bc[1])):
            pl.write(cs, name, new)
        new_cache = cs
    elif mode == "prefill":
        new_cache = {"ssm": pl.back(ssm_state, xi, pl.moved(xi, 2, 1)),
                     "conv_x": pl.back(cx, xi),
                     "conv_B": pl.back(new_bc[0], Bm),
                     "conv_C": pl.back(new_bc[1], Cm)}
    return out, new_cache


# ---------------------------------------------------------------------------
# the mixer's placement steps: whole tensors, or DTensors partitioned
# ---------------------------------------------------------------------------

class _Whole:
    """The placement steps of the whole-replica mixer: identities, and
    the decode states written in place for the slot ids in `rows`."""

    def __init__(self, rows):
        self.rows = rows

    def mm(self, x, w):
        return x @ w

    def head_cut(self, xi, Pd):
        return lambda t: t

    def used(self, w, x):
        return w

    def local(self, t):
        return t

    def back(self, t, like, placements=None):
        return t

    def moved(self, t, src, dst):
        return None

    def state(self, cs, name):
        return cs.get(name)

    def norm(self, y, scale, eps):
        return rmsnorm(y, scale, eps)

    def write(self, cs, name, new):
        if self.rows is None:
            cs[name].copy_(new)
        else:
            b = self.rows.to(device=new.device, dtype=torch.long)
            cs[name][b] = new[b].to(cs[name].dtype)


class _Placed(_Whole):
    """The placement steps of the partitioned mixer, as GSPMD partitions
    the JAX mixer by the rules: placed x [B, S, d] (rows over the batch
    axes, d whole) and placed weights; the five products through
    ``gather_fsdp``; z and x's inner channels over ``model``
    (``ssm_inner``), B, C and dt whole there.  A rank runs its heads
    (the channels of its shard, whole heads): the conv on its channels
    with its ``conv_x`` shard, B's and C's convs whole, dt, A, D and
    dt_bias cut to its heads, the SSD through the kernel's DTensor
    entry, the gate, and the gated norm of rows split over ``model``
    (``rmsnorm_split``: a [rows] fp32 all-reduce, the rows never
    gathered).  Every operand used whole on a rank's heads takes a
    gradient partial over the ranks of the other heads
    (``sharding.partial_grads``).  ``w_out``'s product leaves a partial
    sum over ``model``.

    'decode' writes the new states into the local shards of the placed
    caches (laid out by the cache rules: SSM states over
    ``state_heads``, conv states over ``ssm_inner``, B's and C's over
    N, gathered for the conv); 'prefill' returns them placed so.
    Per-slot `rows` are not partitioned.  A d_inner shard that cuts a
    head is refused; where d_inner does not divide ``model`` every rank
    runs all heads."""

    def __init__(self, rows):
        if rows is not None:
            raise NotImplementedError("per-slot writes (rows) are not "
                                      "partitioned")
        super().__init__(rows)

    def mm(self, x, w):
        return x @ shd.gather_fsdp(w)

    def head_cut(self, xi, Pd):
        dl = xi.to_local().shape[-1]
        if dl % Pd:
            raise NotImplementedError(f"a d_inner shard of {dl} channels "
                                      f"cuts heads of {Pd}")
        h0, hl = shd.local_offset(xi, 2) // Pd, dl // Pd
        return lambda t: t[..., h0:h0 + hl]

    def used(self, w, x):
        """Placed `w`'s local shard, used whole on placed `x`'s local
        shards: its gradient a partial sum over the mesh dims that shard
        x and not w."""
        return w.to_local(grad_placements=shd.partial_grads(w, x))

    def local(self, t):
        return None if t is None else t.to_local()

    def back(self, t, like, placements=None):
        return shd.from_local(t, like, placements)

    def moved(self, t, src, dst):
        """t's placements with Shard(src) moved to Shard(dst)."""
        return [shd.Shard(dst) if q == shd.Shard(src) else q
                for q in t.placements]

    def state(self, cs, name):
        t = cs.get(name)
        if t is not None and name != "conv_x":    # whole over N
            t = shd.replicate_dim(t, 2)
        return self.local(t)

    def norm(self, y, scale, eps):
        mesh, rules = shd.current_context()
        dims = shd.mesh_dims(mesh, rules, "ssm_inner")
        y = (rmsnorm_split(y, scale, eps, dims[0]) if len(dims) == 1
             else rmsnorm(y, scale, eps))
        return shd.constrain(y, ("batch", None, "ssm_inner"))

    def write(self, cs, name, new):
        loc = cs[name].to_local()
        if name in ("conv_B", "conv_C"):       # the cache's slice of N
            n0 = shd.local_offset(cs[name], 2)
            new = new[..., n0:n0 + loc.shape[-1]]
        loc.copy_(new)


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
