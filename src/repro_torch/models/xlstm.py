"""xLSTM blocks: the twin of ``repro.models.xlstm`` — the mLSTM (matrix
memory, chunkwise parallel) and the sLSTM (scalar memory, sequential),
with exponential gating and the max stabilizer m_t.

The mLSTM runs chunkwise (``_mlstm_chunked``) for prefill and training
and step by step (``_mlstm_cell``) for one-token decode; the two give
the same numbers.  The stabilizer is a max-plus recurrence,
m_t = max(m_{t-1} + logf_t, i_t), which JAX computes with an
associative scan; here it is the closed form of that scan: with
a = cumsum(logf), m_t = max(a_t + cummax_j<=t(i_j - a_j), m_0 + a_t).
The gates and the recurrent state are fp32.

Cache layout (per layer):
  mLSTM: {"C": [B,H,P,P], "n": [B,H,P], "m": [B,H], "conv": [B,W-1,di]}
  sLSTM: {"c": [B,H,Dh], "n": [B,H,Dh], "m": [B,H,Dh], "h": [B,H,Dh]}
'prefill' and 'decode' return new caches; the inputs are not written.

Placed x and weights (DTensors, a partitioned step) run the same cells
through ``_Placed``'s placement steps, as GSPMD partitions the JAX
cells by the rules.  The mLSTM's projections, conv, gate and ``w_out``
are split over ``model`` (``ssm_inner``), but its recurrence runs all
heads on every ``model`` rank (a rank's inner channels cut a head:
xlstm-125m's 384-wide heads on 96 channels a rank), on the rank's
batch rows as local tensors; the sLSTM's pre-activations are whole
over ``model`` and its loop over tokens runs on local tensors too.  So
no collective, and no DTensor dispatch, sits inside either loop.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import params as P
from repro_torch.models.common import rmsnorm
from repro_torch.models.ssm import causal_conv

CONV_W = 4
CHUNK = 64      # the longest mLSTM chunk


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, head dim)."""
    di = 2 * cfg.d_model
    H = cfg.num_heads
    return di, H, di // H


def mlstm_spec(cfg: ModelConfig) -> Dict[str, P.Leaf]:
    """``init_mlstm``: the gate weights and biases stay fp32; the
    forget-gate bias starts at 3 (long memory at init)."""
    d = cfg.d_model
    di, H, _ = mlstm_dims(cfg)
    inner = ("embed", "ssm_inner")         # axes: ``mlstm_specs``
    col = ("ssm_inner", None)
    return {
        "w_x": P.dense(d, di, fan_in=d, axes=inner),
        "w_z": P.dense(d, di, fan_in=d, axes=inner),
        "conv": P.dense(di, CONV_W, fan_in=CONV_W, axes=col),
        "wq": P.dense(di, di, fan_in=di, axes=col),
        "wk": P.dense(di, di, fan_in=di, axes=col),
        "wv": P.dense(di, di, fan_in=di, axes=col),
        "w_i": P.dense(di, H, fan_in=di, fp32=True, axes=col),
        "w_f": P.dense(di, H, fan_in=di, fp32=True, axes=col),
        "b_i": P.zeros(H, fp32=True, axes=(None,)),
        "b_f": P.full(H, value=3.0, fp32=True, axes=(None,)),
        "norm": P.norm(di, "ssm_inner"),
        "w_out": P.dense(di, d, fan_in=di, axes=("ssm_inner", "embed")),
    }


def slstm_spec(cfg: ModelConfig) -> Dict[str, P.Leaf]:
    """``init_slstm``: block-diagonal recurrent weights [H, Dh, Dh] and
    the biases fp32; the forget-gate bias starts at 1."""
    d = cfg.d_model
    H = cfg.num_heads
    Dh = d // H
    # axes: ``slstm_specs`` (w_out's output dim on the model axis)
    spec: Dict[str, P.Leaf] = {
        "norm": P.norm(d), "w_out": P.dense(d, d, fan_in=d,
                                            axes=("embed", "mlp"))}
    for g in ("i", "f", "z", "o"):
        spec[f"w_{g}"] = P.dense(d, d, fan_in=d, axes=("embed", None))
        spec[f"r_{g}"] = P.dense(H, Dh, Dh, fan_in=Dh, fp32=True,
                                 axes=(None, None, None))
        spec[f"b_{g}"] = P.full(d, value=1.0 if g == "f" else 0.0,
                                fp32=True, axes=(None,))
    return spec


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_cell(carry, q, k, v, i_pre, f_pre):
    """One timestep.  carry: (C [B,H,P,P], n [B,H,P], m [B,H]); q, k, v
    [B,H,P], i_pre, f_pre [B,H].  Returns (new carry, h [B,H,P])."""
    C, n, m = carry
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(logf + m - m_new)
    C_new = f_g[..., None, None] * C + i_g[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = f_g[..., None] * n + i_g[..., None] * k
    num = torch.einsum("bhp,bhpq->bhq", q, C_new)
    den = torch.clamp(torch.einsum("bhp,bhp->bh", q, n_new).abs(), min=1.0)
    return (C_new, n_new, m_new), num / den[..., None]


class _CumMax(torch.autograd.Function):
    """``torch.cummax(x, dim=1)``'s values, with a deterministic
    backward.  torch's scatter-adds each output's gradient into the
    position of its max with atomics, whose order varies between runs on
    CUDA.  The positions sharing a max are a run [j, next run's start),
    so here the gradient at a run's start j is the difference of two
    entries of an fp64 running sum of the gradient, and zero elsewhere."""

    @staticmethod
    def forward(ctx, x):
        values, idx = torch.cummax(x, dim=1)
        ctx.save_for_backward(idx)
        return values

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        S = idx.shape[1]
        pos = torch.arange(S, device=idx.device).view(
            (1, S) + (1,) * (idx.dim() - 2))
        first = idx == pos                      # a run starts here
        start = torch.where(first, pos, S)
        # the next run's start after each position (S after the last)
        after = torch.cat([start[:, 1:], torch.full_like(start[:, :1], S)],
                          dim=1)
        nxt = torch.flip(torch.cummin(torch.flip(after, [1]), dim=1).values,
                         [1])
        run = torch.cumsum(g.double(), dim=1)
        run = torch.cat([torch.zeros_like(run[:, :1]), run], dim=1)
        sums = torch.gather(run, 1, nxt) - run[:, :S]  # g summed over a run
        return torch.where(first, sums, torch.zeros_like(sums)).to(g.dtype)


def _mlstm_chunked(q, k, v, i_pre, f_pre, carry0):
    """Chunkwise-parallel mLSTM, equal to the sequential cell: q, k, v
    [B,S,H,P], i_pre, f_pre [B,S,H] fp32.  The chunk length is the
    largest divisor of S up to CHUNK (a prime S gives 1).  Returns
    (h [B,S,H,P], (C, n, m) after the last step)."""
    B, S, H, Pd = q.shape
    Q = CHUNK
    while S % Q:
        Q -= 1
    nc = S // Q
    C0, n0, m0 = carry0

    logf = F.logsigmoid(f_pre)                          # [B,S,H]
    a_cum = torch.cumsum(logf, dim=1)
    b_cum = a_cum + _CumMax.apply(i_pre - a_cum)
    m = torch.maximum(b_cum, m0[:, None, :] + a_cum)    # [B,S,H]

    def ch(t):
        return t.reshape((B, nc, Q) + tuple(t.shape[2:]))
    qc, kc, vc = ch(q), ch(k), ch(v)
    ac, ic, mc = ch(a_cum), ch(i_pre), ch(m)
    a_end = ac[:, :, -1]                                # [B,nc,H]
    m_end = mc[:, :, -1]
    m_in = torch.cat([m0[:, None, :], m_end[:, :-1]], dim=1)
    a_in = torch.cat([torch.zeros_like(a_end[:, :1]), a_end[:, :-1]],
                     dim=1)

    # inter-chunk state scan, once per chunk: each chunk's summary
    # relative to its own end, and the decay of the incoming state
    w_sum = torch.exp(a_end[:, :, None] - ac + ic - m_end[:, :, None])
    S_c = torch.einsum("bnqh,bnqhp,bnqhr->bnhpr", w_sum, kc, vc)
    N_c = torch.einsum("bnqh,bnqhp->bnhp", w_sum, kc)
    dec = torch.exp(a_end - a_in + m_in - m_end)         # [B,nc,H]
    C_prev, n_prev = C0, n0
    C_ins, n_ins = [], []
    for c in range(nc):
        C_ins.append(C_prev)
        n_ins.append(n_prev)
        C_prev = dec[:, c, :, None, None] * C_prev + S_c[:, c]
        n_prev = dec[:, c, :, None] * n_prev + N_c[:, c]
    C_in = torch.stack(C_ins, dim=1)                    # [B,nc,H,P,P]
    n_in = torch.stack(n_ins, dim=1)                    # [B,nc,H,P]

    # intra-chunk, attention-like: w_tj = exp(a_t - a_j + i_j - m_t),
    # j <= t (the exponent past the diagonal may overflow: select, not
    # multiply)
    wd = torch.exp(ac[:, :, :, None, :] - ac[:, :, None, :, :]
                   + ic[:, :, None, :, :] - mc[:, :, :, None, :])
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    wd = torch.where(tri[None, None, :, :, None], wd, torch.zeros_like(wd))
    scores = torch.einsum("bnqhp,bnjhp->bnqjh", qc, kc)
    y_intra = torch.einsum("bnqjh,bnqjh,bnjhp->bnqhp", scores, wd, vc)

    dec_t = torch.exp(ac - a_in[:, :, None] + m_in[:, :, None] - mc)
    y_inter = torch.einsum("bnqh,bnqhp,bnhpr->bnqhr", dec_t, qc, C_in)
    n_inter = torch.einsum("bnqh,bnqhp,bnhp->bnqh", dec_t, qc, n_in)

    num = (y_intra + y_inter).reshape(B, S, H, Pd)
    qn = (torch.einsum("bnqjh,bnqhp,bnjhp->bnqh", wd, qc, kc)
          + n_inter).reshape(B, S, H)
    den = torch.clamp(qn.abs(), min=1.0)
    return num / den[..., None], (C_prev, n_prev, m[:, -1])


def mlstm_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                  cfg: ModelConfig, *, mode: str,
                  cache: Optional[Dict[str, torch.Tensor]] = None):
    """x [B,S,d] -> (out [B,S,d], new cache or None).  A prompt (S > 1)
    takes the chunked form, a decode step the sequential cell.  Placed x
    runs the same body through ``_Placed`` (module docstring): q, k, v
    and the gates are the partial sums of the rank's inner channels,
    reduced whole; the recurrence runs on the rank's rows, all heads;
    the norm on whole rows, then the gate and ``w_out`` on the rank's
    channels, whose product is left a partial sum over ``model``."""
    pl = _Placed() if shd.is_placed(x) else _Whole()
    S = x.shape[1]
    di, H, Pd = mlstm_dims(cfg)
    xi = pl.mm(x, p["w_x"])
    z = pl.mm(x, p["w_z"])
    cs = cache or {}
    xcl, conv_state = causal_conv(pl.local(xi), pl.used(p["conv"], xi),
                                  pl.local(cs.get("conv")))
    xc = pl.back(xcl, xi)
    qw = pl.whole(xc @ p["wq"])          # [B,S,di], whole over model
    Bl = pl.local(qw).shape[0]           # the rank's rows

    def heads(t):
        return pl.local(t).reshape(Bl, S, H, Pd).float()
    q = heads(qw)
    k = heads(pl.whole(xc @ p["wk"])) / (Pd ** 0.5)
    v = heads(pl.whole(xi @ p["wv"]))
    i_pre = pl.local(pl.whole(xc.float() @ p["w_i"]) + p["b_i"])  # [B,S,H]
    f_pre = pl.local(pl.whole(xc.float() @ p["w_f"]) + p["b_f"])

    if "C" in cs:
        carry = tuple(pl.local(cs[n]) for n in ("C", "n", "m"))
    else:
        carry = (q.new_zeros((Bl, H, Pd, Pd)), q.new_zeros((Bl, H, Pd)),
                 q.new_zeros((Bl, H)))

    if S > 1:
        h4, carry = _mlstm_chunked(q, k, v, i_pre, f_pre, carry)
    else:
        hs = []
        for t in range(S):
            carry, ht = _mlstm_cell(carry, q[:, t], k[:, t], v[:, t],
                                    i_pre[:, t], f_pre[:, t])
            hs.append(ht)
        h4 = torch.stack(hs, dim=1)
    h = pl.back(h4.reshape(Bl, S, di).to(x.dtype), qw)
    h = pl.channels(rmsnorm(h, p["norm"], cfg.norm_eps), z)
    h = h * F.silu(z.float()).to(x.dtype)
    out = pl.mm(h, p["w_out"])

    new_cache = None
    if mode in ("decode", "prefill"):
        C, n, m = (pl.back(t, qw) for t in carry)
        new_cache = {"C": C, "n": n, "m": m,
                     "conv": pl.back(conv_state, xi)}
    return out, new_cache


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    di, H, Pd = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, Pd, Pd), **f32),
            "n": torch.zeros((batch, H, Pd), **f32),
            "m": torch.zeros((batch, H), **f32),
            "conv": torch.zeros((batch, CONV_W - 1, di), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                  cfg: ModelConfig, *, mode: str,
                  cache: Optional[Dict[str, torch.Tensor]] = None):
    """x [B,S,d] -> (out [B,S,d], new cache or None): the sequential
    scan, one step per token (each step's recurrence reads the last
    step's h).  Placed x: the pre-activations whole over ``model``, the
    scan on the rank's rows as local tensors, the norm on whole rows,
    and ``w_out``'s product with its output over ``model``."""
    pl = _Placed() if shd.is_placed(x) else _Whole()
    S, d = x.shape[1:]
    H = cfg.num_heads
    Dh = d // H
    Bl = pl.local(x).shape[0]            # the rank's rows

    def pre(g):
        y = pl.local(pl.mm(x, p[f"w_{g}"]).float() + p[f"b_{g}"])
        return y.reshape(Bl, S, H, Dh)
    xi, xf, xz, xo = (pre(g) for g in ("i", "f", "z", "o"))
    r = {g: pl.used(p[f"r_{g}"], x) for g in ("i", "f", "z", "o")}

    cs = cache or {}
    if "c" in cs:
        c, n, m, h = (pl.local(cs[k]) for k in ("c", "n", "m", "h"))
    else:
        zero = xi.new_zeros((Bl, H, Dh))
        c, n, m, h = zero, zero, zero - 1e30, zero

    def rec(g, hprev):
        return torch.einsum("bhd,hde->bhe", hprev, r[g])
    hs = []
    for t in range(S):
        it = xi[:, t] + rec("i", h)
        ft = xf[:, t] + rec("f", h)
        zt = torch.tanh(xz[:, t] + rec("z", h))
        ot = torch.sigmoid(xo[:, t] + rec("o", h))
        logf = F.logsigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        i_g = torch.exp(it - m_new)
        f_g = torch.exp(logf + m - m_new)
        c = f_g * c + i_g * zt
        n = f_g * n + i_g
        m = m_new
        h = ot * c / torch.clamp(n, min=1.0)
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(Bl, S, d).to(x.dtype)
    y = rmsnorm(pl.back(y, x), p["norm"], cfg.norm_eps)
    out = pl.mm(y, p["w_out"])

    new_cache = None
    if mode in ("decode", "prefill"):
        new_cache = {k: pl.back(t, x) for k, t in
                     (("c", c), ("n", n), ("m", m), ("h", h))}
    return out, new_cache


def init_slstm_cache(cfg: ModelConfig, batch: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    H = cfg.num_heads
    zero = torch.zeros((batch, H, cfg.d_model // H), dtype=torch.float32,
                       device=device)
    return {"c": zero, "n": zero.clone(), "m": zero - 1e30,
            "h": zero.clone()}


# ---------------------------------------------------------------------------
# the cells' placement steps: whole tensors, or DTensors partitioned
# ---------------------------------------------------------------------------

class _Whole:
    """The placement steps of the whole-replica cells: identities."""

    def mm(self, x, w):
        return x @ w

    def whole(self, t):
        return t

    def used(self, w, x):
        return w

    def local(self, t):
        return t

    def back(self, t, like):
        return t

    def channels(self, y, like):
        return y


class _Placed(_Whole):
    """The placement steps of the partitioned cells, as GSPMD partitions
    the JAX cells by the rules: placed x [B, S, d] (rows over the batch
    axes, d whole) and placed weights; the products from d through
    ``gather_fsdp``; a product over the mLSTM's inner channels (over
    ``model``) a partial sum that ``whole`` reduces.  The recurrences
    run on ``local`` shards (the rank's rows, whole over ``model``),
    and ``back`` places a local result like a DTensor of the same rows.
    A leaf used whole on the local rows takes a gradient partial over
    the ranks of the other rows (``sharding.partial_grads``)."""

    def mm(self, x, w):
        return x @ shd.gather_fsdp(w)

    def whole(self, t):
        """A pending partial sum reduced, the last dim whole."""
        return shd.replicate_dim(t, -1)

    def used(self, w, x):
        """Placed `w`'s local shard, used whole on placed `x`'s local
        rows: its gradient a partial sum over the mesh dims that shard
        x and not w."""
        return w.to_local(grad_placements=shd.partial_grads(w, x))

    def local(self, t):
        return None if t is None else t.to_local()

    def back(self, t, like):
        return shd.from_local(t, like)

    def channels(self, y, like):
        """Whole rows y cut to `like`'s channels (a local split; its
        backward gathers the gradient whole)."""
        return y.redistribute(like.device_mesh, like.placements)
