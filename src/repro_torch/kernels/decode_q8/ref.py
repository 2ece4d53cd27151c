"""Plain PyTorch int8 decode attention: the twin of
``repro.models.attention.decode_attention_q8``, line for line, over
the quantizer and masks of ``repro_torch.models.kv_quant``.

The integer products run in int32 on the CPU (an int8 ``einsum`` would
wrap) and in fp64 on the card, where PyTorch has no integer batched
product; both are exact, since every sum is at most Smax·127² < 2^53
in size.

The split form (``split_decode``): the cache's positions in blocks,
each a run [start, start + its length) of a cache of `smax` positions
(one block a rank in a context-parallel decode, or several on one
process).  The JAX function quantizes the probabilities with one scale
a row, ``ps = max|p·v_scale| / 127`` over every position, so a split
row needs its three statistics in turn, each reduced over every block:
the max of the scores, the sum of ``exp(s - m)``, the max of
``|pv|``; then the int32 P·V partial sums, summed over the blocks
(exactly).  Four stages around those four exchanges (``Stages``); the
plain ones here, the kernel's in ``ops.py``.  It is the JAX arithmetic
step for step; only the fp32 sum of exponentials is reassociated.
"""
from __future__ import annotations

from typing import (Any, Callable, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.distributed.sharding import all_reduce
from repro_torch.models.kv_quant import _div, quantize_kv, valid_positions

NEG_INF = -1e30

Block = Tuple[Mapping[str, torch.Tensor], int]     # (cache, start)
Exchange = Callable[[Sequence[torch.Tensor], str], torch.Tensor]


def _int_dot(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An exact integer product of int8 operands, as int32."""
    dt = torch.int32 if a.device.type == "cpu" else torch.float64
    return torch.einsum(eq, a.to(dt), b.to(dt)).to(torch.int32)


def combine_pv(pq: torch.Tensor, ps: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """pq int8 [B,KV,G,Smax] with its scales ps [B,KV,G] and v int8
    [B,Smax,KV,D] -> fp32 [B,KV,G,D]: int32 sums of pq·v, times ps."""
    return _int_dot("bkgs,bskd->bkgd", pq, v).float() * ps[..., None]


def _lens(cache_len, B: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(cache_len, device=device).long().expand(B)


def _scores(q, cache, lens, window, start: int, smax: int):
    """(int32 scores, fp32 scores with NEG_INF where masked), both
    [B,KV,G,Sl], of the positions [start, start + Sl) of a cache of
    `smax`."""
    B, _, Hq, D = q.shape
    Sl, KV = cache["k"].shape[1], cache["k"].shape[2]
    G = Hq // KV
    scale = 1.0 / (D ** 0.5)
    qq, qs = quantize_kv(q.reshape(B, KV, G, D))      # int8 [B,KV,G,D]
    s_i32 = _int_dot("bkgd,bskd->bkgs", qq, cache["k"])
    k_s = cache["k_scale"].float()                    # [B,S,KV]
    s = (s_i32.float() * qs.float()[..., None]
         * k_s.permute(0, 2, 1)[:, :, None, :]) * scale
    valid = valid_positions(lens, smax, window)
    if valid.shape[1] != Sl:
        valid = valid[:, start:start + Sl]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    return s_i32, s


def _v_scales(cache) -> torch.Tensor:
    return cache["v_scale"].float().permute(0, 2, 1)[:, :, None, :]


def _quantize_p(pv: torch.Tensor, ps: torch.Tensor) -> torch.Tensor:
    pq = torch.clamp(torch.round(pv / ps[..., None]), -127, 127)
    return pq.to(torch.int8)


def decode_attention_q8_ref(q: torch.Tensor,
                            cache: Mapping[str, torch.Tensor], cache_len,
                            *, window: Optional[int] = None,
                            debug: bool = False):
    """q [B,1,Hq,D] (bf16 or fp32); cache: int8 k, v [B,Smax,KV,D] and
    fp16 k_scale, v_scale [B,Smax,KV]; cache_len: scalar or per-slot [B]
    length including the token being decoded.  Returns [B,1,Hq,D] in
    q's dtype; with `debug`, also the int32 scores [B,KV,G,Smax] and the
    quantized probabilities pq [B,KV,G,Smax] int8 and their scales ps
    [B,KV,G] fp32.  The split form of a cache held in blocks is
    ``split_decode(PLAIN_STAGES, ...)``."""
    B, _, Hq, D = q.shape
    lens = _lens(cache_len, B, q.device)
    s_i32, s = _scores(q, cache, lens, window, 0, cache["k"].shape[1])
    p = torch.softmax(s, dim=-1)                      # [B,KV,G,S] fp32
    # fold v's per-token scale into p, then quantize p per row
    pv = p * _v_scales(cache)
    ps = torch.clamp(_div(pv.abs().amax(dim=-1), 127.0), min=1e-20)
    pq = _quantize_p(pv, ps)
    out = combine_pv(pq, ps, cache["v"]).reshape(B, 1, Hq, D).to(q.dtype)
    if debug:
        return out, s_i32, pq, ps
    return out


# ---------------------------------------------------------------------------
# the split form
# ---------------------------------------------------------------------------

class Stages(NamedTuple):
    """The four stages of a block, each returning what the exchange after
    it reduces over the blocks (a [B,KV,G] statistic; the int32
    [B,KV,G,D] sums) beside the state the next stage reads:

      scores(q, cache, lens, window, start, smax) -> (state, max s)
      exp(state, m)                               -> (state, sum e)
      pv(state, l)                                -> (state, max |pv|)
      pq(state, ps, debug)                        -> (int32 sums, pq)

    pq is the block's int8 [B,KV,G,Sl] with `debug` (else None)."""
    scores: Callable[..., Tuple[Any, torch.Tensor]]
    exp: Callable[..., Tuple[Any, torch.Tensor]]
    pv: Callable[..., Tuple[Any, torch.Tensor]]
    pq: Callable[..., Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _plain_scores(q, cache, lens, window, start, smax):
    _, s = _scores(q, cache, lens, window, start, smax)
    return {"x": s, "cache": cache}, s.amax(dim=-1)


def _plain_exp(state, m):
    e = torch.exp(state["x"] - m[..., None])
    return dict(state, x=e), e.sum(dim=-1)


def _plain_pv(state, l):
    pv = (state["x"] / l[..., None]) * _v_scales(state["cache"])
    return dict(state, x=pv), pv.abs().amax(dim=-1)


def _plain_pq(state, ps, debug=False):
    pq = _quantize_p(state["x"], ps)
    return (_int_dot("bkgs,bskd->bkgd", pq, state["cache"]["v"]),
            pq if debug else None)


PLAIN_STAGES = Stages(_plain_scores, _plain_exp, _plain_pv, _plain_pq)


def block_exchange(group=None) -> Exchange:
    """The exchange of a rank's blocks: reduced here in block order
    ("max" or "sum"), then all-reduced over `group` (the ranks holding
    the other positions) when given."""
    def exchange(parts, op):
        t = parts[0]
        for u in parts[1:]:
            t = torch.maximum(t, u) if op == "max" else t + u
        return t if group is None else all_reduce(t, op, group)
    return exchange


def split_decode(stages: Stages, q: torch.Tensor, blocks: Sequence[Block],
                 lens: torch.Tensor, *, window: Optional[int], smax: int,
                 exchange: Exchange, debug: bool = False):
    """Decode attention of q [B,1,Hq,D] over a cache of `smax` positions
    held as `blocks` [(cache, start)]: each stage on every block, then
    its part exchanged (``Exchange``: the reduction over every block of
    every rank).  A rank all of whose positions are masked has a local
    max of NEG_INF; after the max exchange its exponentials are 0, so it
    adds zeros.  Returns [B,1,Hq,D] in q's dtype; with `debug`, also
    the blocks' pq concatenated along the positions."""
    B, _, Hq, D = q.shape
    states, parts = zip(*(stages.scores(q, c, lens, window, s0, smax)
                          for c, s0 in blocks))
    m = exchange(parts, "max")
    states, parts = zip(*(stages.exp(st, m) for st in states))
    l = exchange(parts, "sum")
    states, parts = zip(*(stages.pv(st, l) for st in states))
    ps = torch.clamp(_div(exchange(parts, "max"), 127.0), min=1e-20)
    sums, pqs = zip(*(stages.pq(st, ps, debug) for st in states))
    total = exchange(sums, "sum")
    out = (total.float() * ps[..., None]).reshape(B, 1, Hq, D).to(q.dtype)
    if debug:
        return out, torch.cat(pqs, dim=-1)
    return out
