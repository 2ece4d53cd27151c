"""Plain PyTorch int8 decode attention: the twin of
``repro.models.attention.decode_attention_q8``, line for line, over
the quantizer and masks of ``repro_torch.models.kv_quant``.

The integer products run in int32 on the CPU (an int8 ``einsum`` would
wrap) and in fp64 on the card, where PyTorch has no integer batched
product; both are exact, since every sum is at most Smax·127² < 2^53
in size.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from repro_torch.models.kv_quant import _div, quantize_kv, valid_positions

NEG_INF = -1e30


def _int_dot(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An exact integer product of int8 operands, as int32."""
    dt = torch.int32 if a.device.type == "cpu" else torch.float64
    return torch.einsum(eq, a.to(dt), b.to(dt)).to(torch.int32)


def combine_pv(pq: torch.Tensor, ps: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """pq int8 [B,KV,G,Smax] with its scales ps [B,KV,G] and v int8
    [B,Smax,KV,D] -> fp32 [B,KV,G,D]: int32 sums of pq·v, times ps."""
    return _int_dot("bkgs,bskd->bkgd", pq, v).float() * ps[..., None]


def decode_attention_q8_ref(q: torch.Tensor,
                            cache: Mapping[str, torch.Tensor], cache_len,
                            *, window: Optional[int] = None,
                            debug: bool = False):
    """q [B,1,Hq,D] (bf16 or fp32); cache: int8 k, v [B,Smax,KV,D] and
    fp16 k_scale, v_scale [B,Smax,KV]; cache_len: scalar or per-slot [B]
    length including the token being decoded.  Returns [B,1,Hq,D] in
    q's dtype; with `debug`, also the int32 scores [B,KV,G,Smax] and the
    quantized probabilities pq [B,KV,G,Smax] int8 and their scales ps
    [B,KV,G] fp32."""
    B, _, Hq, D = q.shape
    Smax, KV = cache["k"].shape[1], cache["k"].shape[2]
    G = Hq // KV
    scale = 1.0 / (D ** 0.5)
    lens = torch.as_tensor(cache_len, device=q.device).long().expand(B)

    qq, qs = quantize_kv(q.reshape(B, KV, G, D))      # int8 [B,KV,G,D]
    s_i32 = _int_dot("bkgd,bskd->bkgs", qq, cache["k"])
    k_s = cache["k_scale"].float()                    # [B,S,KV]
    s = (s_i32.float() * qs.float()[..., None]
         * k_s.permute(0, 2, 1)[:, :, None, :]) * scale

    valid = valid_positions(lens, Smax, window)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)                      # [B,KV,G,S] fp32
    # fold v's per-token scale into p, then quantize p per row
    v_s = cache["v_scale"].float().permute(0, 2, 1)
    pv = p * v_s[:, :, None, :]
    ps = torch.clamp(_div(pv.abs().amax(dim=-1), 127.0), min=1e-20)
    pq = torch.clamp(torch.round(pv / ps[..., None]), -127, 127)
    pq = pq.to(torch.int8)
    out = combine_pv(pq, ps, cache["v"]).reshape(B, 1, Hq, D).to(q.dtype)
    if debug:
        return out, s_i32, pq, ps
    return out
