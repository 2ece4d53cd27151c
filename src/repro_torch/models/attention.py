"""Attention: the twin of ``repro.models.attention`` for the dense
decoder — GQA with RoPE and an optional sliding window, flash-attention
prefill, chunk-append prefill and KV-cache decode.

Layouts match the JAX package at every public function: activations
[B,S,H,D], caches [B,Smax,KV,D], weights ``x @ W`` as [d_in, d_out].

Caches are written IN PLACE (the JAX versions return updated copies):
``cache_update`` and ``chunk_cache_update`` assign into the given
tensors, which may be views of a layer slice of a stacked cache.  An
optional ``rows`` index tensor (slot ids) limits the writes to those
slots, so the other slots of a serving pool stay bit-identical.

``attn_forward`` in the 'chunk' and 'decode' modes writes every slot,
attends, and then puts back the old contents of the slots in `keep`:
each slot attends over its own new keys, as in the JAX engine, which
computes every lane and discards the unselected lanes' caches
afterwards (its masked merge).  That matters for MoE models, whose
capacity drops couple a token's output to every token in the batch.

The prefill branch of ``attn_forward`` goes through the flash-attention
kernel wrapper: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors.  The int8 decode path (``decode_attention_q8``) and the
FA-2 backward come with later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import common

NEG_INF = -1e30


def attn_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(q_heads, kv_heads, head_dim), paper-exact."""
    return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim


# ---------------------------------------------------------------------------
# chunked flash attention, forward only (plain twin of flash_attention_jnp)
# ---------------------------------------------------------------------------

def _pick_chunk(S: int, target: int) -> int:
    """Largest divisor of S that is <= target."""
    c = min(target, S)
    while S % c:
        c -= 1
    return c


def flash_attention_chunked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            q_chunk: int = 512,
                            k_chunk: int = 512) -> torch.Tensor:
    """The forward of ``repro.models.attention.flash_attention_jnp``:
    q [B,S,Hq,D], k/v [B,Sk,KV,D] -> [B,S,Hq,D], with running max,
    denominator and accumulator in fp32 per query chunk."""
    B, S, Hq, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = Hq // KV
    assert S == Sk or (not causal and window is None), \
        "cross-attention must be unmasked"
    q_chunk, k_chunk = _pick_chunk(S, q_chunk), _pick_chunk(Sk, k_chunk)
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, S, KV, G, D)
    rel = (torch.arange(q_chunk, device=q.device)[:, None]
           - torch.arange(k_chunk, device=q.device)[None, :])
    outs = []
    for q0 in range(0, S, q_chunk):
        qi = qg[:, q0:q0 + q_chunk].float()                # [B,Qc,KV,G,D]
        m = torch.full((B, KV, G, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, q_chunk), device=q.device)
        acc = torch.zeros((B, KV, G, q_chunk, D), device=q.device)
        for k0 in range(0, Sk, k_chunk):
            kc = k[:, k0:k0 + k_chunk].float()             # [B,Kc,KV,D]
            vc = v[:, k0:k0 + k_chunk].float()
            s = torch.einsum("bqkgd,bckd->bkgqc", qi, kc) * scale
            if causal or window is not None:
                delta = rel + (q0 - k0)
                mask = torch.ones_like(delta, dtype=torch.bool)
                if causal:
                    mask &= delta >= 0
                if window is not None:
                    mask &= delta < window
                s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p, vc)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # [B,KV,G,Qc,D]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, Hq, D))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# decode / chunk attention over a KV cache
# ---------------------------------------------------------------------------

def _lens(cache_len, B: int, device: torch.device) -> torch.Tensor:
    """Scalar or per-slot [B] lengths -> int64 [B] on `device`."""
    return torch.as_tensor(cache_len, device=device).long().expand(B)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """q: [B,1,Hq,D]; caches: [B,Smax,KV,D]; cache_len: scalar or
    per-slot [B] length including the token being decoded.  A windowed
    cache with Smax == window is a ring: every slot is valid once
    full."""
    B, _, Hq, D = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = Hq // KV
    scale = 1.0 / (D ** 0.5)
    lens = _lens(cache_len, B, q.device)
    qg = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    pos = torch.arange(Smax, device=q.device)
    if window is not None and Smax == window:
        valid = pos[None] < torch.clamp(lens, max=Smax)[:, None]  # ring
    else:
        valid = pos[None] < lens[:, None]
        if window is not None:
            valid &= pos[None] >= (lens - window)[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def chunk_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, cache_len, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B,C,Hq,D], C new queries after `cache_len` cached tokens;
    query i sits at cache_len + i and attends causally over
    cache[0 : cache_len + i + 1].  No ring caches."""
    B, C, Hq, D = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = Hq // KV
    scale = 1.0 / (D ** 0.5)
    lens = _lens(cache_len, B, q.device)
    qg = q.reshape(B, C, KV, G, D).float()
    s = torch.einsum("bckgd,bskd->bckgs", qg, k_cache.float()) * scale
    pos = torch.arange(Smax, device=q.device)
    end = lens[:, None] + torch.arange(C, device=q.device)[None, :] + 1
    valid = pos[None, None] < end[..., None]                # [B, C, Smax]
    if window is not None:
        valid &= pos[None, None] >= (end - window)[..., None]
    s = torch.where(valid[:, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bckgs,bskd->bckgd", p, v_cache.float())
    return out.reshape(B, C, Hq, D).to(q.dtype)


def _write_rows(rows: Optional[torch.Tensor], B: int,
                device: torch.device) -> torch.Tensor:
    if rows is None:
        return torch.arange(B, device=device)
    return rows.to(device=device, dtype=torch.long)


def _write_positions(lens: torch.Tensor, new: int, smax: int,
                     ring: bool) -> torch.Tensor:
    """[B, new] cache positions a write of `new` tokens at `lens` lands
    on: a ring write wraps; otherwise the start is clamped to
    smax - new, as the JAX ``dynamic_update_slice`` clamps it."""
    if ring:
        return (lens % smax)[:, None]
    start = torch.clamp(lens, max=smax - new)
    return start[:, None] + torch.arange(new, device=lens.device)[None]


def _write(k_cache, v_cache, k_new, v_new, pos, rows):
    b = _write_rows(rows, k_new.shape[0], k_cache.device)
    k_cache[b[:, None], pos[b]] = k_new[b].to(k_cache.dtype)
    v_cache[b[:, None], pos[b]] = v_new[b].to(v_cache.dtype)
    return k_cache, v_cache


def chunk_cache_update(k_cache: torch.Tensor, v_cache: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor, cache_len,
                       rows: Optional[torch.Tensor] = None):
    """Write a C-token chunk [B,C,...] at per-slot offset `cache_len`, in
    place, for the slots in `rows` (all when None).  Callers keep
    cache_len + C <= Smax for the slots whose writes count (see
    ``check_cache_bounds``); past it the start is clamped as the JAX
    ``dynamic_update_slice`` clamps it."""
    B, C = k_new.shape[0], k_new.shape[1]
    lens = _lens(cache_len, B, k_cache.device)
    pos = _write_positions(lens, C, k_cache.shape[1], ring=False)
    return _write(k_cache, v_cache, k_new, v_new, pos, rows)


def cache_update(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, cache_len,
                 window: Optional[int] = None,
                 rows: Optional[torch.Tensor] = None):
    """Write one position [B,1,...] at cache_len (ring write if
    windowed), in place, for the slots in `rows` (all when None)."""
    B, Smax = k_cache.shape[0], k_cache.shape[1]
    lens = _lens(cache_len, B, k_cache.device)
    ring = window is not None and Smax == window
    pos = _write_positions(lens, 1, Smax, ring)
    return _write(k_cache, v_cache, k_new, v_new, pos, rows)


def other_rows(rows: Optional[torch.Tensor], B: int,
               device: torch.device) -> Optional[torch.Tensor]:
    """The slot ids of a [B] pool that are NOT in `rows` (None when
    `rows` is None or holds every slot).  One host sync."""
    if rows is None:
        return None
    keep = torch.ones(B, dtype=torch.bool, device=device)
    keep[rows.to(device=device, dtype=torch.long)] = False
    idx = torch.nonzero(keep).flatten()
    return idx if idx.numel() else None


def check_cache_bounds(lens: torch.Tensor, new: int, smax: int,
                       rows: Optional[torch.Tensor] = None,
                       ring: bool = False) -> None:
    """Raise unless every written slot has lens + new <= smax."""
    if ring:
        return
    sel = lens if rows is None else lens[rows.to(lens.device).long()]
    if sel.numel() and int(sel.max()) + new > smax:
        raise ValueError(f"cache write past capacity: len {int(sel.max())}"
                         f" + {new} > {smax}")


# ---------------------------------------------------------------------------
# full attention block forward
# ---------------------------------------------------------------------------

def attn_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 positions: torch.Tensor, *, cfg: ModelConfig, mode: str,
                 cache: Optional[Dict[str, Any]] = None,
                 keep: Optional[torch.Tensor] = None,
                 window: Optional[int] = None,
                 kv_override: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None,
                 bidirectional: bool = False, use_rope: bool = True):
    """Returns (out [B,S,d], new_cache).

    mode: 'train' | 'prefill' | 'chunk' | 'decode'.  'chunk' and
    'decode' write the cache in place, except for the slot ids in
    `keep`, whose caches come out unchanged; 'prefill' returns a new
    cache holding this call's k, v.  `window` overrides the config's
    sliding window (zamba's shared block passes it).  `kv_override`:
    (k, v) [B,Skv,KV,D] given, as whisper's cross-attention gives the
    encoder's: no K/V projection, no cache write, every key attended
    (decode too).  `bidirectional` drops the causal mask (whisper's
    encoder); `use_rope` False leaves q and k unrotated.
    """
    B, S, _ = x.shape
    hq, kvh, hd = attn_dims(cfg)
    wdw = window if window is not None else cfg.sliding_window

    q = x @ p["wq"]
    if kv_override is None:
        k = x @ p["wk"]
        v = x @ p["wv"]
        if "bq" in p:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        k = k.reshape(B, S, kvh, hd)
        v = v.reshape(B, S, kvh, hd)
        if use_rope:
            k = common.apply_rope(k, positions, cfg.rope_theta)
    else:
        if "bq" in p:
            q = q + p["bq"]
        k, v = kv_override
    q = q.reshape(B, S, hq, hd)
    if use_rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)

    new_cache = cache
    if mode in ("chunk", "decode") and kv_override is None:
        assert cache is not None
        kc, vc = cache["k"], cache["v"]
        lens = _lens(cache["len"], B, kc.device)
        ring = mode == "decode" and wdw is not None and kc.shape[1] == wdw
        pos = _write_positions(lens, S, kc.shape[1], ring)
        saved = None
        if keep is not None:
            saved = (kc[keep[:, None], pos[keep]].clone(),
                     vc[keep[:, None], pos[keep]].clone())
        _write(kc, vc, k, v, pos, None)
        if mode == "chunk":
            out = chunk_attention(q, kc, vc, cache["len"], window=wdw)
        else:
            out = decode_attention(q, kc, vc, cache["len"] + 1, window=wdw)
        if saved is not None:
            kc[keep[:, None], pos[keep]] = saved[0]
            vc[keep[:, None], pos[keep]] = saved[1]
        new_cache = {"k": kc, "v": vc, "len": cache["len"] + S}
    elif mode == "decode":
        # cross-attention while decoding: every encoder position
        out = decode_attention(q, k, v, k.shape[1])
    elif mode in ("prefill", "train"):
        out = flash_attention(
            q, k, v, causal=kv_override is None and not bidirectional,
            window=wdw)
        if mode == "prefill" and kv_override is None:
            new_cache = {"k": k, "v": v,
                         "len": torch.tensor(S, dtype=torch.int32,
                                             device=x.device)}
    else:
        raise ValueError(f"unknown attention mode {mode!r}"
                         + (" with kv_override" if kv_override else ""))

    y = out.reshape(B, S, hq * hd) @ p["wo"]
    return y, new_cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  dtype: torch.dtype, device: torch.device,
                  window: Optional[int] = None) -> Dict[str, Any]:
    """A [batch, size, KV, D] cache; a windowed cache (`window`, else the
    config's `sliding_window`) is a ring of that many positions when
    that is shorter than max_len."""
    _, kvh, hd = attn_dims(cfg)
    wdw = window if window is not None else cfg.sliding_window
    size = min(max_len, wdw) if wdw is not None else max_len
    return {
        "k": torch.zeros((batch, size, kvh, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, kvh, hd), dtype=dtype, device=device),
        "len": torch.tensor(0, dtype=torch.int32, device=device),
    }
