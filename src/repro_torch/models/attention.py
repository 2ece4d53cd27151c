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
CPU tensors.

Placed (DTensor) activations and weights run the partitioned form of
``attn_forward`` (``distributed/sharding.py``): x comes in with its
sequence whole (``seq_shard``'s residual, sequence-sharded over
``model``, is gathered first, as the heads ride that axis); q, k and v
are column-parallel and ``wo`` row-parallel, each weight's FSDP shards
gathered right before its product.  A projection whose column shards
cut heads (danube's 8 × 80 kv columns on a 16-way axis) is gathered
whole before its split into heads, as GSPMD gathers it.  The flash
kernel gets q sharded by heads and k / v by the rule of JAX's
``_constrain_blocks``: sharded when the kv heads divide the model axis,
else whole, each rank reading the kv heads its q heads need (the
kernel wrapper slices them).  Decode reads caches placed by the cache
rules (``kv_seq`` over ``model``: context-parallel): the new k / v are
written by the rank that holds their position, and the softmax over a
sequence-sharded cache takes its row max and sum, and its output, as
all-reduces over the ranks that hold the positions.  An int8 cache's
scales are placed as its sequence; the new k / v are quantized whole
and written with them, and the int8 kernel's split form exchanges the
row max, the sum of exponentials, the max |p·v_scale| and the int32
P·V sums between the ranks (``kernels/decode_q8``).  Cross attention
(`kv_override`, whisper's) takes the flash kernel on local heads in
'train' and 'prefill', and in 'decode' the same context-parallel
softmax over the cross caches, every frame valid.  'chunk' and
per-slot ``rows`` are not partitioned.

An int8 cache (``init_kv_cache(quantized=True)``: int8 k, v and fp16
per-(token, head) k_scale, v_scale) is decode-only, as in the JAX
package: the decode branch quantizes the new k (after RoPE) and v with
``quantize_kv``, writes payload and scales at the same ring-aware
positions and attends through the ``decode_attention_q8`` kernel
wrapper; 'chunk' on an int8 cache raises, and prefill returns a float
cache.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.decode_q8.ops import decode_attention_q8
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import common
from repro_torch.models.kv_quant import quantize_kv, valid_positions

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
                     window: Optional[int] = None, group=None,
                     start: int = 0, smax: Optional[int] = None
                     ) -> torch.Tensor:
    """q: [B,1,Hq,D]; caches: [B,Smax,KV,D]; cache_len: scalar or
    per-slot [B] length including the token being decoded.  A windowed
    cache with Smax == window is a ring: every slot is valid once
    full.

    Context-parallel (a partitioned decode): the caches are this rank's
    positions [start, start + their length) of a cache of `smax`, and
    the softmax's row max and sum, and the output, are all-reduced over
    `group`, the ranks that hold the other positions."""
    B, _, Hq, D = q.shape
    Sl, KV = k_cache.shape[1], k_cache.shape[2]
    G = Hq // KV
    scale = 1.0 / (D ** 0.5)
    lens = _lens(cache_len, B, q.device)
    qg = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    valid = valid_positions(lens, smax or Sl, window)
    if valid.shape[1] != Sl:
        valid = valid[:, start:start + Sl]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    if group is None:
        p = torch.softmax(s, dim=-1)
    else:                    # unnormalised: divided by the whole sum
        p = torch.exp(s - shd.all_reduce(s.amax(dim=-1), "max",
                                         group)[..., None])
        den = shd.all_reduce(p.sum(dim=-1), "sum", group)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    if group is not None:
        out = shd.all_reduce(out, "sum", group) / den[..., None]
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
    if not sel.numel():
        return
    top = sel.max()
    if top.device.type == "meta":      # the dry run: no values to check
        return
    if int(top) + new > smax:
        raise ValueError(f"cache write past capacity: len {int(top)}"
                         f" + {new} > {smax}")


# ---------------------------------------------------------------------------
# the partitioned form (DTensors)
# ---------------------------------------------------------------------------

def _split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """[B,S,n*hd] -> [B,S,n,hd]; a placed t whose column shards do not
    fall on whole heads is gathered whole first."""
    B, S = t.shape[:2]
    if shd.is_placed(t) and n % (t.shape[-1] // t.to_local().shape[-1]):
        t = shd.replicate_dim(t, -1)
    return t.reshape(B, S, n, hd)


def _local_rows(t: torch.Tensor, like) -> torch.Tensor:
    """The rows of a plain [B, ...] tensor that `like`'s shard holds."""
    b0 = shd.local_offset(like, 0)
    return t[b0:b0 + like.to_local().shape[0]]


def _write_placed(cache, k_new, v_new, pos) -> None:
    """Write [B,1,KV,D] k / v at global positions `pos` [B,1] into the
    placed caches [B,Smax,KV,D] (sequence sharded or whole), in place:
    each rank writes the positions its shard holds.  An int8 cache
    takes ``quantize_kv`` of the replicated new k and v, payload and
    fp16 scales [B,Smax,KV] (placed as k's sequence) alike."""
    kc = cache["k"]
    new = {"k": shd.replicate_dim(k_new, 2).to_local(),
           "v": shd.replicate_dim(v_new, 2).to_local()}
    if "k_scale" in cache:
        (new["k"], new["k_scale"]), (new["v"], new["v_scale"]) = (
            quantize_kv(new["k"]), quantize_kv(new["v"]))
    s0, sl = shd.local_offset(kc, 1), kc.to_local().shape[1]
    pos = _local_rows(pos, kc) - s0
    whole = sl == kc.shape[1]
    keep = (pos >= 0) & (pos < sl)
    pos = torch.clamp(pos, 0, sl - 1)
    b = torch.arange(pos.shape[0], device=pos.device)[:, None]
    for name, t in new.items():
        local = cache[name].to_local()
        t = t.to(local.dtype)
        if not whole:
            mask = keep.view(keep.shape + (1,) * (t.dim() - 2))
            t = torch.where(mask, t, local[b, pos])
        local[b, pos] = t


def _decode_placed(q, cache, lens, window):
    """Decode attention of placed q [B,1,Hq,D] over placed caches (an
    int8 cache through ``decode_attention_q8``): the kernel on local
    shards, context-parallel (over the mesh dim that shards the
    sequence) when the sequence is sharded."""
    q = shd.replicate_dim(q, 2)
    kc = cache["k"]
    local = {n: t.to_local() for n, t in cache.items()
             if n in ("k", "v", "k_scale", "v_scale")}
    group = None
    if local["k"].shape[1] != kc.shape[1]:
        seq_dims = [i for i, p in enumerate(kc.placements)
                    if isinstance(p, shd.Shard) and p.dim == 1]
        if len(seq_dims) != 1:
            raise NotImplementedError(f"a cache sequence sharded over "
                                      f"mesh dims {seq_dims}")
        group = kc.device_mesh.get_group(seq_dims[0])
    kw = dict(window=window, group=group, start=shd.local_offset(kc, 1),
              smax=kc.shape[1])
    lens = _local_rows(lens, kc)
    if "k_scale" in local:
        out = decode_attention_q8(q.to_local(), local, lens, **kw)
    else:
        out = decode_attention(q.to_local(), local["k"], local["v"], lens,
                               **kw)
    return shd.from_local(out, q)


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
    placed = shd.is_placed(x)
    if placed and (mode == "chunk" or keep is not None):
        raise NotImplementedError(
            "the partitioned attention runs train, prefill and decode, "
            "without per-slot rows")

    if placed:                  # the sequence whole: heads over model
        x = shd.replicate_dim(x, 1)
    q = x @ shd.gather_fsdp(p["wq"])
    if kv_override is None:
        k = x @ shd.gather_fsdp(p["wk"])
        v = x @ shd.gather_fsdp(p["wv"])
        if "bq" in p:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        k = _split_heads(k, kvh, hd)
        v = _split_heads(v, kvh, hd)
        if use_rope:
            k = common.apply_rope(k, positions, cfg.rope_theta)
    else:
        if "bq" in p:
            q = q + p["bq"]
        k, v = kv_override
    q = _split_heads(q, hq, hd)
    if use_rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)

    new_cache = cache
    if placed and mode == "decode" and kv_override is None:
        lens = _lens(cache["len"], B, positions.device)
        ring = wdw is not None and cache["k"].shape[1] == wdw
        _write_placed(cache, k, v,
                      _write_positions(lens, 1, cache["k"].shape[1], ring))
        out = _decode_placed(q, cache, lens + 1, wdw)
        new_cache = dict(cache, len=cache["len"] + S)
    elif mode in ("chunk", "decode") and kv_override is None:
        assert cache is not None
        quantized = "k_scale" in cache
        if quantized and mode == "chunk":
            raise ValueError("chunked prefill does not support int8 KV "
                             "caches (they are decode-only)")
        kc, vc = cache["k"], cache["v"]
        lens = _lens(cache["len"], B, kc.device)
        ring = mode == "decode" and wdw is not None and kc.shape[1] == wdw
        pos = _write_positions(lens, S, kc.shape[1], ring)
        names = ("k", "v", "k_scale", "v_scale") if quantized else ("k", "v")
        saved = None
        if keep is not None:
            saved = {n: cache[n][keep[:, None], pos[keep]].clone()
                     for n in names}
        new_k, new_v = k, v
        if quantized:
            (new_k, ks), (new_v, vs) = quantize_kv(k), quantize_kv(v)
            _write(cache["k_scale"], cache["v_scale"], ks, vs, pos, None)
        _write(kc, vc, new_k, new_v, pos, None)
        if mode == "chunk":
            out = chunk_attention(q, kc, vc, cache["len"], window=wdw)
        elif quantized:
            out = decode_attention_q8(q, cache, cache["len"] + 1, window=wdw)
        else:
            out = decode_attention(q, kc, vc, cache["len"] + 1, window=wdw)
        if saved is not None:
            for n in names:
                cache[n][keep[:, None], pos[keep]] = saved[n]
        new_cache = {n: cache[n] for n in names}
        new_cache["len"] = cache["len"] + S
    elif mode == "decode":
        # cross-attention while decoding: every encoder position
        if placed:
            full = torch.full((B,), k.shape[1], device=positions.device)
            out = _decode_placed(q, {"k": k, "v": v}, full, None)
        else:
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

    o = shd.constrain(out.reshape(B, S, hq * hd), ("batch", None, "qkv"))
    y = o @ shd.gather_fsdp(p["wo"])
    return y, new_cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  dtype: torch.dtype, device: torch.device,
                  window: Optional[int] = None,
                  quantized: bool = False) -> Dict[str, Any]:
    """A [batch, size, KV, D] cache; a windowed cache (`window`, else the
    config's `sliding_window`) is a ring of that many positions when
    that is shorter than max_len.  `quantized`: int8 k and v and fp16
    k_scale, v_scale [batch, size, KV] (decode only)."""
    _, kvh, hd = attn_dims(cfg)
    wdw = window if window is not None else cfg.sliding_window
    size = min(max_len, wdw) if wdw is not None else max_len
    kv_dtype = torch.int8 if quantized else dtype
    cache = {n: torch.zeros((batch, size, kvh, hd), dtype=kv_dtype,
                            device=device) for n in ("k", "v")}
    if quantized:
        cache.update({n: torch.zeros((batch, size, kvh), device=device,
                                     dtype=torch.float16)
                      for n in ("k_scale", "v_scale")})
    cache["len"] = torch.tensor(0, dtype=torch.int32, device=device)
    return cache
