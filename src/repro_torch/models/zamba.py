"""Zamba2 hybrid: a Mamba2 backbone with ONE weight-shared attention
block applied every `attn_every` Mamba blocks.  The twin of
``repro.models.zamba``.

81 Mamba blocks, attn_every=6 -> 13 groups of (6 mamba + shared attn)
plus a 3-block Mamba tail.  The shared block has a single parameter set
but 13 distinct KV caches: same weights, different activations.

The JAX scans over groups and blocks become Python loops.  'decode'
writes the SSM, conv and KV caches IN PLACE for the slot ids in `rows`
(all when None); 'prefill' returns new caches.  'train' runs with
autograd and, as ``repro.models.zamba`` does, checkpoints each group
(its Mamba blocks and the shared block) by `remat`
(``transformer.remat_call``: 'full', 'dots' or 'none'); the tail
blocks are not checkpointed.  The shared block's one parameter set
takes a gradient from every group.  `window_override` windows the
shared attention (the long-context cell, ``api.ZAMBA_LONG_WINDOW``):
the prefill masks it and returns full-length K/V; a decode cache of
exactly `window` slots is a ring (written at ``len % window``), any
other is written linearly with the window applied by the mask, as in
``repro.models.attention.cache_update``.

Placed parameters (DTensors) run the partitioned step under
``sharding.axis_rules``, as GSPMD partitions the JAX one: the inputs
are placed by ("batch", ...), the embedding is constrained to
("batch", None, "act_embed") (a train cell's ``act_shard``: the
residual's d_model over ``model``), every residual add and norm goes
through ``transformer.add_norm``, the Mamba2 mixers run on each rank's
SSM heads (``ssm._Placed``), the shared block through the
placed attention and MLP, the logits are vocab-sharded, and a
prefill's caches are placed by the cache rules (``_by_cache_rules``);
decode writes them in their local shards.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention, ssm
from repro_torch.models import params as P
from repro_torch.models.common import (embed_lookup, padded_vocab,
                                       stack_layers)
from repro_torch.models.mlp import mlp_forward
from repro_torch.models.transformer import (REMAT, _placed_inputs,
                                            _rows_like, add_norm,
                                            attention_spec, remat_call)


def plan(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(groups, group_size, tail), as ``_plan``."""
    g = cfg.attn_every
    n_groups = cfg.num_layers // g
    return n_groups, g, cfg.num_layers - n_groups * g


def zamba_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """``init_zamba``."""
    n_groups, g, tail = plan(cfg)
    d = cfg.d_model
    block = {"norm": P.norm(d), "mixer": ssm.mamba2_spec(cfg)}
    spec: Dict[str, Any] = {
        "embed": P.embed(padded_vocab(cfg.vocab_size), d),
        "blocks": P.Stack(n_groups * g, block),
        "shared": {"norm1": P.norm(d), "norm2": P.norm(d),
                   "attn": attention_spec(cfg),
                   "mlp": P.mlp_spec(d, cfg.d_ff)},
        "final_norm": P.norm(d),
        "lm_head": P.lm_head(d, padded_vocab(cfg.vocab_size)),
    }
    if tail:
        spec["tail"] = P.Stack(tail, block)
    return spec


class ZambaLM(P.Model):
    """The hybrid family's model (the tree of ``zamba.init_zamba``)."""

    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: torch.device):
        if cfg.family != "hybrid":
            raise ValueError(f"ZambaLM runs the hybrid family, not "
                             f"{cfg.family!r}")
        super().__init__(zamba_spec(cfg), cfg, dtype=dtype, device=device)


def _layer_cache(caches: Optional[Dict[str, Any]], part: str, i: int):
    """Layer i of the stacked cache tree `caches[part]` (views)."""
    if caches is None:
        return None
    return {name: leaf[i] for name, leaf in caches[part].items()}


def _mamba_block(bp: Mapping[str, Any], x, y, cfg, mode, cache, rows):
    """x + y (the branch before, None for the first block), then this
    block's norm and mixer: returns the new residual and its branch."""
    x, h = add_norm(x, y, bp["norm"], cfg.norm_eps)
    h, new_cache = ssm.mamba2_forward(bp["mixer"], h, cfg, mode=mode,
                                      cache=cache, rows=rows)
    return x, h, new_cache


def _shared_block(sp, x, y, positions, cfg, mode, kv_cache, keep, window):
    x, h = add_norm(x, y, sp["norm1"], cfg.norm_eps)
    h, new_kv = attention.attn_forward(sp["attn"], h, positions, cfg=cfg,
                                       mode=mode, cache=kv_cache, keep=keep,
                                       window=window)
    x, h = add_norm(x, h, sp["norm2"], cfg.norm_eps)
    return x, mlp_forward(sp["mlp"], h), new_kv


def _train_group(x, y, bps: List[Mapping[str, Any]], sp, positions,
                 cfg: ModelConfig, remat: str, window: Optional[int]):
    """One group in mode 'train': its Mamba blocks, then the shared
    block, checkpointed as a whole by `remat`.  Returns (x, y)."""
    def run(x, y, bps, sp, positions):
        for bp in bps:
            x, y, _ = _mamba_block(bp, x, y, cfg, "train", None, None)
        x, y, _ = _shared_block(sp, x, y, positions, cfg, "train", None,
                                None, window)
        return x, y
    return remat_call(run, remat, x, y, bps, sp, positions)


def _stack(trees, one: Dict[str, torch.Tensor]):
    """Stack per-layer cache trees shaped as `one` (a layer's)."""
    return {k: stack_layers([t[k] for t in trees], t1.shape, t1)
            for k, t1 in one.items()}


def _by_cache_rules(caches: Dict[str, Any]) -> Dict[str, Any]:
    """Placed caches constrained to the cache rules' layout
    (``api.cache_axes_of``)."""
    from repro_torch.models.api import cache_axes_of   # api imports us

    def one(tree, axes):
        return {k: one(v, axes[k]) if isinstance(v, dict)
                else shd.constrain(v, axes[k]) for k, v in tree.items()}
    return one(caches, cache_axes_of(caches))


def zamba_forward(params: ZambaLM, batch: Dict[str, Any], cfg: ModelConfig,
                  *, mode: str = "train",
                  caches: Optional[Dict[str, Any]] = None,
                  rows: Optional[torch.Tensor] = None, remat: str = "full",
                  window_override: Optional[int] = None):
    """Returns (logits, aux=0, new_caches).

    caches: {"mamba": stacked [G*g] tree, "tail": stacked [tail] tree,
             "kv": stacked [G] {"k", "v"}, "len": int32 (scalar or [B])}
    mode 'train': autograd, each group checkpointed by `remat` (one of
    ``transformer.REMAT``).  `window_override`: the shared attention's
    sliding window (None: the config's).
    """
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    n_groups, g, tail = plan(cfg)
    placed = shd.is_placed(params.embed)
    if placed:
        batch = _placed_inputs(batch, rows)
    tokens = batch["tokens"].to(params.device).long()
    B, S = tokens.shape
    x = shd.constrain(embed_lookup(params.embed, tokens),
                      ("batch", None, "act_embed"))
    dev = x.device
    keep = None
    if mode == "decode":
        if caches is None:
            raise ValueError("mode 'decode' needs caches")
        lens = torch.as_tensor(caches["len"], device=dev).expand(B)
        smax = caches["kv"]["k"].shape[2]
        wdw = (window_override if window_override is not None
               else cfg.sliding_window)
        attention.check_cache_bounds(lens, 1, smax, rows, ring=smax == wdw)
        keep = attention.other_rows(rows, B, dev)
        positions = lens.reshape(B, 1)
    elif mode in ("prefill", "train"):
        positions = torch.arange(S, device=dev).expand(B, S)
    else:
        raise ValueError(f"unknown zamba mode {mode!r}")
    if placed:
        positions = _rows_like(positions, x)

    # each block's branch y is added to the residual stream by the kernel
    # of the next norm (the next block's, or the final norm)
    y = None
    new_mamba, new_kv = [], []
    blocks = params.blocks.layers()
    for gi in range(n_groups):
        if mode == "train":
            x, y = _train_group(x, y, blocks[gi * g:(gi + 1) * g],
                                params.shared, positions, cfg, remat,
                                window_override)
            continue
        for j in range(g):
            i = gi * g + j
            cache = _layer_cache(caches, "mamba", i)
            x, y, nc = _mamba_block(blocks[i], x, y, cfg, mode, cache, rows)
            new_mamba.append(nc)
        kv = None
        if caches is not None:
            kv = {"k": caches["kv"]["k"][gi], "v": caches["kv"]["v"][gi],
                  "len": caches["len"]}
        x, y, nkv = _shared_block(params.shared, x, y, positions, cfg, mode,
                                  kv, keep, window_override)
        new_kv.append(nkv)
    new_tail = []
    for i, bp in enumerate(params.tail.layers() if tail else ()):
        cache = _layer_cache(caches, "tail", i)
        x, y, nc = _mamba_block(bp, x, y, cfg, mode, cache, rows)
        new_tail.append(nc)

    _, x = add_norm(x, y, params.final_norm, cfg.norm_eps)
    logits = shd.constrain(x @ shd.gather_fsdp(params.lm_head),
                           ("batch", None, "vocab"))

    new_caches = None
    if mode == "prefill":
        prev = 0 if caches is None else caches["len"]
        one = ssm.init_ssm_cache(cfg, B, x.dtype, dev)
        kv_one = (B, S) + attention.attn_dims(cfg)[1:]
        new_caches = {
            "mamba": _stack(new_mamba, one),
            "kv": {k: stack_layers([c[k] for c in new_kv], kv_one, x)
                   for k in ("k", "v")}}
        if tail:
            new_caches["tail"] = _stack(new_tail, one)
        if placed:
            new_caches = _by_cache_rules(new_caches)
        new_caches["len"] = (torch.as_tensor(prev, device=dev)
                             + S).to(torch.int32)
    elif mode == "decode":
        new_caches = dict(caches, len=(lens + 1).to(torch.int32))
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return logits, aux, new_caches


def init_zamba_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                      dtype: torch.dtype, device: torch.device,
                      window: Optional[int] = None) -> Dict[str, Any]:
    """`window`: the shared attention's caches are rings of
    ``min(max_len, window)`` slots."""
    n_groups, g, tail = plan(cfg)

    def stack(tree, n):
        return {k: torch.zeros((n,) + tuple(t.shape), dtype=t.dtype,
                               device=device) for k, t in tree.items()}

    one_ssm = ssm.init_ssm_cache(cfg, batch, dtype, device)
    one_kv = attention.init_kv_cache(cfg, batch, max_len, dtype=dtype,
                                     device=device, window=window)
    caches = {"mamba": stack(one_ssm, n_groups * g),
              "kv": stack({k: one_kv[k] for k in ("k", "v")}, n_groups),
              "len": one_kv["len"]}
    if tail:
        caches["tail"] = stack(one_ssm, tail)
    return caches
