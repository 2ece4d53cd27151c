"""Decoder-only transformer, dense, MoE and VLM-backbone families: the
twin of ``repro.models.transformer``.

Parameters keep the JAX tree's layout: one stacked stage per entry of
``stage_plan`` (DeepSeek-MoE's first-k-dense gives a dense ``stage0``
with ``dense_d_ff`` before the MoE ``stage1``), every per-layer leaf
with a leading [L] axis; ``lax.scan`` over a stack becomes a Python
loop over that axis.  In the 'decode' and 'chunk' modes each layer
writes its slice of the stacked KV cache IN PLACE (the JAX scan carries
the cache and returns an updated copy); 'prefill' returns a new stacked
cache.  The MoE layers' aux losses are summed over layers and stages.

'train' runs with autograd: the layer weights are views from one
``torch.unbind`` per stacked leaf, the embedding lookup has a
deterministic backward (``common.embed_lookup``), and ``remat`` follows
``repro.models.transformer._block``: 'full' recomputes each block in the
backward (``torch.utils.checkpoint``, non-reentrant), 'dots' does too
but keeps the outputs of the plain matrix products (the policy of
``dots_with_no_batch_dims_saveable``), 'none' keeps every activation.

Placed parameters (DTensors, ``ParamTree.place``) run the partitioned
step under ``sharding.axis_rules``, with the JAX package's constraints:
the embedding's vocab-parallel partial sum and each block's output are
reduced onto the residual's layout (("batch", "seq", "act_embed") at
each norm; under the MoE train cells' ``seq_shard`` the sequence rides
``model``, and attention, the MLP and the logits gather it whole
first, while the MoE layer's a2a path takes it as its blocks), the
logits are vocab-sharded (("batch", None, "vocab")), a
prefill's caches are placed by the cache rules (``kv_seq`` over
``model``).  The inputs are placed by ("batch", ...) when they come
plain.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention
from repro_torch.models import params as P
from repro_torch.models.common import (add_rmsnorm, embed_lookup,
                                       padded_vocab, stack_layers)
from repro_torch.models.mlp import mlp_forward
from repro_torch.models.moe import moe_forward, moe_spec


def stage_plan(cfg: ModelConfig) -> List[Tuple[str, int, str,
                                              Optional[int]]]:
    """[(stage_name, num_layers, kind, dense_ff)], as ``_stage_plan``."""
    if cfg.is_moe and cfg.moe.first_k_dense:
        return [("stage0", cfg.moe.first_k_dense, "dense",
                 cfg.moe.dense_d_ff),
                ("stage1", cfg.num_layers - cfg.moe.first_k_dense, "moe",
                 None)]
    return [("stage1", cfg.num_layers, "moe" if cfg.is_moe else "dense",
             None)]


def attention_spec(cfg: ModelConfig) -> Dict[str, P.Leaf]:
    """``repro.models.attention.init_attention``."""
    d = cfg.d_model
    hq, kv, hd = attention.attn_dims(cfg)
    qkv = ("embed", "qkv")                 # axes: ``attention_specs``
    spec = {"wq": P.dense(d, hq * hd, fan_in=d, axes=qkv),
            "wk": P.dense(d, kv * hd, fan_in=d, axes=qkv),
            "wv": P.dense(d, kv * hd, fan_in=d, axes=qkv),
            "wo": P.dense(hq * hd, d, fan_in=hq * hd,
                          axes=("qkv", "embed"))}
    if cfg.qkv_bias:
        spec.update(bq=P.zeros(hq * hd, axes=("qkv",)),
                    bk=P.zeros(kv * hd, axes=("qkv",)),
                    bv=P.zeros(kv * hd, axes=("qkv",)))
    return spec


def layer_spec(cfg: ModelConfig, kind: str,
               dense_ff: Optional[int] = None) -> Dict[str, Any]:
    """``_init_layer``: pre-norms, attention and an MLP or MoE block."""
    d = cfg.d_model
    spec: Dict[str, Any] = {"norm1": P.norm(d), "norm2": P.norm(d),
                            "attn": attention_spec(cfg)}
    if kind == "moe":
        spec["moe"] = moe_spec(cfg)
    else:
        spec["mlp"] = P.mlp_spec(d, dense_ff or cfg.d_ff)
    return spec


def lm_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """``init_lm``: embed [Vp,d], final_norm [d], lm_head [d,Vp] (absent
    when tied) and the stacked stages."""
    vp, d = padded_vocab(cfg.vocab_size), cfg.d_model
    spec: Dict[str, Any] = {"embed": P.embed(vp, d),
                            "final_norm": P.norm(d)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = P.lm_head(d, vp)
    for name, n, kind, dff in stage_plan(cfg):
        spec[name] = P.Stack(n, layer_spec(cfg, kind, dff))
    return spec


class DecoderLM(P.Model):
    """Dense or MoE decoder LM (the tree of ``transformer.init_lm``)."""

    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: torch.device):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"DecoderLM runs the dense, moe and vlm "
                             f"families, not {cfg.family!r}")
        super().__init__(lm_spec(cfg), cfg, dtype=dtype, device=device)


REMAT = ("full", "dots", "none")


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat 'dots': keep the outputs of
    the 2-D matrix products (x @ W), recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


RESIDUAL = ("batch", "seq", "act_embed")


def add_norm(x, y, scale, eps):
    """``add_rmsnorm`` on the residual stream: the pending branch output
    y (a partial sum in a partitioned step) is constrained onto the
    residual's layout first, and so is the sum, as the JAX block
    constrains x + y."""
    if y is not None:
        y = shd.constrain(y, RESIDUAL)
    x, h = add_rmsnorm(x, y, scale, eps)
    return shd.constrain(x, RESIDUAL), h


def _block(x, y, lp, positions, cfg: ModelConfig, kind: str, mode: str,
           cache=None, keep=None):
    """One layer: the pending residual y is added by norm1's kernel.
    Returns (x, y, aux or None, new_cache)."""
    x, h = add_norm(x, y, lp["norm1"], cfg.norm_eps)
    h, nc = attention.attn_forward(lp["attn"], h, positions, cfg=cfg,
                                   mode=mode, cache=cache, keep=keep)
    x, h2 = add_norm(x, h, lp["norm2"], cfg.norm_eps)
    if kind == "moe":
        y, aux = moe_forward(lp["moe"], h2, cfg)
    else:
        y, aux = mlp_forward(lp["mlp"], h2), None
    return x, y, aux, nc


def remat_call(run, remat: str, *args):
    """``run(*args)`` under `remat`: 'none' as it is, 'full' recomputed
    in the backward (``torch.utils.checkpoint``, non-reentrant), 'dots'
    too but keeping the outputs of the plain matrix products.  The
    recompute runs under the sharding rules active now: the autograd
    engine runs a CUDA backward on a thread of its own, which does not
    see this thread's ``sharding.axis_rules``."""
    if remat == "none":
        return run(*args)
    ctx = shd.current_context()
    if ctx is not None:
        body = run

        def run(*a):
            with shd.axis_rules(*ctx):
                return body(*a)
    kw = {} if remat == "full" else {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, _save_matmuls)}
    return ckpt.checkpoint(run, *args, use_reentrant=False, **kw)


def _train_block(x, y, lp, positions, cfg, kind, remat):
    def run(x, y, lp, positions):
        return _block(x, y, lp, positions, cfg, kind, "train")[:3]
    return remat_call(run, remat, x, y, lp, positions)


def lm_forward(params: DecoderLM, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, *, mode: str = "train",
               caches: Optional[Dict[str, Any]] = None,
               rows: Optional[torch.Tensor] = None, remat: str = "full"):
    """Returns (logits [B,S,Vp], aux_loss, new_caches).

    batch: {"tokens": [B,St]}, and for the vlm family in 'train' and
    'prefill' "patch_embeds" [B,P,d], which go before the tokens (S =
    P + St; decode positions count them).
    mode 'decode': tokens [B,1], positions from caches["len"].
    mode 'chunk': tokens [B,C], token i at caches["len"] + i (ragged).
    Both write the caches in place for the slot ids in `rows` (all when
    None); every slot still attends over its own new keys.  The returned
    dict holds the same tensors and the new len.
    mode 'train': autograd through every layer, `remat` one of REMAT.
    Placed parameters: the partitioned step (module docstring).
    """
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    placed = shd.is_placed(params.embed)
    if placed:
        batch = _placed_inputs(batch, rows)
    tokens = batch["tokens"].to(params.device).long()
    x = shd.constrain(embed_lookup(params.embed, tokens),
                      ("batch", None, "act_embed"))
    if cfg.family == "vlm" and mode not in ("decode", "chunk"):
        # the stub vision frontend's patch embeddings go first
        patches = batch["patch_embeds"].to(device=x.device, dtype=x.dtype)
        x = torch.cat([patches, x], dim=1)
    B, S = x.shape[:2]
    dev = x.device
    plan = stage_plan(cfg)

    lens = keep = None
    if mode in ("decode", "chunk"):
        if caches is None:
            raise ValueError(f"mode {mode!r} needs caches")
        lens = torch.as_tensor(caches["len"], device=dev).expand(B)
        smax = caches[plan[0][0]]["k"].shape[2]
        wdw = cfg.sliding_window
        attention.check_cache_bounds(
            lens, S if mode == "chunk" else 1, smax, rows,
            ring=mode == "decode" and wdw is not None and smax == wdw)
        keep = attention.other_rows(rows, B, dev)
    if mode == "decode":
        positions = lens.reshape(B, 1)
    elif mode == "chunk":
        positions = lens[:, None] + torch.arange(S, device=dev)[None, :]
    else:
        positions = torch.arange(S, device=dev).expand(B, S)
    if placed:
        positions = _rows_like(positions, x)

    aux = torch.zeros((), dtype=torch.float32, device=dev)
    new_caches: Dict[str, Any] = {}
    # each block's output y is added to the residual stream by the
    # kernel of the next norm (the next layer's norm1, or the final norm)
    y = None
    for name, _n, kind, _dff in plan:
        stage: P.ParamTree = params[name]
        new_k, new_v = [], []
        for i, lp in enumerate(stage.layers()):
            if mode == "train":
                x, y, aux_i = _train_block(x, y, lp, positions, cfg, kind,
                                           remat)
            else:
                cache = None
                if lens is not None:
                    cache = {n: t[i] for n, t in caches[name].items()}
                    cache["len"] = lens
                x, y, aux_i, nc = _block(x, y, lp, positions, cfg, kind,
                                         mode, cache, keep)
                if mode == "prefill":
                    new_k.append(nc["k"])
                    new_v.append(nc["v"])
            if aux_i is not None:
                aux = aux + aux_i
        if mode == "prefill":
            one = (B, S) + attention.attn_dims(cfg)[1:]
            new_caches[name] = {
                n: shd.constrain(stack_layers(t, one, x),
                                 (None, "batch", "kv_seq", None, None))
                for n, t in (("k", new_k), ("v", new_v))}
        elif lens is not None:
            new_caches[name] = caches[name]

    if mode == "prefill":
        new_caches["len"] = torch.tensor(S, dtype=torch.int32, device=dev)
    elif lens is not None:
        step = 1 if mode == "decode" else S
        new_caches["len"] = (lens + step).to(torch.int32)

    _, x = add_norm(x, y, params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    x = shd.replicate_dim(x, 1)          # seq_shard: the sequence whole
    logits = shd.constrain(x @ shd.gather_fsdp(head),
                           ("batch", None, "vocab"))
    return logits, aux, (new_caches or None)


def _placed_inputs(batch, rows):
    """The batch of a partitioned step: each plain leaf placed by
    ("batch", ...) under the active rules (placed leaves as they are)."""
    ctx = shd.current_context()
    if ctx is None:
        raise ValueError("placed parameters run under sharding.axis_rules "
                         "with the mesh they are placed on")
    if rows is not None:
        raise NotImplementedError("per-slot writes (rows) are not "
                                  "partitioned")
    mesh, rules = ctx
    plain = {k: v for k, v in batch.items() if not shd.is_placed(v)}
    axes = {k: ("batch",) + (None,) * (v.dim() - 1)
            for k, v in plain.items()}
    return {**batch, **shd.place(plain, axes, mesh, rules)}


def _rows_like(t: torch.Tensor, x) -> torch.Tensor:
    """A plain [B, ...] tensor (the positions) as a DTensor placed like
    placed x's rows: x's batch shards, whole elsewhere."""
    pl = [p if isinstance(p, shd.Shard) and p.dim == 0 else shd.Replicate()
          for p in x.placements]
    b0 = shd.local_offset(x, 0)
    return shd.from_local(t[b0:b0 + x.to_local().shape[0]].contiguous(), x,
                          pl)


def init_lm_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                   dtype: torch.dtype, device: torch.device,
                   quantized: bool = False) -> Dict[str, Any]:
    """Per stage, each cache leaf of ``attention.init_kv_cache`` stacked
    over its layers: [n, B, S, KV, D] k and v (int8 when `quantized`,
    with fp16 [n, B, S, KV] k_scale and v_scale)."""
    one = attention.init_kv_cache(cfg, batch, max_len, dtype=dtype,
                                  device=device, quantized=quantized)
    caches: Dict[str, Any] = {"len": one["len"]}
    for name, n, _kind, _dff in stage_plan(cfg):
        caches[name] = {k: torch.zeros((n,) + tuple(t.shape), dtype=t.dtype,
                                       device=device)
                        for k, t in one.items() if k != "len"}
    return caches
