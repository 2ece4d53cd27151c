"""xLSTM language model: the twin of ``repro.models.xlstm_lm`` — embed,
pattern-cycled {mLSTM, sLSTM} blocks, tied head.

The block pattern ('m' * 7 + 's' for xlstm-125m) is cycled over the
layers (``layer_kinds``); each layer is its own unstacked sub-tree
``layer_NN`` = {"norm", "cell"}, as in the JAX tree.  Recurrent state is
O(1) in sequence length.  Caches: {"layer_NN": that cell's cache}.  As
elsewhere in the port, each block's residual branch is added by the
next norm's kernel.  'train' runs with autograd (the cells' backward is
PyTorch's autograd of their plain code, as the JAX package's is JAX's
of its ``lax.scan``s) and, as ``repro.models.xlstm_lm`` does,
recomputes each block in the backward under remat 'full' only.

A placed model (DTensors, ``ParamTree.place``) runs the partitioned
step under ``sharding.axis_rules``, with the JAX package's constraints:
the embedding's vocab-parallel partial sum reduced onto the residual's
layout (("batch", None, "act_embed")), each block's branch reduced (an
mLSTM's partial sum over ``model``) or gathered (an sLSTM's output
over ``model``) onto it at the next norm (``transformer.add_norm``),
the tied head's logits vocab-sharded (("batch", None, "vocab")); the
cells run partitioned (``xlstm``'s module docstring) and return their
caches placed by the cache rules.  The inputs are placed by ("batch",
...) when they come plain.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import params as P
from repro_torch.models import xlstm
from repro_torch.models.common import embed_lookup, padded_vocab
from repro_torch.models.transformer import (REMAT, _placed_inputs, add_norm,
                                            remat_call)


def layer_kinds(cfg: ModelConfig) -> List[str]:
    pat = cfg.xlstm_pattern or ("m",)
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def xlstm_lm_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """``init_xlstm_lm``."""
    d = cfg.d_model
    spec: Dict[str, Any] = {
        "embed": P.embed(padded_vocab(cfg.vocab_size), d),
        "final_norm": P.norm(d)}
    for i, kind in enumerate(layer_kinds(cfg)):
        spec[f"layer_{i:02d}"] = {
            "norm": P.norm(d),
            "cell": (xlstm.mlstm_spec(cfg) if kind == "m"
                     else xlstm.slstm_spec(cfg))}
    return spec


class XlstmLM(P.Model):
    """The xlstm family's model (the tree of ``init_xlstm_lm``)."""

    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: torch.device):
        if cfg.family != "xlstm":
            raise ValueError(f"XlstmLM runs the xlstm family, not "
                             f"{cfg.family!r}")
        super().__init__(xlstm_lm_spec(cfg), cfg, dtype=dtype, device=device)


def xlstm_lm_forward(params: XlstmLM, batch: Dict[str, Any],
                     cfg: ModelConfig, *, mode: str = "train",
                     caches: Optional[Dict[str, Any]] = None,
                     remat: str = "full"):
    """Returns (logits [B,S,Vp], aux=0, new_caches): the cells' new
    states in 'prefill' and 'decode', None in 'train'.  `remat` (one of
    ``transformer.REMAT``): 'full' checkpoints each block in 'train';
    'dots' and 'none' keep every activation, as in the JAX package."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown xlstm mode {mode!r}")
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    if mode == "decode" and caches is None:
        raise ValueError("mode 'decode' needs caches")
    if shd.is_placed(params.embed):
        batch = _placed_inputs(batch, None)
    tokens = batch["tokens"].to(params.device).long()
    x = shd.constrain(embed_lookup(params.embed, tokens),
                      ("batch", None, "act_embed"))
    new_caches: Dict[str, Any] = {}
    y = None
    for i, kind in enumerate(layer_kinds(cfg)):
        name = f"layer_{i:02d}"
        lp = params[name]
        fwd = xlstm.mlstm_forward if kind == "m" else xlstm.slstm_forward
        if mode == "train":
            # the JAX forward checkpoints a block under 'full' only
            x, y = remat_call(_train_block,
                              "full" if remat == "full" else "none",
                              x, y, lp, fwd, cfg)
            continue
        x, h = add_norm(x, y, lp.norm, cfg.norm_eps)
        y, new_caches[name] = fwd(
            lp.cell, h, cfg, mode=mode,
            cache=None if caches is None else caches.get(name))
    _, x = add_norm(x, y, params.final_norm, cfg.norm_eps)
    logits = shd.constrain(x @ shd.gather_fsdp(params.embed).T,  # tied head
                           ("batch", None, "vocab"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, (new_caches or None)


def _train_block(x, y, lp, fwd, cfg: ModelConfig):
    """One block in mode 'train': y (the branch before) is added by the
    norm's kernel.  Returns (x, the block's branch)."""
    x, h = add_norm(x, y, lp.norm, cfg.norm_eps)
    return x, fwd(lp.cell, h, cfg, mode="train")[0]


def init_xlstm_caches(cfg: ModelConfig, batch: int, *, dtype: torch.dtype,
                      device: torch.device) -> Dict[str, Any]:
    return {f"layer_{i:02d}": (
        xlstm.init_mlstm_cache(cfg, batch, dtype, device) if kind == "m"
        else xlstm.init_slstm_cache(cfg, batch, device))
        for i, kind in enumerate(layer_kinds(cfg))}
