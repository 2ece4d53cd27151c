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
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models import xlstm
from repro_torch.models.common import add_rmsnorm, embed_lookup, padded_vocab
from repro_torch.models.transformer import REMAT, remat_call


def layer_kinds(cfg: ModelConfig) -> List[str]:
    pat = cfg.xlstm_pattern or ("m",)
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def xlstm_lm_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """``init_xlstm_lm``."""
    d = cfg.d_model
    spec: Dict[str, Any] = {
        "embed": P.Leaf((padded_vocab(cfg.vocab_size), d), "embed"),
        "final_norm": P.ones(d)}
    for i, kind in enumerate(layer_kinds(cfg)):
        spec[f"layer_{i:02d}"] = {
            "norm": P.ones(d),
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
    tokens = batch["tokens"].to(params.device).long()
    x = embed_lookup(params.embed, tokens)
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
        x, h = add_rmsnorm(x, y, lp.norm, cfg.norm_eps)
        y, new_caches[name] = fwd(
            lp.cell, h, cfg, mode=mode,
            cache=None if caches is None else caches.get(name))
    _, x = add_rmsnorm(x, y, params.final_norm, cfg.norm_eps)
    logits = x @ params.embed.T                 # tied head
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, (new_caches or None)


def _train_block(x, y, lp, fwd, cfg: ModelConfig):
    """One block in mode 'train': y (the branch before) is added by the
    norm's kernel.  Returns (x, the block's branch)."""
    x, h = add_rmsnorm(x, y, lp.norm, cfg.norm_eps)
    return x, fwd(lp.cell, h, cfg, mode="train")[0]


def init_xlstm_caches(cfg: ModelConfig, batch: int, *, dtype: torch.dtype,
                      device: torch.device) -> Dict[str, Any]:
    return {f"layer_{i:02d}": (
        xlstm.init_mlstm_cache(cfg, batch, dtype, device) if kind == "m"
        else xlstm.init_slstm_cache(cfg, batch, device))
        for i, kind in enumerate(layer_kinds(cfg))}
