"""Decoder-only transformer, dense family: the twin of
``repro.models.transformer``.

Parameters keep the JAX tree's stacked layout: every per-layer leaf of
``stage1`` has a leading [L] axis, and ``lax.scan`` over the stack
becomes a Python loop over that axis.  In the 'decode' and 'chunk'
modes each layer writes its slice of the stacked KV cache IN PLACE (the
JAX scan carries the cache and returns an updated copy); 'prefill'
returns a new stacked cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention
from repro_torch.models.common import padded_vocab, rmsnorm
from repro_torch.models.mlp import mlp_forward

STAGE = "stage1"


def _param(*shape: int, dtype: torch.dtype,
           device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DenseStage(nn.Module):
    """A homogeneous stack of `n` pre-norm decoder layers, leaves [n, ...]:
    norm1, norm2, attn/{wq,wk,wv,wo}, mlp/{w_gate,w_up,w_down}."""

    def __init__(self, cfg: ModelConfig, n: int, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        hq, kv, hd = attention.attn_dims(cfg)
        P = dict(dtype=dtype, device=device)
        self.n = n
        self.norm1 = _param(n, d, **P)
        self.norm2 = _param(n, d, **P)
        attn = {"wq": _param(n, d, hq * hd, **P),
                "wk": _param(n, d, kv * hd, **P),
                "wv": _param(n, d, kv * hd, **P),
                "wo": _param(n, hq * hd, d, **P)}
        if cfg.qkv_bias:
            attn.update(bq=_param(n, hq * hd, **P), bk=_param(n, kv * hd, **P),
                        bv=_param(n, kv * hd, **P))
        self.attn = nn.ParameterDict(attn)
        self.mlp = nn.ParameterDict({"w_gate": _param(n, d, f, **P),
                                     "w_up": _param(n, d, f, **P),
                                     "w_down": _param(n, f, d, **P)})


class DenseLM(nn.Module):
    """Dense decoder LM: embed [Vp,d], final_norm [d], lm_head [d,Vp]
    (absent when tied) and one DenseStage ``stage1``."""

    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (the port runs "
                "the dense family; MoE, hybrid-SSM and the other families "
                "come with later slices)")
        vp = padded_vocab(cfg.vocab_size)
        P = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.embed = _param(vp, cfg.d_model, **P)
        self.final_norm = _param(cfg.d_model, **P)
        if not cfg.tie_embeddings:
            self.lm_head = _param(cfg.d_model, vp, **P)
        setattr(self, STAGE, DenseStage(cfg, cfg.num_layers, **P))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def lm_forward(params: DenseLM, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, *, mode: str = "train",
               caches: Optional[Dict[str, Any]] = None,
               rows: Optional[torch.Tensor] = None):
    """Returns (logits [B,S,Vp], aux_loss, new_caches).

    mode 'decode': tokens [B,1], positions from caches["len"].
    mode 'chunk': tokens [B,C], token i at caches["len"] + i (ragged).
    Both write the caches in place, for the slot ids in `rows` (all when
    None); the returned dict holds the same tensors and the new len.
    """
    tokens = batch["tokens"].to(params.device).long()
    B, S = tokens.shape
    x = params.embed[tokens]
    dev = x.device
    stage: DenseStage = getattr(params, STAGE)

    lens = None
    if mode in ("decode", "chunk"):
        if caches is None:
            raise ValueError(f"mode {mode!r} needs caches")
        lens = torch.as_tensor(caches["len"], device=dev).expand(B)
        kv = caches[STAGE]
        smax = kv["k"].shape[2]
        wdw = cfg.sliding_window
        attention.check_cache_bounds(
            lens, S if mode == "chunk" else 1, smax, rows,
            ring=mode == "decode" and wdw is not None and smax == wdw)
    if mode == "decode":
        positions = lens.reshape(B, 1)
    elif mode == "chunk":
        positions = lens[:, None] + torch.arange(S, device=dev)[None, :]
    else:
        positions = torch.arange(S, device=dev).expand(B, S)

    new_k, new_v = [], []
    for i in range(stage.n):
        cache = None
        if lens is not None:
            cache = {"k": kv["k"][i], "v": kv["v"][i], "len": lens}
        h = rmsnorm(x, stage.norm1[i], cfg.norm_eps)
        lp_attn = {name: w[i] for name, w in stage.attn.items()}
        h, nc = attention.attn_forward(lp_attn, h, positions, cfg=cfg,
                                       mode=mode, cache=cache, rows=rows)
        x = x + h
        h2 = rmsnorm(x, stage.norm2[i], cfg.norm_eps)
        lp_mlp = {name: w[i] for name, w in stage.mlp.items()}
        x = x + mlp_forward(lp_mlp, h2)
        if mode == "prefill":
            new_k.append(nc["k"])
            new_v.append(nc["v"])

    new_caches = None
    if mode == "prefill":
        new_caches = {STAGE: {"k": torch.stack(new_k),
                              "v": torch.stack(new_v)},
                      "len": torch.tensor(S, dtype=torch.int32, device=dev)}
    elif lens is not None:
        step = 1 if mode == "decode" else S
        new_caches = {STAGE: kv, "len": (lens + step).to(torch.int32)}

    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x @ head
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return logits, aux, new_caches


def init_lm_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                   dtype: torch.dtype, device: torch.device
                   ) -> Dict[str, Any]:
    one = attention.init_kv_cache(cfg, batch, max_len, dtype=dtype,
                                  device=device)
    n = cfg.num_layers
    return {"len": one["len"],
            STAGE: {k: torch.zeros((n,) + tuple(one[k].shape), dtype=dtype,
                                   device=device) for k in ("k", "v")}}
