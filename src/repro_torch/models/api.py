"""Public model API: the twin of ``repro.models.api`` for the dense, MoE
and hybrid-SSM families.

  build_params(cfg, generator, device, dtype) -> model (seeded init)
  forward(params, batch, cfg, mode, caches)   -> (logits, aux, new_caches)
  init_caches(cfg, batch, max_len, device)    -> stacked decode caches
  grow_caches(cfg, caches, max_len)           -> caches padded to max_len

Families: dense / moe -> ``transformer``; hybrid (zamba2) -> ``zamba``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The other families, int8 KV caches (``kv_quant``) and the windowed
shared attention of ``long_context`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import bridge
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer, zamba
from repro_torch.models.common import dtype_of
from repro_torch.models.params import Model


def build_params(cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None, *,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None) -> Model:
    """Random weights with the JAX package's scales, from `generator`
    (seed 0 on `device` when None).  The numbers differ from
    ``repro.models.api.build_params``; load those with
    ``bridge.from_numpy`` to compare like with like."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return bridge.init_params(cfg, generator, device=dev,
                              dtype=dtype or dtype_of(cfg.dtype))


def forward(params: Model, batch: Dict[str, Any], cfg: ModelConfig, *,
            mode: str = "train", caches: Optional[Dict[str, Any]] = None,
            rows: Optional[torch.Tensor] = None,
            long_context: bool = False, remat: str = "full"):
    """Returns (logits, aux_loss, new_caches).  'chunk' and 'decode'
    write `caches` in place for the slot ids in `rows` (all when None).
    'train' runs with autograd (the other modes under ``no_grad``); for
    the dense and MoE families `remat` is 'full', 'dots' or 'none', as
    in ``repro.models.api.forward``."""
    bridge.model_class(cfg)             # other families raise
    if mode == "chunk" and not supports_chunked_prefill(cfg):
        raise NotImplementedError(
            f"chunked prefill is not supported for family {cfg.family!r}")
    if long_context:
        raise NotImplementedError(
            "long_context (zamba2's windowed shared attention) comes with "
            "a later slice of the port")
    with contextlib.nullcontext() if mode == "train" else torch.no_grad():
        if cfg.family == "hybrid":
            return zamba.zamba_forward(params, batch, cfg, mode=mode,
                                       caches=caches, rows=rows)
        return transformer.lm_forward(params, batch, cfg, mode=mode,
                                      caches=caches, rows=rows, remat=remat)


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """True when `forward(..., mode="chunk")` works for this config (the
    positional-KV-cache families, as in the JAX package)."""
    return cfg.family in ("dense", "moe")


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None,
                long_context: bool = False,
                kv_quant: bool = False) -> Dict[str, Any]:
    """Decode caches; every leaf but ``len`` has its batch (slot) axis
    at 1, behind the stacked-layer axis."""
    bridge.model_class(cfg)             # other families raise
    if kv_quant:
        raise NotImplementedError(
            "int8 KV caches (kv_quant) come with a later slice of the port")
    if long_context:
        raise NotImplementedError(
            "long_context caches (zamba2's windowed shared attention) come "
            "with a later slice of the port")
    dt = dtype or dtype_of(cfg.dtype)
    dev = resolve_device(device)
    if cfg.family == "hybrid":
        return zamba.init_zamba_caches(cfg, batch, max_len, dtype=dt,
                                       device=dev)
    return transformer.init_lm_caches(cfg, batch, max_len, dtype=dt,
                                      device=dev)


def grow_caches(cfg: ModelConfig, caches: Dict[str, Any],
                max_len: int) -> Dict[str, Any]:
    """Pad prefill-returned KV caches (capacity == prompt length) out to
    `max_len` on the sequence axis (the axis right of the batch axis);
    recurrent-state leaves pass through unchanged."""
    def grow(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = grow(leaf)
            elif name in ("k", "v") and leaf.dim() >= 4:
                seq_ax = leaf.dim() - 3
                pad = max_len - leaf.shape[seq_ax]
                if pad > 0:
                    widths = [0, 0] * (leaf.dim() - seq_ax - 1) + [0, pad]
                    leaf = F.pad(leaf, widths)
                out[name] = leaf
            else:
                out[name] = leaf
        return out
    return grow(caches)
