"""Public model API, dense subset: the twin of ``repro.models.api``.

  build_params(cfg, generator, device, dtype) -> DenseLM (seeded init)
  forward(params, batch, cfg, mode, caches)   -> (logits, aux, new_caches)
  init_caches(cfg, batch, max_len, device)    -> stacked KV caches
  grow_caches(cfg, caches, max_len)           -> caches padded to max_len

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Other families, int8 KV caches (``kv_quant``) and ``long_context`` come
with later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import bridge
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import dtype_of


def build_params(cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None, *,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None
                 ) -> transformer.DenseLM:
    """Random weights with the JAX package's scales, from `generator`
    (seed 0 on `device` when None).  The numbers differ from
    ``repro.models.api.build_params``; load those with
    ``bridge.from_numpy`` to compare like with like."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return bridge.init_params(cfg, generator, device=dev,
                              dtype=dtype or dtype_of(cfg.dtype))


def forward(params: transformer.DenseLM, batch: Dict[str, Any],
            cfg: ModelConfig, *, mode: str = "train",
            caches: Optional[Dict[str, Any]] = None,
            rows: Optional[torch.Tensor] = None):
    """Returns (logits, aux_loss, new_caches).  'chunk' and 'decode'
    write `caches` in place for the slot ids in `rows` (all when None)."""
    if mode == "chunk" and not supports_chunked_prefill(cfg):
        raise NotImplementedError(
            f"chunked prefill is not supported for family {cfg.family!r}")
    with torch.no_grad():
        return transformer.lm_forward(params, batch, cfg, mode=mode,
                                      caches=caches, rows=rows)


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """True when `forward(..., mode="chunk")` works for this config (the
    positional-KV-cache families, as in the JAX package)."""
    return cfg.family in ("dense", "moe")


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None,
                long_context: bool = False,
                kv_quant: bool = False) -> Dict[str, Any]:
    if kv_quant:
        raise NotImplementedError(
            "int8 KV caches (kv_quant) come with a later slice of the port")
    if long_context:
        raise NotImplementedError(
            "long_context caches come with the hybrid-SSM slice")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: this slice runs "
            "the dense family")
    return transformer.init_lm_caches(cfg, batch, max_len,
                                      dtype=dtype or dtype_of(cfg.dtype),
                                      device=resolve_device(device))


def grow_caches(cfg: ModelConfig, caches: Dict[str, Any],
                max_len: int) -> Dict[str, Any]:
    """Pad prefill-returned KV caches (capacity == prompt length) out to
    `max_len` on the sequence axis (the axis right of the batch axis)."""
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
