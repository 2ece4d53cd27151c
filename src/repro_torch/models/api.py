"""Public model API: the twin of ``repro.models.api``.

  build_params(cfg, generator, device, dtype) -> model (seeded init)
  forward(params, batch, cfg, mode, caches)   -> (logits, aux, new_caches)
  init_caches(cfg, batch, max_len, device)    -> decode caches
  grow_caches(cfg, caches, max_len)           -> caches padded to max_len
  input_specs(cfg, shape)                     -> {name: TensorSpec}
  synthesize_batch(cfg, shape, generator)     -> a random batch of them

Families: dense / moe / vlm -> ``transformer``; hybrid (zamba2) ->
``zamba``; xlstm -> ``xlstm_lm``; audio (whisper) -> ``whisper``.  The
modality frontends are stubs, as in the JAX package: a vlm batch
carries patch embeddings, an audio batch frame embeddings
(``input_specs``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.  ``long_context`` gives zamba2's shared
attention a window of ``ZAMBA_LONG_WINDOW`` keys (its caches a ring of
that many slots), as in the JAX package's long-context cell.  Int8 KV
caches (``kv_quant``) raise ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import bridge
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer, whisper, xlstm_lm, zamba
from repro_torch.models.common import dtype_of
from repro_torch.models.params import Model

# the windowed shared attention's width for zamba2's long-context cell
ZAMBA_LONG_WINDOW = 4096


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
    the dense, MoE, vlm and hybrid families `remat` is 'full', 'dots' or
    'none', as in ``repro.models.api.forward`` (per layer, and per group
    of Mamba blocks and the shared block for the hybrid); the xlstm and
    audio families, as there, recompute a block (a decoder layer) under
    'full' only.  `long_context`: zamba2's shared attention windowed to
    ``ZAMBA_LONG_WINDOW`` (other families ignore it, as in JAX)."""
    bridge.model_class(cfg)             # other families raise
    if mode == "chunk" and not supports_chunked_prefill(cfg):
        raise NotImplementedError(
            f"chunked prefill is not supported for family {cfg.family!r}")
    if rows is not None and cfg.family in ("xlstm", "audio"):
        raise NotImplementedError(
            f"per-slot writes (rows) for family {cfg.family!r}: the "
            "serving engine does not run it, in either package")
    with contextlib.nullcontext() if mode == "train" else torch.no_grad():
        if cfg.family == "hybrid":
            return zamba.zamba_forward(
                params, batch, cfg, mode=mode, caches=caches, rows=rows,
                remat=remat,
                window_override=ZAMBA_LONG_WINDOW if long_context else None)
        if cfg.family == "xlstm":
            return xlstm_lm.xlstm_lm_forward(params, batch, cfg, mode=mode,
                                             caches=caches, remat=remat)
        if cfg.family == "audio":
            return whisper.whisper_forward(params, batch, cfg, mode=mode,
                                           caches=caches, remat=remat)
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
    at 1, behind the stacked-layer axis.  `long_context`: zamba2's
    shared-attention caches are rings of ``min(max_len,
    ZAMBA_LONG_WINDOW)`` slots."""
    bridge.model_class(cfg)             # other families raise
    if kv_quant:
        raise NotImplementedError(
            "int8 KV caches (kv_quant) come with a later slice of the port")
    dt = dtype or dtype_of(cfg.dtype)
    dev = resolve_device(device)
    if cfg.family == "hybrid":
        return zamba.init_zamba_caches(
            cfg, batch, max_len, dtype=dt, device=dev,
            window=ZAMBA_LONG_WINDOW if long_context else None)
    if cfg.family == "xlstm":
        return xlstm_lm.init_xlstm_caches(cfg, batch, dtype=dt, device=dev)
    if cfg.family == "audio":
        return whisper.init_whisper_caches(cfg, batch, max_len, dtype=dt,
                                           device=dev)
    return transformer.init_lm_caches(cfg, batch, max_len, dtype=dt,
                                      device=dev)


class TensorSpec(NamedTuple):
    """The shape and dtype of one model input (``jax.ShapeDtypeStruct``
    in the JAX package)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, TensorSpec]:
    """Every model input of a cell, as ``repro.models.api.input_specs``:

    train:   tokens [B,S] + labels [B,S] (+ stub frontend embeddings)
    prefill: tokens [B,S]                (+ stub frontend embeddings)
    decode:  tokens [B,1]

    A vlm batch's text is seq_len - num_patch_tokens long, so seq_len is
    the whole context the backbone sees; an audio batch carries
    encoder_ctx frames."""
    B, S = shape.global_batch, shape.seq_len
    dt = dtype_of(cfg.dtype)
    tok = torch.int32
    if shape.kind == "decode":
        return {"tokens": TensorSpec((B, 1), tok)}
    specs: Dict[str, TensorSpec] = {}
    if cfg.family == "vlm":
        specs["tokens"] = TensorSpec((B, S - cfg.num_patch_tokens), tok)
        specs["patch_embeds"] = TensorSpec(
            (B, cfg.num_patch_tokens, cfg.d_model), dt)
    elif cfg.family == "audio":
        specs["tokens"] = TensorSpec((B, S), tok)
        specs["frames"] = TensorSpec((B, cfg.encoder_ctx, cfg.d_model), dt)
    else:
        specs["tokens"] = TensorSpec((B, S), tok)
    if shape.kind == "train":
        specs["labels"] = TensorSpec((B, S), tok)
    return specs


def synthesize_batch(cfg: ModelConfig, shape: ShapeConfig,
                     generator: Optional[torch.Generator] = None, *,
                     device: DeviceLike = None
                     ) -> Dict[str, torch.Tensor]:
    """A random batch matching ``input_specs``, drawn in order from
    `generator` (seed 0 on `device` when None): token ids uniform in
    [0, vocab), embeddings N(0, 1) in fp32, then cast."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, s in input_specs(cfg, shape).items():
        if s.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, s.shape,
                                      generator=generator, device=dev,
                                      dtype=s.dtype)
        else:
            out[name] = torch.randn(s.shape, generator=generator,
                                    device=dev).to(s.dtype)
    return out


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
