"""Whisper-tiny encoder-decoder (audio family): the twin of
``repro.models.whisper``.

The conv / mel frontend is a stub, as in the JAX package: the batch
carries precomputed frame embeddings "frames" [B, encoder_ctx, d_model]
(``api.synthesize_batch`` draws them).  Positions are sinusoidal on
both sides, norms are scale-only RMS norms, the head is tied to the
embedding.  Encoder: ``encoder_layers`` bidirectional self-attention
layers over the frames (no rope), then ``enc_norm``.  Decoder:
``num_layers`` layers of causal self-attention, cross-attention on the
encoder's K/V (each decoder layer projects its own, ``_cross_kv``) and
a SwiGLU MLP.

The tree keeps the JAX paths and the stacked ``enc`` / ``dec`` leaves,
so ``bridge.from_numpy`` carries a JAX tree across.  Caches: "k", "v"
(self-attention, [L,B,Smax,KV,D]), "xk", "xv" (cross, [L,B,Ctx,KV,D])
and "len"; 'decode' writes the self-attention cache in place and reads
the cross K/V, 'prefill' returns new caches.  As elsewhere in the port,
each block's residual branch is added by the next norm's kernel.
'train' runs with autograd; as ``repro.models.whisper`` does, remat
'full' recomputes each decoder layer in the backward (the encoder is
not checkpointed), and the encoder's grads come through the
cross-attention's K and V projections.

Placed parameters (DTensors) run the partitioned step under
``sharding.axis_rules``, on the dense family's placed attention and
MLP: x and the logits constrained as the JAX forward constrains them
(("batch", None, "act_embed"), ("batch", None, "vocab")), each block's
output reduced onto the residual's layout at the next norm
(``transformer.add_norm``), the vocab-parallel embedding and tied head,
the encoder's non-causal flash and the cross attention on local heads,
each decoder layer's cross K / V projected through ``gather_fsdp``.  A
prefill's caches ("k", "v", "xk", "xv") are placed by the cache rules
(``kv_seq`` over ``model``), so a decode's self and cross attention are
context-parallel where the positions (or frames) divide that axis;
1500 frames on a 16-way axis stay whole.  The inputs are placed by
("batch", ...) when they come plain.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention
from repro_torch.models import params as P
from repro_torch.models.common import (embed_lookup, padded_vocab,
                                       sinusoid_at, sinusoidal_positions,
                                       stack_layers)
from repro_torch.models.mlp import mlp_forward
from repro_torch.models.transformer import (REMAT, _placed_inputs,
                                            _rows_like, add_norm,
                                            attention_spec, remat_call)

# a prefill's caches, stacked over the decoder layers (``api._cache_rule``)
CACHE_AXES = (None, "batch", "kv_seq", None, None)


def _enc_layer_spec(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {"norm1": P.norm(d), "norm2": P.norm(d),
            "attn": attention_spec(cfg), "mlp": P.mlp_spec(d, cfg.d_ff)}


def whisper_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """``init_whisper``."""
    d = cfg.d_model
    dec = dict(_enc_layer_spec(cfg), norm_x=P.norm(d),
               xattn=attention_spec(cfg))
    return {"embed": P.embed(padded_vocab(cfg.vocab_size), d),
            "enc": P.Stack(cfg.encoder_layers, _enc_layer_spec(cfg)),
            "enc_norm": P.norm(d),
            "dec": P.Stack(cfg.num_layers, dec),
            "final_norm": P.norm(d)}


class WhisperLM(P.Model):
    """The audio family's model (the tree of ``whisper.init_whisper``)."""

    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: torch.device):
        if cfg.family != "audio":
            raise ValueError(f"WhisperLM runs the audio family, not "
                             f"{cfg.family!r}")
        super().__init__(whisper_spec(cfg), cfg, dtype=dtype, device=device)


def _plus(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x [B,S,d] + sinusoids `pos`, [1,S,d] (every row's) or [B,1,d]
    (each row's own); on a placed x, pos placed whole or as x's rows."""
    pos = pos.to(x.dtype)
    if shd.is_placed(x):
        if pos.shape[0] == 1:
            pos = shd.from_local(pos, x, [shd.Replicate()]
                                 * x.device_mesh.ndim)
        else:
            pos = _rows_like(pos, x)
    return x + pos


def encode(params: WhisperLM, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames [B, Ctx, d] (the stub frontend's output) -> [B, Ctx, d]."""
    B, Ctx, d = frames.shape
    x = _plus(frames, sinusoidal_positions(Ctx, d, frames.device)[None])
    positions = torch.arange(Ctx, device=x.device).expand(B, Ctx)
    y = None
    for lp in params.enc.layers():
        x, h = add_norm(x, y, lp["norm1"], cfg.norm_eps)
        h, _ = attention.attn_forward(lp["attn"], h, positions, cfg=cfg,
                                      mode="train", bidirectional=True,
                                      use_rope=False)
        x, h = add_norm(x, h, lp["norm2"], cfg.norm_eps)
        y = mlp_forward(lp["mlp"], h)
    return add_norm(x, y, params.enc_norm, cfg.norm_eps)[1]


def _cross_kv(lp, enc_out: torch.Tensor, cfg: ModelConfig):
    """One decoder layer's cross-attention K/V from the encoder output."""
    _, kvh, hd = attention.attn_dims(cfg)
    k = enc_out @ shd.gather_fsdp(lp["xattn"]["wk"])
    v = enc_out @ shd.gather_fsdp(lp["xattn"]["wv"])
    return (attention._split_heads(k, kvh, hd),
            attention._split_heads(v, kvh, hd))


def whisper_forward(params: WhisperLM, batch: Dict[str, Any],
                    cfg: ModelConfig, *, mode: str = "train",
                    caches: Optional[Dict[str, Any]] = None,
                    remat: str = "full"):
    """Returns (logits [B,S,Vp], aux=0, new_caches).

    batch: {"tokens": [B,S]}, plus "frames" [B,Ctx,d] unless decoding
    (decode reads the cross K/V from the caches).  `remat` (one of
    ``transformer.REMAT``): 'full' checkpoints each decoder layer in
    'train'; 'dots' and 'none' keep every activation, as in the JAX
    package."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    if shd.is_placed(params.embed):
        batch = _placed_inputs(batch, None)
    tokens = batch["tokens"].to(params.device).long()
    B, S = tokens.shape
    d = cfg.d_model
    x = shd.constrain(embed_lookup(params.embed, tokens),
                      ("batch", None, "act_embed"))
    dev = x.device
    lens = None
    if mode == "decode":
        if caches is None:
            raise ValueError("mode 'decode' needs caches")
        lens = torch.as_tensor(caches["len"], device=dev).expand(B)
        attention.check_cache_bounds(lens, 1, caches["k"].shape[2])
        positions = lens.reshape(B, 1)
        x = _plus(x, sinusoid_at(lens, d)[:, None, :])
        xk, xv = caches["xk"], caches["xv"]
    elif mode in ("prefill", "train"):
        positions = torch.arange(S, device=dev).expand(B, S)
        x = _plus(x, sinusoidal_positions(S, d, dev)[None])
        enc_out = encode(params, batch["frames"].to(device=dev,
                                                    dtype=x.dtype), cfg)
        kv = [_cross_kv(lp, enc_out, cfg) for lp in params.dec.layers()]
        one = (B, enc_out.shape[1]) + attention.attn_dims(cfg)[1:]
        xk = stack_layers([k for k, _ in kv], one, x)
        xv = stack_layers([v for _, v in kv], one, x)
    else:
        raise ValueError(f"unknown whisper mode {mode!r}")

    y = None
    new_k, new_v = [], []
    for i, lp in enumerate(params.dec.layers()):
        if mode == "train":
            # the JAX forward checkpoints a layer under 'full' only
            x, y = remat_call(_train_layer,
                              "full" if remat == "full" else "none",
                              x, y, lp, positions, xk[i], xv[i], cfg)
            continue
        cache = None
        if lens is not None:
            cache = {"k": caches["k"][i], "v": caches["v"][i], "len": lens}
        x, y, nc = _dec_layer(x, y, lp, positions, xk[i], xv[i], cfg, mode,
                              cache)
        if mode == "prefill":
            new_k.append(nc["k"])
            new_v.append(nc["v"])

    _, x = add_norm(x, y, params.final_norm, cfg.norm_eps)
    logits = shd.constrain(x @ shd.gather_fsdp(params.embed.T),  # tied head
                           ("batch", None, "vocab"))
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    new_caches = None
    if mode == "prefill":
        one = (B, S) + attention.attn_dims(cfg)[1:]
        new_caches = {n: shd.constrain(t, CACHE_AXES) for n, t in (
            ("k", stack_layers(new_k, one, x)),
            ("v", stack_layers(new_v, one, x)), ("xk", xk), ("xv", xv))}
        new_caches["len"] = torch.tensor(S, dtype=torch.int32, device=dev)
    elif mode == "decode":
        new_caches = dict(caches, len=(lens + 1).to(torch.int32))
    return logits, aux, new_caches


def _dec_layer(x, y, lp, positions, xk, xv, cfg: ModelConfig, mode: str,
               cache):
    """One decoder layer: y (the branch before) is added by norm1's
    kernel.  Returns (x, the layer's branch, its new self-attention
    cache)."""
    x, h = add_norm(x, y, lp["norm1"], cfg.norm_eps)
    h, nc = attention.attn_forward(lp["attn"], h, positions, cfg=cfg,
                                   mode=mode, cache=cache, use_rope=False)
    x, h = add_norm(x, h, lp["norm_x"], cfg.norm_eps)
    h, _ = attention.attn_forward(lp["xattn"], h, positions, cfg=cfg,
                                  mode=mode, kv_override=(xk, xv),
                                  use_rope=False)
    x, h = add_norm(x, h, lp["norm2"], cfg.norm_eps)
    return x, mlp_forward(lp["mlp"], h), nc


def _train_layer(x, y, lp, positions, xk, xv, cfg: ModelConfig):
    return _dec_layer(x, y, lp, positions, xk, xv, cfg, "train", None)[:2]


def init_whisper_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                        dtype: torch.dtype, device: torch.device
                        ) -> Dict[str, Any]:
    L = cfg.num_layers
    _, kvh, hd = attention.attn_dims(cfg)
    one = attention.init_kv_cache(cfg, batch, max_len, dtype=dtype,
                                  device=device)
    cross = (L, batch, cfg.encoder_ctx, kvh, hd)
    return {"k": one["k"].new_zeros((L,) + tuple(one["k"].shape)),
            "v": one["v"].new_zeros((L,) + tuple(one["v"].shape)),
            "xk": torch.zeros(cross, dtype=dtype, device=device),
            "xv": torch.zeros(cross, dtype=dtype, device=device),
            "len": one["len"]}
