"""Token sampling: greedy / temperature / top-k, vocab-mask aware.  The
twin of ``repro.serving.sampler``.

Greedy and guarded sampling match the JAX package exactly.  Stochastic
sampling draws from an explicit ``torch.Generator``; it cannot replay
``jax.random.categorical``'s bits, only its distribution.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0       # 0 => greedy
    top_k: int = 0                 # 0 => full softmax
    seed: int = 0


def _mask_padded(lf: torch.Tensor, vocab_size: int) -> torch.Tensor:
    vp = lf.shape[-1]
    if vp > vocab_size:
        col = torch.arange(vp, device=lf.device)
        lf = torch.where(col < vocab_size, lf, torch.full_like(lf, NEG))
    return lf


def sample(logits: torch.Tensor, vocab_size: int, cfg: SamplerConfig,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits: [B, Vp] -> tokens [B] int32 (padded vocab masked out)."""
    lf = _mask_padded(logits.float(), vocab_size)
    if cfg.temperature <= 0.0:
        return torch.argmax(lf, dim=-1).to(torch.int32)
    lf = lf / cfg.temperature
    if cfg.top_k:
        kth = torch.topk(lf, cfg.top_k, dim=-1).values[..., -1:]
        lf = torch.where(lf < kth, torch.full_like(lf, NEG), lf)
    if generator is None:
        raise ValueError("stochastic sampling needs a torch.Generator")
    probs = torch.softmax(lf, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def sample_guarded(logits: torch.Tensor, vocab_size: int,
                   cfg: SamplerConfig,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`sample` with a NaN/Inf guard: rows containing any non-finite
    logit fall back to GREEDY over sanitized logits (every non-finite
    entry set to -1e30).  Returns (tokens [B], bad_rows [B] bool).  Rows
    whose logits are all finite take the exact `sample` result."""
    lf = logits.float()
    finite = torch.isfinite(lf)
    bad = ~finite.all(dim=-1)
    clean = _mask_padded(torch.where(finite, lf, torch.full_like(lf, NEG)),
                         vocab_size)
    greedy = torch.argmax(clean, dim=-1).to(torch.int32)
    # rows with NaN would make multinomial raise: sample from the
    # sanitized logits there (their draw is replaced by `greedy` anyway)
    tok = sample(torch.where(bad[:, None], clean, lf), vocab_size, cfg,
                 generator)
    return torch.where(bad, greedy, tok), bad


def logit_entropy(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Shannon entropy (nats) of softmax(logits) per row, padded vocab
    excluded.  logits: [B, Vp] -> [B] fp32."""
    lp = torch.log_softmax(logits.float()[..., :vocab_size], dim=-1)
    return -(lp.exp() * lp).sum(dim=-1)
