"""Data pipeline: the twin of ``repro.data.pipeline`` — a deterministic
synthetic LM stream with a resumable cursor.

``SyntheticLM`` is a copy: batch t is a pure function of (seed, t) and
its numpy arrays equal the JAX package's.  ``Loader`` puts them on the
device as torch tensors (int32 tokens and labels; float leaves in the
model's dtype).  The source is addressed by (seed, step), so a restart
rewinds by assigning the cursor.  Under data parallelism a rank's
``Loader`` takes its rows of each global batch (``rank_rows``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Deterministic synthetic corpus: Zipf-ish token draws + shifted
    labels.  Batch t is a pure function of (seed, t) — no state to
    snapshot beyond the cursor."""
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        B, S = self.shape.global_batch, self.shape.seq_len
        if self.cfg.family == "vlm":
            S = S - self.cfg.num_patch_tokens
        # Zipf-like marginal over the true vocab (realistic softmax skew)
        v = self.cfg.vocab_size
        toks = (rng.zipf(1.3, size=(B, S + 1)) - 1) % v
        out: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.cfg.family == "vlm":
            out["patch_embeds"] = rng.standard_normal(
                (B, self.cfg.num_patch_tokens, self.cfg.d_model),
                dtype=np.float32)
        elif self.cfg.family == "audio":
            out["frames"] = rng.standard_normal(
                (B, self.cfg.encoder_ctx, self.cfg.d_model), dtype=np.float32)
        return out


def rank_rows(batch: int, microbatch: Optional[int], rank: int,
              n: int) -> np.ndarray:
    """The rows of a global batch that data-parallel rank `rank` of `n`
    trains on: its share of every microbatch, microbatch by microbatch.
    The JAX step splits the batch into contiguous microbatches of
    `microbatch` rows (one microbatch when it is unset or does not
    divide the batch) and shards each over the data axis, so rank r
    holds rows [i*mb + r*mb/n, i*mb + (r+1)*mb/n) of microbatch i."""
    mb = microbatch
    if not mb or mb >= batch or batch % mb:
        mb = batch
    if mb % n:
        raise ValueError(f"a microbatch of {mb} rows does not split over "
                         f"{n} data-parallel ranks")
    share = mb // n
    return np.concatenate([np.arange(i * mb + rank * share,
                                     i * mb + (rank + 1) * share)
                           for i in range(batch // mb)])


class Loader:
    """Iterates a source from a cursor, putting each batch on `device`
    (``cuda`` unless the caller asks for the CPU).  With `shard`
    (rank, n) and the step's `microbatch`, each batch is the rank's
    rows of the global one (``rank_rows``)."""

    def __init__(self, source: SyntheticLM, *, device: DeviceLike = None,
                 start_step: int = 0,
                 model_dtype: torch.dtype = torch.bfloat16,
                 shard: Tuple[int, int] = (0, 1),
                 microbatch: Optional[int] = None):
        self.source = source
        self.device = resolve_device(device)
        self.step = start_step
        self.model_dtype = model_dtype
        self.rows = None
        if shard[1] > 1:
            self.rows = rank_rows(source.shape.global_batch, microbatch,
                                  *shard)

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "seed": self.source.seed}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.step = int(d["step"])

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        raw = self.source.batch(self.step)
        self.step += 1
        out = {}
        for k, v in raw.items():
            if self.rows is not None:
                v = v[self.rows]
            t = torch.from_numpy(v)
            if v.dtype == np.float32:
                t = t.to(self.model_dtype)
            out[k] = t.to(self.device)
        return out
