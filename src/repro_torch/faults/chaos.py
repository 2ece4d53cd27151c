"""Chaos helpers: concrete fault effectors and canned plans (a copy of
``repro.faults.chaos``).

`corrupt_checkpoint` is the effector for `ckpt.save`/`corrupt` faults —
it deterministically flips bytes inside a checkpoint's `arrays.npz`
payload so checksum verification (and usually the zip CRC) fails, the
on-disk analogue of a torn object write.

`serving_plan` / `training_plan` are canned seeded plans for the launch
CLIs' `--chaos-seed` flags: one of each fault class at a modest rate, so
a demo run exercises every recovery path.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.faults.plan import FaultPlan

__all__ = ["corrupt_checkpoint", "serving_plan", "training_plan"]


def corrupt_checkpoint(path: str, *, seed: int = 0, n_bytes: int = 8) -> int:
    """XOR `n_bytes` seed-chosen bytes of `<path>/arrays.npz`; returns
    the number of bytes flipped (0 if the shard is too small to touch
    safely).  Deterministic in (seed, file size)."""
    shard = os.path.join(path, "arrays.npz")
    size = os.path.getsize(shard)
    if size <= 128:
        return 0
    rng = np.random.default_rng(seed)
    offsets = rng.integers(128, size, n_bytes)
    with open(shard, "r+b") as f:
        for off in offsets:
            f.seek(int(off))
            b = f.read(1)
            f.seek(int(off))
            f.write(bytes([b[0] ^ 0xFF]))
    return int(n_bytes)


def serving_plan(seed: int, horizon: int = 32) -> FaultPlan:
    """One of each serving fault class, seeded — the `--chaos-seed` demo
    plan for `repro_torch.launch.serve`."""
    return FaultPlan.generate(seed, horizon=horizon, rates={
        ("serving.logits", "nan_logits"): 0.10,
        ("serving.logits", "inf_logits"): 0.05,
        ("serving.decode", "slow"): 0.10,
        ("serving.step", "exception"): 0.05,
    })


def training_plan(seed: int, horizon: int = 64, n_pods: int = 0) -> FaultPlan:
    """Training-side demo plan: transient step crashes, corrupt shards,
    pod stalls (pod faults only when `n_pods` > 0)."""
    rates = {
        ("train.step", "exception"): 0.05,
        ("ckpt.save", "corrupt"): 0.10,
    }
    if n_pods:
        rates[("pod", "pod_stall")] = 0.10
    return FaultPlan.generate(seed, horizon=horizon, rates=rates,
                              n_pods=n_pods)
