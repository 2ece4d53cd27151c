"""Whether the internvl2-76b backbone's loss rise on the card comes from
the learning rate: the same train steps at several learning rates and
warm-ups.

    python experiments/internvl_lr.py [--steps 6]

Full-width internvl2-76b cut to 1 of 80 layers, bf16, from seed 0, as
``chip_smoke.py``'s ``train_internvl`` path runs it (seq 4096, batch 2
in microbatches of 1, remat full, ``data.pipeline.Loader`` batches from
seed 0), through ``training.loop.make_train_step`` at each (learning
rate, warm-up steps, steps of the schedule) of SETTINGS, the first
being the smoke's own (its cosine decay ends at step 3; later steps
run at a tenth of the rate).  The batches and the initial weights are
the same in every run, so the first step's loss is too.  One JSON line
a setting: each step's loss and grad norm.  Needs a card (about a
minute, kernels built on first use); imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import (ShapeConfig, TrainConfig,  # noqa: E402
                                 get_config)
from repro_torch.data.pipeline import Loader, SyntheticLM  # noqa: E402
from repro_torch.training import loop  # noqa: E402

SETTINGS = ((3e-5, 1, 3), (1e-5, 1, 3), (3e-6, 1, 3), (3e-5, 3, 6))


def run(lr: float, warmup: int, total: int, steps: int) -> dict:
    cfg = get_config("internvl2-76b").replace(num_layers=1)
    tc = TrainConfig(learning_rate=lr, total_steps=total,
                     warmup_steps=warmup, microbatch=1, remat="full")
    state = loop.init_train_state(cfg, tc, device="cuda")
    loader = Loader(SyntheticLM(cfg, ShapeConfig("t", seq_len=4096,
                                                 global_batch=2,
                                                 kind="train"),
                                seed=tc.seed),
                    device="cuda", model_dtype=state.params.embed.dtype)
    step = loop.make_train_step(cfg, tc)
    out = {"lr": lr, "warmup": warmup, "total_steps": total, "loss": [],
           "grad_norm": []}
    for _ in range(steps):
        state, met = step(state, next(loader))
        out["loss"].append(float(met["loss"]))
        out["grad_norm"].append(float(met["grad_norm"]))
    del state, loader, step
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("internvl_lr: needs a CUDA card", file=sys.stderr)
        return 2
    for lr, warmup, total in SETTINGS:
        print(json.dumps(run(lr, warmup, total, args.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
