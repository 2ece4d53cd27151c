"""How far int8 KV caches move a model's logits from a float cache.

    PYTHONPATH=src python experiments/kv_q8_float_gap.py [--device cpu]

For each dense, MoE and vlm config of the int8 decode path (reduced,
two layers, fp32, the port's seed-0 weights), 24 decode steps of the
same numpy tokens (two slots, caches of 40 positions: danube's window
of 16 makes its cache a ring that wraps) on int8 caches and on float
caches; prints one JSON line: per arch, the largest
max |int8 - float| / max |float| over the steps and the steps whose
greedy tokens differ.  A reading of quantization, not a check: the
weights are random.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.models import api

ARCHS = ("phi3-mini-3.8b", "h2o-danube-1.8b", "qwen2.5-32b", "olmoe-1b-7b",
         "internvl2-76b")
B, MAX_LEN, STEPS = 2, 40, 24


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    dev = ap.parse_args().device
    out = {}
    for arch in ARCHS:
        cfg = reduced_config(arch).replace(num_layers=2, dtype="float32")
        params = api.build_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        toks = np.random.default_rng(11).integers(
            0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
        caches = {q: api.init_caches(cfg, B, MAX_LEN, device=dev,
                                     kv_quant=q) for q in (True, False)}
        gap, flips = 0.0, 0
        for tok in toks:
            logits = {}
            for q in (True, False):
                logits[q], _, caches[q] = api.forward(
                    params, {"tokens": torch.from_numpy(tok).to(dev)}, cfg,
                    mode="decode", caches=caches[q])
            gap = max(gap, float((logits[True] - logits[False]).abs().max()
                                 / logits[False].abs().max()))
            flips += int((logits[True].argmax(-1)
                          != logits[False].argmax(-1)).sum())
        out[arch] = {"max_normalized_gap": gap, "greedy_apart": flips,
                     "greedy_tokens": STEPS * B}
    print(json.dumps({"device": dev, "gap": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
