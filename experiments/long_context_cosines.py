"""How far bf16 rounding alone moves zamba2-7b's decode from its prefill
at a long context, with and without the long-context window.

    python experiments/long_context_cosines.py

Full-width zamba2-7b from seed 0, one prompt of W + 3 tokens (seed 24):
for W in (64, 4096) in bf16 and W = 4096 in fp32, with the shared
attention windowed to W (``api.ZAMBA_LONG_WINDOW`` set to W, so a
W-token prefill fills a ring of W slots) and without a window (caches
grown to W + 3), it prefills W tokens, decodes 3 and gives each step's
cosine with the last logits of a prefill of the same tokens; and the
cosine of two prefills (W and W + 1 tokens) at position W - 1, which
compute the same logits but for rounding.  One JSON line per (dtype,
W).  Needs a card (about 2 minutes); imports nothing of JAX.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402

STEPS = 3


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0))


def run(dtype: str, W: int) -> dict:
    cfg = get_config("zamba2-7b").replace(dtype=dtype)
    params = api.build_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    prompt = np.random.default_rng(24).integers(
        0, cfg.vocab_size, W + STEPS).tolist()
    api.ZAMBA_LONG_WINDOW = W

    def toks(n):
        return torch.tensor([prompt[:n]], dtype=torch.int32, device="cuda")

    out = {"dtype": dtype, "W": W}
    for windowed in (True, False):
        logits, _, caches = api.forward(params, {"tokens": toks(W)}, cfg,
                                        mode="prefill",
                                        long_context=windowed)
        if not windowed:
            caches = api.grow_caches(cfg, caches, W + STEPS)
        at_w = logits[0, -1]
        cos = []
        for i in range(STEPS):
            step, _, caches = api.forward(
                params, {"tokens": toks(W + i + 1)[:, -1:]}, cfg,
                mode="decode", caches=caches, long_context=windowed)
            full, _, _ = api.forward(params, {"tokens": toks(W + i + 1)},
                                     cfg, mode="prefill",
                                     long_context=windowed)
            cos.append(_cos(step[0, -1], full[0, -1]))
            if i == 0:
                out["two_prefills_at_W-1"] = _cos(full[0, W - 1], at_w)
        out["windowed" if windowed else "unwindowed"] = cos
    del params
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("long_context_cosines: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype, W in (("bfloat16", 64), ("bfloat16", 4096),
                     ("float32", 4096)):
        print(json.dumps(run(dtype, W)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
