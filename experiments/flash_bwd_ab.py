"""Time the bf16 FA-2 flash backward kernels, one tree a run.

    python experiments/flash_bwd_ab.py [--tree PATH] [--tag NAME]

Imports ``repro_torch`` from ``PATH/src`` (default: this checkout) and
builds its ``flash_attention`` and ``flash_attention_bwd`` libraries
there, so two checkouts (a parent unpacked with ``git archive`` and the
change, or a copy with one edit) can be timed in turns on one card, one
process each (parent, change, change, parent).  At h2o-danube-1.8b's
attention shape (32 heads, 8 kv heads, head_dim 80, window 4096), bf16,
random inputs from a seeded generator, it prints one JSON line:

- ``ms``: per call at S 8192 (where the window binds) and at S 4096
  (where it cannot, the same pairs as the causal SDPA backward), median
  of CUDA-event windows around eager calls;
- ``kernel_ms``: each CUDA function's device ms per call at S 8192,
  from ``torch.profiler`` (the delta, dK/dV and dQ kernels);
- ``err`` (max |kernel - plain| / max |plain| of dq, dk, dv against
  ``flash_bwd_ref``) and ``same_bits`` (two calls equal) at S 4096;
- ``ptxas``: registers, stack frame and spill bytes of the head_dim 80
  instances, and ptxas's notes that it serialized wgmma instructions.

Needs a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
H, KV, D, WINDOW = 32, 8, 80, 4096


def _ms(torch, fn, reps: int = 7, inner: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_bwd_ref
    if not torch.cuda.is_available():
        print("flash_bwd_ab: needs a CUDA card", file=sys.stderr)
        return 2
    if tree not in build.CSRC.resolve().parents:
        raise RuntimeError(f"repro_torch came from {build.CSRC}, not {tree}")
    report = build.build(["flash_attention", "flash_attention_bwd"])
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    usage = smoke.ptxas_usage(report["flash_attention_bwd"], r"wgmma")
    out = {"tag": args.tag, "tree": str(tree), "ms": {},
           "ptxas": {k: v for k, v in usage.items()
                     if k == "warnings" or f",{D}>" in k}}
    g = torch.Generator(device="cuda").manual_seed(5)
    for S in (4096, 8192):
        q, k, v, do = (torch.randn(1, S, h, D, generator=g, device="cuda")
                       .to(torch.bfloat16) for h in (H, KV, KV, H))
        o, lse = fa.flash_attention_cuda(q, k, v, window=WINDOW,
                                         with_lse=True)

        def call():
            return fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                               window=WINDOW)
        if S == 4096:
            got, again = call(), call()
            want = flash_bwd_ref(q, k, v, o, lse, do, window=WINDOW)
            out["err"] = [float((a.float() - c.float()).abs().max()
                                / c.float().abs().max())
                          for a, c in zip(got, want)]
            out["same_bits"] = all(torch.equal(a, b)
                                   for a, b in zip(got, again))
            del got, again, want
        out["ms"][str(S)] = _ms(torch, call)
        if S == 8192:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            out["kernel_ms"] = {
                re.search(r"flash_bwd_\w+(<[^>]*>)?", e.key).group(0):
                    e.self_device_time_total / 1e3 / e.count
                for e in prof.key_averages()
                if e.self_device_time_total > 0 and "flash_bwd_" in e.key}
        del q, k, v, do, o, lse
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
