"""Time the SSD intra-chunk backward kernel, one tree a run.

    python experiments/ssd_bwd_ab.py [--tree PATH] [--tag NAME]

Imports ``repro_torch`` from ``PATH/src`` (default: this checkout) and
builds its ``ssm_scan_bwd`` library there, so two checkouts (a parent
unpacked with ``git archive`` and the change) can be timed in turns on
one card, one process each (parent, change, change, parent).  At
zamba2-7b's train shape [1,16,256,112,64,64] (seq 4096 in chunks of
256, 112 heads, head dim 64, state 64), fp32, inputs from a seeded
generator as ``chip_smoke.ssd_inputs`` makes them, it prints one JSON
line:

- ``ms``: per call, median of CUDA-event windows around eager calls;
- ``device_ms``: per call from CUDA-graph replays (no host time);
- ``kernel_ms``: each CUDA function's device ms per call, from
  ``torch.profiler`` (the ``ssd_bwd_*`` launches);
- ``err``: max |kernel - fp64 plain| / max |fp64 plain| of dcum, dxdt,
  dB and dC, beside the plain fp32 version's own (``plain_err``), and
  ``same_bits`` (two calls equal);
- ``ptxas``: registers, stack frame and spill bytes of each instance
  in the library, and ptxas's notes that it serialized wgmma.

Needs a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (1, 16, 256, 112, 64, 64)  # B, nc, Q, H, P, N


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
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.ref import ssd_intra_bwd_ref
    if not torch.cuda.is_available():
        print("ssd_bwd_ab: needs a CUDA card", file=sys.stderr)
        return 2
    if tree not in build.CSRC.resolve().parents:
        raise RuntimeError(f"repro_torch came from {build.CSRC}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    report = build.build(["ssm_scan_bwd"])
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = {"tag": args.tag, "tree": str(tree), "shape": list(SHAPE),
           "ptxas": smoke.ptxas_usage(report["ssm_scan_bwd"])}
    B, nc, Q, H, P, N = SHAPE
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 8)
    ins = smoke.ssd_inputs(torch, g, nc, Q, H, P, N)
    dy = torch.randn(ins[1].shape, generator=g, device="cuda")
    dS = torch.randn(B, nc, H, N, P, generator=g, device="cuda")

    def call():
        return ops.ssd_intra_bwd_cuda(*ins, dy, dS)
    got, again = call(), call()
    torch.cuda.synchronize()
    want = ssd_intra_bwd_ref(*(t.double() for t in (*ins, dy, dS)))
    plain = ssd_intra_bwd_ref(*ins, dy, dS)
    names = ("dcum", "dxdt", "dB", "dC")
    out["err"] = {n: float((a.double() - w).abs().max() / w.abs().max())
                  for n, a, w in zip(names, got, want)}
    out["plain_err"] = {n: float((p.double() - w).abs().max()
                                 / w.abs().max())
                        for n, p, w in zip(names, plain, want)}
    out["same_bits"] = all(torch.equal(a, b) for a, b in zip(got, again))
    del got, again, want, plain
    out["ms"] = smoke._time_ms(torch, call, reps=7, inner=5)
    out["device_ms"] = smoke._device_ms(torch, call, reps=7, inner=5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    out["kernel_ms"] = {
        re.search(r"ssd_bwd_\w+(<[^>]*>)?", e.key).group(0):
            e.self_device_time_total / 1e3 / e.count
        for e in prof.key_averages()
        if e.self_device_time_total > 0 and "ssd_bwd_" in e.key}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
