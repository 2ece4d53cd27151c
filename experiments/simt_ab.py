"""Time the SIMT machine's CUDA kernel on the Fig 9 grid, one tree a run.

    python experiments/simt_ab.py [--tree PATH] [--reps N]

Imports ``repro_torch`` from ``PATH/src`` (default: this checkout), so
two checkouts, a parent unpacked with ``git archive`` and the change,
can be timed in turns on one card, one process each (parent, change,
change, parent).  It runs the Fig 9 cells through the Rodinia benches
(``benchmarks/fig9_rodinia.py``'s sizes and miss latencies), recording
each machine launch, and checks every cell's 16 counters and cycles
against the tree's committed baseline.  Then it replays each launch
``reps`` times under ``torch.profiler`` and prints one JSON line: device
ms of ``simt_kernel`` per cell (the median over the replays), ns and SM
clocks per simulated cycle, and a least-squares fit of the grid's
launches to ``a * issued + b * idle + c`` (ns per issued cycle, per
idle cycle, per launch), and ``fixed_ms``, the device time of a launch
that runs one cycle (one ``ecall`` at 8w8t): its state in and out.  The
SM clock is ``nvidia-smi``'s ``clocks.sm``, sampled every 50 ms during
the replays.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CONFIGS = [(2, 2), (2, 8), (8, 2), (8, 8), (4, 16), (16, 4)]
BENCHES = {  # name -> (kwargs, miss_latency)
    "vecadd": (dict(n=256), 16),
    "saxpy": (dict(n=256, repeats=8), 16),
    "sgemm": (dict(m=12, k=12, n=12), 16),
    "bfs": (dict(n_nodes=512, avg_deg=4), 200),
    "gaussian": (dict(n=16), 16),
    "nn": (dict(n=256), 16),
    "kmeans": (dict(n=128, k=8), 16),
}


class SmClock:
    """``nvidia-smi``'s SM clock (MHz), sampled while the block runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        vals = [float(v) for v in out.split() if v.strip().isdigit()]
        self.mhz = statistics.median(vals) if vals else None
        return False


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return res.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.simt import machine
    from repro_torch.runtime.kernels_src import rodinia
    if not torch.cuda.is_available():
        print("simt_ab: needs a CUDA card", file=sys.stderr)
        return 2
    assert Path(machine.__file__).is_relative_to(tree), machine.__file__
    baseline = json.loads((tree / "benchmarks" / "baselines"
                           / "BENCH_fig9_rodinia.json").read_text())
    keys = machine.STAT_KEYS + ("cycles",)
    real = machine.run
    launches = []       # (cell, mc, program, image, stats)
    for name, (kw, ml) in BENCHES.items():
        for w, t in CONFIGS:
            cell = f"{name}/{w}w{t}t"
            calls = []

            def recording(mc, program, dmem_image=None, **k):
                out = real(mc, program, dmem_image=dmem_image, **k)
                calls.append((mc, program, dmem_image,
                              machine.stats_dict(out)))
                return out

            machine.run = recording
            try:
                mc = machine.MachineConfig(warps=w, threads=t,
                                           max_cycles=12_000_000,
                                           miss_latency=ml)
                res, ok = rodinia.BENCHMARKS[name](mc, device="cuda", **kw)
            finally:
                machine.run = real
            got = {k: res.stats[k] for k in keys}
            want = {k: baseline[cell]["stats"][k] for k in keys}
            if not ok or got != want:
                print(f"simt_ab: {cell} ok={ok} counters {got} != {want}",
                      file=sys.stderr)
                return 1
            launches += [(cell, *c) for c in calls]

    def kernel_ms(mc, prog, img=None) -> float:
        """The median device ms of `reps` launches, each under the
        profiler; a replay whose kernel event the profiler dropped (or
        timed at 0) is run again, up to 5 * reps replays in all."""
        times = []
        for _ in range(5 * args.reps):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                machine.run(mc, prog, dmem_image=img, device="cuda")
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages() if "simt_kernel" in e.key]
            if sum(e.count for e in ev) == 1 and ev[0].self_device_time_total:
                times.append(ev[0].self_device_time_total / 1e3)
            if len(times) == args.reps:
                return statistics.median(times)
        raise RuntimeError("the profiler kept dropping the kernel's event")

    torch.cuda.synchronize()
    with SmClock() as clk:
        ms = [kernel_ms(mc, prog, img) for _, mc, prog, img, _ in launches]
        # a one-cycle program (one ecall): the launch's fixed cost, state
        # in and out, at 8w8t
        fixed = kernel_ms(machine.MachineConfig(warps=8, threads=8),
                          np.array([0x73], np.uint32))
    cells = {}
    for (cell, *_, st), t in zip(launches, ms):
        c = cells.setdefault(cell, {"kernel_ms": 0.0, "cycles": 0,
                                    "issued": 0, "idle": 0, "launches": 0})
        c["kernel_ms"] += t
        c["cycles"] += st["cycles"]
        c["issued"] += st["instrs"]
        c["idle"] += st["idle_cycles"]
        c["launches"] += 1
    mhz = clk.mhz
    for c in cells.values():
        c["ns_per_cycle"] = 1e6 * c["kernel_ms"] / c["cycles"]
        c["sm_clocks_per_cycle"] = (c["ns_per_cycle"] * mhz / 1e3
                                    if mhz else None)
    a = np.array([[st["instrs"], st["idle_cycles"], 1.0]
                  for *_, st in launches])
    coef = np.linalg.lstsq(a, 1e6 * np.array(ms), rcond=None)[0]
    fit = dict(zip(("ns_per_issued", "ns_per_idle", "ns_per_launch"),
                   coef.tolist()))
    total_ms = sum(ms)
    total_cycles = sum(c["cycles"] for c in cells.values())
    out = {"tree": str(tree), "card": card(),
           "device": torch.cuda.get_device_name(0), "sm_mhz": mhz,
           "reps": args.reps, "launches": len(launches),
           "fixed_ms": fixed,
           "kernel_ms": total_ms, "cycles": total_cycles,
           "ns_per_cycle": 1e6 * total_ms / total_cycles,
           "sm_clocks_per_cycle": (1e3 * total_ms * mhz / total_cycles
                                   if mhz else None),
           "fit": fit, "cells": cells}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
