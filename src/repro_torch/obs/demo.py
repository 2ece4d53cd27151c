"""End-to-end observability demo of the port.

    PYTHONPATH=src python -m repro_torch.obs.demo [--out obs_demo.trace.json]
                                                  [--device cpu]

Runs (1) SIMT Rodinia kernels on the cycle-level machine (on the card,
one kernel launch each) and prints a Vortex-style PerfReport PER KERNEL
LAUNCH (the gaussian pipeline shows two: fan1 and fan2), (2) a short
serving session on a reduced model — with the live HTTP plane up,
scraping its own `/metrics` + `/healthz` and printing the serving
snapshot, (3) dumps and schema-validates a flight-recorder artifact,
then (4) writes a Chrome trace-event JSON of everything (per-request
Perfetto tracks included) and verifies it round-trips through
`json.load`.  Load the trace at https://ui.perfetto.dev.

The twin of ``repro.obs.demo``.  Runs on ``cuda`` unless told
``--device cpu``; without a card and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import urllib.request
from pathlib import Path

import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.obs.flight import flight, validate_flight


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def run_simt_section(device: torch.device) -> None:
    from repro_torch.core.simt import machine
    from repro_torch.core.simt.machine import launch_log
    from repro_torch.runtime.kernels_src import rodinia

    mc = machine.MachineConfig(warps=4, threads=4, miss_latency=16)
    launch_log.enable()
    with obs.trace.span("simt:saxpy", warps=mc.warps, threads=mc.threads):
        res, ok = rodinia.BENCHMARKS["saxpy"](mc, n=128, repeats=4,
                                              device=device)
    assert ok, "saxpy verification failed"
    res2, ok2 = rodinia.BENCHMARKS["gaussian"](mc, n=12, device=device)
    assert ok2, "gaussian verification failed"
    # per-kernel PerfReports: one per launch label, not one per run —
    # gaussian's two-kernel pipeline gets separate fan1/fan2 reports
    for label, rep in launch_log.reports(mc).items():
        print(f"[{label}]")
        print(rep)
        assert rep.ipc > 0, f"empty PerfReport for {label}"
    rep = machine.perf_report(res.stats, mc)
    assert rep.ipc > 0 and rep.dcache_hit_rate > 0, "empty PerfReport"
    obs.metrics.gauge("simt.ipc").set(rep.ipc)
    obs.metrics.gauge("simt.dcache_hit_rate").set(rep.dcache_hit_rate)
    launch_log.disable()


def run_serving_section(device: torch.device) -> None:
    from repro_torch.configs import reduced_config
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine

    cfg = reduced_config("phi3-mini-3.8b").replace(num_layers=2)
    params = api.build_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    eng = Engine(cfg, params, n_slots=4, max_len=64, prompt_bucket=8,
                 eos_id=-1)
    # the live HTTP plane: scrape our own endpoints mid-demo
    with obs.ObsServer(port=0, registries=[eng.metrics, obs.metrics],
                       health=eng.liveness, requests=eng.debug_requests,
                       flight=flight) as srv:
        with obs.trace.span("serve_session"):
            for p in ([5, 9, 2], [7, 1], [3, 3, 3, 3], [11, 4]):
                eng.submit(p, max_new=6)
            eng.run()
        eng.liveness.done()
        base = f"http://127.0.0.1:{srv.port}"
        om = _get(f"{base}/metrics")
        assert om.endswith("# EOF\n") and '_bucket{le="' in om
        hz = json.loads(_get(f"{base}/healthz"))
        dr = json.loads(_get(f"{base}/debug/requests"))
        print(f"live plane: {base}  ({len(om.splitlines())} OpenMetrics "
              f"lines, healthz={hz['state']}, {len(dr)} request rows)")
    snap = eng.metrics_snapshot()
    ttft = snap["serving.ttft_s"]
    print("serving metrics:")
    print(f"  requests        {snap['serving.requests_completed']['value']}"
          f" completed ({snap['serving.requests_completed.max_new']['value']}"
          f" by max_new)")
    print(f"  TTFT            mean {ttft['mean']*1e3:.1f} ms  "
          f"p99 {ttft['p99']*1e3:.1f} ms  (n={ttft['count']})")
    print(f"  inter-token     mean {snap['serving.itl_s']['mean']*1e3:.1f} ms")
    print(f"  tokens          {snap['serving.tokens']['value']}  "
          f"({snap['serving.tokens_per_s']['value']:.1f} tok/s)")
    print(f"  batch efficiency "
          f"{snap['serving.decode_lanes_selected']['value']}"
          f"/{snap['serving.decode_lanes_total']['value']} lanes")
    assert ttft["count"] > 0 and snap["serving.tokens"]["value"] > 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="obs_demo.trace.json")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    obs.enable_tracing()
    obs.enable_kernel_timing()
    flight.enable()
    flight.attach_tracer(obs.tracer)
    flight.add_metrics_source(obs.metrics)

    print(f"---- SIMT machine ({device}) ----")
    run_simt_section(device)
    print("\n---- serving ----")
    run_serving_section(device)

    print("\n---- flight recorder ----")
    with tempfile.TemporaryDirectory() as td:
        path = flight.dump(td, reason="demo")
        doc = json.loads(Path(path).read_text())
        validate_flight(doc)
        kinds = sorted({e["kind"] for e in doc["events"]})
        print(f"flight dump: {doc['n_events']} events "
              f"({doc['dropped']} dropped), kinds={kinds}")
        assert "serving.finish" in kinds and "simt.launch" in kinds

    events = obs.tracer.drain()
    obs.write_chrome_trace(args.out, events,
                           metadata={"demo": "repro_torch.obs"})
    loaded = obs.load_chrome_trace(args.out)          # json.load round-trip
    names = {e["name"] for e in loaded if e.get("ph") == "X"}
    assert len(names) >= 3, f"expected >=3 span names, got {names}"
    print("\n---- trace ----")
    print(obs.text_summary(loaded))
    print(f"\nwrote {args.out} ({len(loaded)} events, "
          f"{len(names)} span names) — load it at https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    sys.exit(main())
