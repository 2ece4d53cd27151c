"""Serving CLI: batched requests through the warp-scheduler engine.
The twin of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi3-mini-3.8b --requests 3 --max-new 8

``--arch`` takes every architecture of the registry; the engine serves
the dense (``phi3-mini-3.8b``, ``qwen2.5-32b``, ``h2o-danube-1.8b``,
``minitron-4b``), MoE (``olmoe-1b-7b``, ``deepseek-moe-16b``) and
hybrid SSM (``zamba2-7b``, legacy prefill only) configs, and refuses
``xlstm-125m``, ``whisper-tiny`` and ``internvl2-76b``, which the JAX
engine cannot serve either (``models.api.forward`` runs them).  Runs
on the GPU (``--device cuda``, the default) at the config's full
width, or on the CPU with ``--device cpu`` (use ``--reduced`` there).
Without a GPU and without ``--device cpu`` it raises.  Weights are
random, from ``--seed``.  Each request prints ``max_new + 1`` tokens
(the prefill token plus the decodes).

Paged-KV knobs (``serving/kv_pool.py``): ``--kv-layout
{contiguous,paged}``, ``--kv-page-size``, ``--kv-pages``; with
``paged``, prefix-cache hits pin shared pages instead of copying
(zamba2 cannot page and refuses it).  ``--chaos-seed`` injects a seeded
fault plan, ``--trace`` writes a Perfetto trace, ``--metrics-port``
serves the live HTTP plane and ``--flight-dir`` turns on the flight
recorder, as in ``repro.launch.serve``:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi3-mini-3.8b --reduced --device cpu --kv-layout paged \
        --chaos-seed 1234 --metrics-port 0 --flight-dir /tmp/flight
"""
from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np
import torch

from repro_torch import faults, obs
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.obs.flight import flight
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampler import SamplerConfig

# the most recent ObsServer started by main(): tests drive main() in a
# thread and scrape this server's live endpoints while it serves traffic
last_server: obs.ObsServer = None


def main(argv=None) -> int:
    global last_server
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="chunked-prefill chunk size (tokens)")
    ap.add_argument("--prefill-mode", default="auto",
                    choices=["auto", "chunked", "legacy"])
    ap.add_argument("--prefix-cache-entries", type=int, default=32,
                    help="LRU capacity of the KV prefix cache; 0 disables")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="prepend a common N-token prefix to every request")
    ap.add_argument("--kv-layout", default="contiguous",
                    choices=["contiguous", "paged"],
                    help="KV cache layout: 'paged' shares prefix pages "
                         "via block tables + copy-on-write (requires "
                         "chunked prefill); 'contiguous' is the classic "
                         "per-slot slab")
    ap.add_argument("--kv-page-size", type=int, default=32,
                    help="tokens per KV page (paged layout); max-len "
                         "must be a multiple of it")
    ap.add_argument("--kv-pages", type=int, default=None, metavar="N",
                    help="total pages in the KV pool; default sizes "
                         "every slot's worst case plus headroom")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request TTL; expired requests finish with "
                         "reason 'timeout'")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission queue; overflow is shed")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace of the run here")
    ap.add_argument("--chaos-seed", type=int, default=None, metavar="SEED",
                    help="inject a seeded fault plan (NaN logits, slow "
                         "ticks, transient step crashes) to exercise the "
                         "hardened paths")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve the live observability plane (/metrics, "
                         "/healthz, /debug/requests, /debug/flight) on "
                         "this port; 0 picks an ephemeral port; default "
                         "off")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="enable the crash-forensics flight recorder; "
                         "dumps flight_*.json here on crash, fault-plan "
                         "exhaustion, or SIGUSR1")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.trace:
        obs.enable_tracing()
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = api.build_params(cfg, gen, device=device)
    injector = None
    if args.chaos_seed is not None:
        injector = faults.FaultInjector(faults.serving_plan(args.chaos_seed))
    eng = Engine(cfg, params, n_slots=args.slots, max_len=args.max_len,
                 sampler=SamplerConfig(temperature=args.temperature,
                                       seed=args.seed),
                 eos_id=-1,
                 prefill_chunk=args.prefill_chunk,
                 prefill_mode=args.prefill_mode,
                 prefix_cache_entries=args.prefix_cache_entries,
                 kv_layout=args.kv_layout,
                 kv_page_size=args.kv_page_size,
                 kv_pages=args.kv_pages,
                 faults=injector,
                 default_deadline_s=args.deadline_s,
                 max_queue=args.max_queue)

    if args.flight_dir:
        flight.enable()
        flight.attach_tracer(obs.tracer)
        flight.add_metrics_source(eng.metrics_snapshot)
        if injector is not None:
            flight.add_metrics_source(injector.metrics)
        if threading.current_thread() is threading.main_thread():
            # signal.signal is main-thread-only; tests driving main() from
            # a worker thread still get crash/exhaustion dumps
            flight.install_signal_handler(
                args.flight_dir,
                callback=lambda p: print(f"[flight] wrote {p}", flush=True))
    server = None
    if args.metrics_port is not None:
        server = obs.ObsServer(
            port=args.metrics_port,
            registries=[eng.metrics, obs.metrics]
            + ([injector.metrics] if injector is not None else []),
            health=eng.liveness,
            requests=eng.debug_requests,
            flight=flight)
        port = server.start()
        last_server = server
        print(f"[obs] live plane on http://127.0.0.1:{port}"
              f"  (/metrics /healthz /debug/requests /debug/flight)",
              flush=True)

    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, cfg.vocab_size, args.shared_prefix).tolist()
    t0 = time.time()
    for _ in range(args.requests):
        plen = int(rng.integers(2, 12))
        prompt = shared + rng.integers(0, cfg.vocab_size, plen).tolist()
        eng.submit(prompt, max_new=args.max_new)
    try:
        eng.run()
    except BaseException as e:
        if args.flight_dir:
            path = flight.crash_dump(args.flight_dir, e)
            print(f"[flight] crash dump: {path}", flush=True)
        if server is not None:
            server.stop()
        raise
    eng.liveness.done()
    dt = time.time() - t0
    res = eng.results()
    total = sum(len(v) for v in res.values())
    for rid, toks in sorted(res.items()):
        print(f"req {rid:3d}: {len(toks)} tokens  {toks[:8]}...", flush=True)
    print(f"[served] {len(res)} requests, {total} tokens in {dt:.1f}s "
          f"({total/dt:.1f} tok/s)  prefill={eng.prefill_mode}  "
          f"device={device}", flush=True)
    snap = eng.metrics_snapshot()
    for key in ("serving.prefix_cache.hits", "serving.prefix_cache.misses",
                "serving.prefix_cache.evictions", "serving.prefill_chunks",
                "serving.kv.pages_shared", "serving.kv.pages_copied",
                "serving.kv.cow_splits", "serving.kv.admit_blocked",
                "serving.kv.free_pages", "serving.kv.pool_occupancy"):
        if key in snap:
            print(f"  {key}: {snap[key].get('value')}", flush=True)
    if injector is not None:
        for key, s in sorted(snap.items()):
            if key.startswith(("serving.requests_completed.",
                               "serving.watchdog.", "serving.faults.",
                               "serving.degraded")):
                print(f"  {key}: {s.get('value')}", flush=True)
        for key, s in sorted(injector.metrics.snapshot().items()):
            print(f"  {key}: {s.get('value')}", flush=True)
        print(f"  faults.remaining: {injector.remaining()}", flush=True)
    if args.flight_dir and injector is not None:
        # every chaos run leaves a forensic artifact: the fault plan ran
        # to exhaustion (or partway) and the ring holds what happened
        reason = ("fault-plan-exhausted" if injector.remaining() == 0
                  else "chaos-run-end")
        path = flight.dump(args.flight_dir, reason=reason)
        print(f"[flight] wrote {path}", flush=True)
    if args.trace:
        obs.write_chrome_trace(args.trace, obs.tracer.drain())
        print(f"[trace] wrote {args.trace}", flush=True)
    if server is not None:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
