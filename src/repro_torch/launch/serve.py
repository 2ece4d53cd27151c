"""Serving CLI: batched requests through the warp-scheduler engine.
The twin of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi3-mini-3.8b --requests 3 --max-new 8

Runs on the GPU (``--device cuda``, the default) at the config's full
width, or on the CPU with ``--device cpu`` (use ``--reduced`` there).
Without a GPU and without ``--device cpu`` it raises.  Weights are
random, from ``--seed``.  Each request prints ``max_new + 1`` tokens
(the prefill token plus the decodes).

The paged KV layout, fault injection (``--chaos-seed``) and the
observability plane (``--trace``, ``--metrics-port``, ``--flight-dir``)
come with later slices: those flags raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampler import SamplerConfig

_LATER = {"trace": "the tracing plane", "chaos_seed": "fault injection",
          "metrics_port": "the HTTP metrics plane",
          "flight_dir": "the flight recorder"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
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
                    help="KV cache layout ('paged' comes with a later "
                         "slice of the port)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request TTL; expired requests finish with "
                         "reason 'timeout'")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission queue; overflow is shed")
    ap.add_argument("--trace", default=None, metavar="PATH")
    ap.add_argument("--chaos-seed", type=int, default=None, metavar="SEED")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT")
    ap.add_argument("--flight-dir", default=None, metavar="DIR")
    args = ap.parse_args(argv)

    for flag, what in _LATER.items():
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: {what} comes with a later "
                "slice of the port")
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = api.build_params(cfg, gen, device=device)
    eng = Engine(cfg, params, n_slots=args.slots, max_len=args.max_len,
                 sampler=SamplerConfig(temperature=args.temperature,
                                       seed=args.seed),
                 eos_id=-1,
                 prefill_chunk=args.prefill_chunk,
                 prefill_mode=args.prefill_mode,
                 prefix_cache_entries=args.prefix_cache_entries,
                 kv_layout=args.kv_layout,
                 default_deadline_s=args.deadline_s,
                 max_queue=args.max_queue)

    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, cfg.vocab_size, args.shared_prefix).tolist()
    t0 = time.time()
    for _ in range(args.requests):
        plen = int(rng.integers(2, 12))
        prompt = shared + rng.integers(0, cfg.vocab_size, plen).tolist()
        eng.submit(prompt, max_new=args.max_new)
    eng.run()
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
                "serving.prefix_cache.evictions", "serving.prefill_chunks"):
        if key in snap:
            print(f"  {key}: {snap[key].get('value')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
