"""End-to-end training CLI: the twin of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch h2o-danube-1.8b --steps 3 --seq 8192 --batch 2 \
        --microbatch 1

Runs on the GPU (``--device cuda``, the default) at the config's full
width, or on the CPU with ``--device cpu`` (use ``--reduced`` there):

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch h2o-danube-1.8b --reduced --device cpu --steps 4 \
        --seq 32 --batch 4 --log-every 2

Without a GPU and without ``--device cpu`` it raises.  Weights are
random from seed 0 (``TrainConfig.seed``); the data is the synthetic LM
stream addressed by (seed, step), so ``--ckpt`` with ``--restore auto``
resumes exactly.  The flags are the JAX CLI's, plus ``--device``;
``--mesh`` raises ``NotImplementedError`` (sharding is ROADMAP Queue 1,
item 6).  The observability plane (``--trace``, ``--metrics-port``,
``--flight-dir``) and ``--chaos-seed`` (a seeded fault plan through
``training.resilient``) are wired as in ``launch/serve.py``.

A caller that drives ``main`` may pass a list as `history`: each logged
step's record (step, loss, ce, grad norm, lr; in the fault-free loop
every step, with its seconds and peak GB) is appended to it.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import threading
import time
from typing import Dict, List, Optional

import torch

from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import (ARCH_IDS, ShapeConfig, TrainConfig,
                                 get_config, reduced_config)
from repro_torch.data.pipeline import Loader, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.common import dtype_of
from repro_torch.obs.flight import flight
from repro_torch.training import loop as tl

# the most recent ObsServer started by main() (see launch/serve.py)
last_server: obs.ObsServer = None


def main(argv=None, history: Optional[List[Dict[str, float]]] = None
         ) -> int:
    global last_server
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", choices=("auto", "none"), default="auto")
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--compression", choices=("none", "int8"),
                    default="none")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace of the run here")
    ap.add_argument("--chaos-seed", type=int, default=None, metavar="SEED",
                    help="inject a seeded fault plan (transient step "
                         "crashes, corrupt checkpoint shards) and run "
                         "through the recovery loop")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="transient-fault restarts before giving up")
    ap.add_argument("--grad-skip-threshold", type=float, default=0.0,
                    help="skip optimizer updates whose global grad norm "
                         "is non-finite or above this (0 = off)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve /metrics + /healthz on this port; 0 picks "
                         "an ephemeral port; default off")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="enable the flight recorder; dumps flight_*.json "
                         "here on crash or SIGUSR1")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh: sharded training comes with the distributed slice of "
            "the port (ROADMAP Queue 1, item 6)")
    device = resolve_device(args.device)
    if args.trace:
        obs.enable_tracing()
    if history is None:
        history = []

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     microbatch=args.microbatch or None,
                     grad_compression=args.compression,
                     grad_skip_threshold=args.grad_skip_threshold)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")

    state = tl.init_train_state(cfg, tc, device=device)
    step_fn = tl.make_train_step(cfg, tc)
    loader = Loader(SyntheticLM(cfg, shape, seed=tc.seed), device=device,
                    model_dtype=dtype_of(cfg.dtype))
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"[train] {cfg.name}{' (reduced)' if args.reduced else ''} "
          f"{n_params / 1e9:.3f}B params {cfg.dtype}, seq {args.seq} "
          f"batch {args.batch} microbatch {args.microbatch or args.batch} "
          f"remat {tc.remat}, device={device}", flush=True)

    injector = None
    if args.chaos_seed is not None:
        from repro_torch import faults
        injector = faults.FaultInjector(
            faults.training_plan(args.chaos_seed, horizon=args.steps))

    # live observability plane (default off; see launch/serve.py)
    live = obs.Liveness(max_age_s=300.0)    # full-width steps take seconds
    if args.flight_dir:
        flight.enable()
        flight.attach_tracer(obs.tracer)
        flight.add_metrics_source(obs.metrics)
        if injector is not None:
            flight.add_metrics_source(injector.metrics)
        if threading.current_thread() is threading.main_thread():
            flight.install_signal_handler(
                args.flight_dir,
                callback=lambda p: print(f"[flight] wrote {p}", flush=True))
    server = None
    if args.metrics_port is not None:
        server = obs.ObsServer(
            port=args.metrics_port,
            registries=[obs.metrics]
            + ([injector.metrics] if injector is not None else []),
            health=live, flight=flight)
        port = server.start()
        last_server = server
        print(f"[obs] live plane on http://127.0.0.1:{port}"
              f"  (/metrics /healthz /debug/flight)", flush=True)

    start = 0
    mgr = None
    if args.ckpt:
        mgr = CheckpointManager(args.ckpt, keep=3, injector=injector)
        if args.restore == "auto":
            got = mgr.restore_latest(state)
            if got is not None:
                start, state, meta = got
                loader.load_state_dict({"step": meta.get("data_step", start),
                                        "seed": tc.seed})
                print(f"[restore] resumed from step {start}", flush=True)
        # the step writes every tensor of `state` in place (opt.step
        # too) and runs inside mgr.held(), so the flush reads the state
        # and the data cursor of the last whole step
        mgr.install_preemption_flush(lambda: (loader.step, state))

    try:
        if injector is not None:
            _train_chaos(args, state, step_fn, loader, mgr, live, injector,
                         start, history)
        else:
            _train_plain(args, state, step_fn, loader, mgr, live, shape,
                         start, device, history)
    except BaseException as e:
        if args.flight_dir:
            path = flight.crash_dump(args.flight_dir, e)
            print(f"[flight] crash dump: {path}", flush=True)
        if server is not None:
            server.stop()
        raise
    live.done()
    if injector is not None and args.flight_dir:
        reason = ("fault-plan-exhausted" if injector.remaining() == 0
                  else "chaos-run-end")
        path = flight.dump(args.flight_dir, reason=reason)
        print(f"[flight] wrote {path}", flush=True)
    if args.trace:
        obs.write_chrome_trace(args.trace, obs.tracer.drain())
        print(f"[trace] wrote {args.trace}", flush=True)
    if server is not None:
        server.stop()
    print("[done]", flush=True)
    return 0


def _train_chaos(args, state, step_fn, loader, mgr, live, injector, start,
                 history):
    """Chaos mode: the recovery loop (sync checkpoints, auto-resume from
    the newest verified checkpoint on a crash)."""
    from repro_torch.training.resilient import train_with_recovery

    def on_step(step, st, metrics):
        live.beat()
        if step % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, **m})
            print(f"step {step:5d}  loss {m['loss']:.4f}  "
                  f"gnorm {m['grad_norm']:.2f}", flush=True)

    _, restarts = train_with_recovery(
        state, step_fn, loader, total_steps=args.steps, start_step=start,
        manager=mgr, checkpoint_every=args.ckpt_every if mgr else 0,
        injector=injector, max_restarts=args.max_restarts,
        registry=obs.metrics, on_step=on_step)
    print(f"[chaos] restarts={restarts} "
          f"faults_remaining={injector.remaining()}", flush=True)
    for key, s in sorted(injector.metrics.snapshot().items()):
        print(f"  {key}: {s.get('value')}", flush=True)


def _train_plain(args, state, step_fn, loader, mgr, live, shape, start,
                 device, history):
    """The fault-free loop.  Every step is timed between device syncs
    (the loss is read each step), so a line's step ms and tokens/s are
    that step's own."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    held = mgr.held if mgr else contextlib.nullcontext
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        live.beat()
        with held():
            batch = next(loader)
            t_step = time.perf_counter()
            with obs.trace.span("train_step", step=step + 1):
                state, metrics = step_fn(state, batch)
        m = {k: float(v) for k, v in metrics.items()}   # syncs
        dt = time.perf_counter() - t_step
        peak = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else 0.0
        history.append({"step": step + 1, "step_s": dt, "peak_gb": peak,
                        **m})
        if (step + 1) % args.log_every == 0 or step == start:
            tl.record_step_metrics(obs.metrics, m, step=step + 1,
                                   tokens=shape.tokens, dt=dt)
            tok_s = shape.tokens * (step + 1 - start) \
                / (time.perf_counter() - t0)
            print(f"step {step + 1:5d}  loss {m['loss']:.4f}  "
                  f"ce {m['ce']:.4f}  gnorm {m['grad_norm']:.2f}  "
                  f"lr {m['lr']:.2e}  step {1e3 * dt:.1f} ms  "
                  f"tok/s {shape.tokens / dt:,.0f} (run {tok_s:,.0f})"
                  + (f"  peak {peak:.2f} GB" if cuda else ""), flush=True)
        if mgr and (step + 1) % args.ckpt_every == 0:
            with obs.trace.span("checkpoint", step=step + 1):
                mgr.async_save(step + 1, state, {"data_step": loader.step})
    if mgr:
        mgr.wait()
        mgr.save(args.steps, state, {"data_step": loader.step})


if __name__ == "__main__":
    sys.exit(main())
