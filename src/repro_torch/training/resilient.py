"""Failure-hardened training loop: the twin of
``repro.training.resilient`` — the train loop wrapped in a watchdog that
survives transient step crashes by restoring the newest *verified*
checkpoint and rewinding the data cursor.

Recovery contract (as in the JAX package):

  * a `TransientFault` triggers a capped-exponential-backoff restart;
  * restart restores via `CheckpointManager.restore_latest`, which walks
    newest -> oldest past corrupt or torn checkpoints and writes the
    restored leaves into the state's tensors in place;
  * the data pipeline is (seed, step)-addressed, so the rewind is a
    cursor assignment;
  * faults fire exactly once, so replayed steps do not re-crash.

With a ``distributed.elastic.Fleet``, scheduled pod faults become
barrier waits, as in the JAX loop: stalled pods drop out of the fleet
step's masked-mean gradient reduce and rejoin later, failed pods leave
for good.

The step mutates the state in place, but a fault fires before the step
runs (before the loader advances), so a recovery without a checkpoint
continues from an untouched state.  Each pass of the loop (a step and
its checkpoint, or a recovery) runs inside the manager's ``held()``, so
a preemption flush sees the state and the data cursor between passes.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.faults.plan import FaultInjector, TransientFault
from repro_torch.obs.flight import flight
from repro_torch.training.loop import TrainState, _split_batch


def _pod_waits(injector: FaultInjector, fleet) -> np.ndarray:
    """Convert this step's scheduled pod faults into barrier waits (a
    stalled pod reports a wait past the policy deadline) and permanent
    failures."""
    n = fleet.masks.n_pods
    waits = np.zeros(n, np.float64)
    for f in injector.poll("pod"):
        pod = int(f.arg) % n
        if f.kind == "pod_stall":
            waits[pod] = fleet.policy.deadline_s + 1.0
        elif f.kind == "pod_fail":
            fleet.masks.fail(pod)
    return waits


def train_with_recovery(
    state: TrainState,
    step_fn: Callable,
    loader,
    *,
    total_steps: int,
    start_step: int = 0,
    manager=None,
    checkpoint_every: int = 0,
    injector: Optional[FaultInjector] = None,
    max_restarts: int = 3,
    backoff_base_s: float = 0.01,
    backoff_max_s: float = 0.5,
    registry=None,
    on_step: Optional[Callable[[int, TrainState, Dict], None]] = None,
    fleet=None,
) -> Tuple[TrainState, int]:
    """Run `step_fn` from `start_step` to `total_steps`, recovering from
    `TransientFault`s.  Returns (final_state, restarts_used).

    `step_fn(state, batch) -> (state, metrics)`; with `fleet` set the
    signature is `step_fn(state, pod_batch, healthy)` (the fleet step
    from ``loop.make_fleet_train_step``) and batches are pod-split here.
    `on_step(step_1based, state, metrics)` runs after every successful
    step."""
    step = start_step
    restarts = 0
    held = manager.held if manager is not None else contextlib.nullcontext
    while step < total_steps:
        with held():
            try:
                if injector is not None:
                    if fleet is not None:
                        fleet.note_waits(_pod_waits(injector, fleet))
                    # fires AFTER the pod bookkeeping, BEFORE the loader
                    # advances, so a recovery replays this step's batch
                    # exactly
                    injector.check_raise("train.step")
                batch = next(loader)
                if fleet is not None:
                    healthy = np.asarray(fleet.healthy(), np.float32)
                    state, metrics = step_fn(
                        state, _split_batch(batch, fleet.masks.n_pods),
                        healthy)
                else:
                    state, metrics = step_fn(state, batch)
                step += 1
                if on_step is not None:
                    on_step(step, state, metrics)
                if registry is not None:
                    if int(metrics.get("grad_skipped", 0)):
                        registry.counter("train.grad_skips").inc()
                    registry.counter("train.steps").inc()
                if (manager is not None and checkpoint_every
                        and step % checkpoint_every == 0):
                    manager.save(step, state, {"data_step": loader.step})
            except TransientFault as e:
                restarts += 1
                if registry is not None:
                    registry.counter("train.recoveries").inc()
                    registry.gauge("train.recovery.restarts").set(restarts)
                if restarts > max_restarts:
                    flight.record("train.recovery.gave_up", step=step,
                                  restarts=restarts, exc=str(e))
                    raise
                flight.record("train.recovery.restart", step=step,
                              restart=restarts, exc=str(e))
                time.sleep(min(backoff_base_s * (2 ** (restarts - 1)),
                               backoff_max_s))
                got = manager.restore_latest(state) if manager is not None \
                    else None
                if got is not None:
                    step, state, meta = got
                    loader.load_state_dict(
                        {"step": meta.get("data_step", step),
                         "seed": loader.source.seed})
                    flight.record("train.recovery.rewound", step=step)
                # no verified checkpoint: the fault fired before the step
                # mutated state, so continuing in-memory is safe
    if manager is not None and checkpoint_every:
        manager.wait()
        if step % checkpoint_every:
            manager.save(step, state, {"data_step": loader.step})
    return state, restarts
