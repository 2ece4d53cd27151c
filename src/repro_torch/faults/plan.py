"""Deterministic fault-injection plans (a copy of ``repro.faults.plan``,
with its telemetry imports pointed at the port's ``obs``).

A `FaultPlan` is a seeded schedule of `Fault`s keyed by (site, at):
`site` names an injection hook (one hook site per subsystem poll point,
so each site has its own monotonic cursor), `at` is the 0-based index of
the poll at that site.  Plans are either constructed explicitly (tests
pin exact faults) or generated from a seed + per-(site, kind) rates —
the same seed always produces the identical schedule, which is what
makes chaos runs replayable.

A `FaultInjector` walks a plan: every `poll(site)` advances that site's
cursor and returns (and consumes) the faults scheduled for it.  Each
fault fires exactly once — after a recovery the replayed steps do NOT
re-fire it, mirroring a real transient fault.  Every injected fault is
counted in the injector's obs registry (`faults.injected` and
`faults.injected.<site>.<kind>`), so chaos runs are observable.

Sites and kinds in use across the stack:

  serving.logits     nan_logits | inf_logits   corrupt the decode logits
  serving.prefill    slow | hang               delay the prefill tick (arg=s)
  serving.decode     slow | hang               delay the decode tick (arg=s)
  serving.step       exception                 raise TransientFault in step()
  train.step         exception                 raise TransientFault pre-step
  ckpt.save          corrupt                   flip bytes in the saved shard
  pod                pod_stall | pod_fail      stall/fail pod `arg` this step

Vortex framing: faults are the software analogue of lanes dropping out
of a warp — the point of the plan is to prove the masks above (request
slots, pods) keep the machine making progress instead of falling over.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.obs.flight import flight

__all__ = ["Fault", "FaultPlan", "FaultInjector", "TransientFault",
           "DEFAULT_ARGS"]


class TransientFault(RuntimeError):
    """An injected, retryable failure (the chaos analogue of a flaky
    collective / preempted device).  Watchdogs catch exactly this type —
    real programming errors still propagate."""


@dataclasses.dataclass(frozen=True, order=True)
class Fault:
    site: str
    at: int            # 0-based poll index at `site`
    kind: str
    arg: float = 0.0   # seconds for delays, pod index for pod faults, ...


# default `arg` per kind when a generated plan doesn't specify one
DEFAULT_ARGS: Dict[str, float] = {
    "slow": 0.05,
    "hang": 0.5,
}


class FaultPlan:
    """An immutable, seeded schedule of faults."""

    def __init__(self, faults: Sequence[Fault] = (), seed: int = 0):
        self.seed = seed
        self.faults: Tuple[Fault, ...] = tuple(sorted(faults))

    def schedule(self) -> Tuple[Fault, ...]:
        """The full schedule, sorted — two plans generated from the same
        seed compare equal here (the replay-determinism contract)."""
        return self.faults

    def __len__(self) -> int:
        return len(self.faults)

    def __eq__(self, other) -> bool:
        return (isinstance(other, FaultPlan)
                and self.faults == other.faults)

    @classmethod
    def generate(cls, seed: int, *, horizon: int = 64,
                 rates: Dict[Tuple[str, str], float],
                 args: Optional[Dict[Tuple[str, str], float]] = None,
                 n_pods: int = 0) -> "FaultPlan":
        """Sample a schedule: for each (site, kind) with rate p, each of
        the `horizon` polls independently carries that fault with
        probability p.  Iteration order over `rates` is sorted and each
        (site, kind) consumes a seed-derived substream, so the schedule
        is a pure function of (seed, horizon, rates, args, n_pods) —
        independent of dict insertion order.
        """
        args = args or {}
        faults: List[Fault] = []
        for i, (site, kind) in enumerate(sorted(rates)):
            rng = np.random.default_rng(
                np.random.SeedSequence([seed, i]))
            hits = np.flatnonzero(rng.random(horizon) < rates[(site, kind)])
            for t in hits:
                if kind.startswith("pod_"):
                    arg = float(rng.integers(0, max(n_pods, 1)))
                else:
                    arg = args.get((site, kind), DEFAULT_ARGS.get(kind, 0.0))
                faults.append(Fault(site, int(t), kind, arg))
        return cls(faults, seed)


class FaultInjector:
    """Walks a `FaultPlan`, one cursor per site.  Hooks are zero-cost
    when absent: subsystems hold `injector = None` by default and guard
    every call site with a single `is not None` check."""

    def __init__(self, plan: FaultPlan,
                 registry: Optional[obs.Registry] = None):
        self.plan = plan
        self.metrics = registry if registry is not None else obs.Registry()
        self._cursor: Dict[str, int] = {}
        self._pending: Dict[Tuple[str, int], List[Fault]] = {}
        for f in plan.faults:
            self._pending.setdefault((f.site, f.at), []).append(f)

    def poll(self, site: str) -> List[Fault]:
        """Advance `site`'s cursor; return (and consume) the faults due."""
        t = self._cursor.get(site, 0)
        self._cursor[site] = t + 1
        fired = self._pending.pop((site, t), [])
        for f in fired:
            self.metrics.counter("faults.injected").inc()
            self.metrics.counter(f"faults.injected.{f.site}.{f.kind}").inc()
            # forensics: every firing lands in the flight ring (no-op
            # when the recorder is off), so a crash dump shows exactly
            # which injected faults preceded it
            flight.record("fault.fired", site=f.site, fault=f.kind,
                          at=f.at, arg=f.arg)
        return fired

    # -- typed convenience hooks (each owns its site's poll for the tick) --

    def logit_fault_code(self, site: str = "serving.logits") -> int:
        """0 = none, 1 = NaN, 2 = +Inf — fed to the jitted step as a
        traced scalar so injection never changes compile cache shape."""
        for f in self.poll(site):
            if f.kind == "nan_logits":
                return 1
            if f.kind == "inf_logits":
                return 2
        return 0

    def delay_s(self, site: str) -> float:
        """Total injected delay (seconds) for this tick at `site`."""
        return sum(f.arg for f in self.poll(site)
                   if f.kind in ("slow", "hang"))

    def check_raise(self, site: str) -> None:
        """Raise `TransientFault` if one is scheduled at `site` now."""
        for f in self.poll(site):
            if f.kind == "exception":
                raise TransientFault(f"injected fault at {site} "
                                     f"(poll {self._cursor[site] - 1})")

    def remaining(self) -> int:
        """Faults not yet fired (chaos-suite sanity: a finished run with
        remaining() > 0 means a hook site was never reached)."""
        return sum(len(v) for v in self._pending.values())
