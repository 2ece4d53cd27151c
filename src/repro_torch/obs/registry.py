"""Metrics registry: counters, gauges, histograms.

A copy of ``repro.obs.registry``, so the port's serving engine keeps
every ``serving.*`` metric name.  The JAX package threads jit-safe
device counters through traced code; here ``device_counters`` and
``bump`` are plain host ints, merged once per step.

    reg = Registry()
    reg.counter("serving.tokens").inc(4)
    reg.gauge("serving.queue_depth").set(3)
    reg.histogram("serving.ttft_s").observe(0.12)
    snap = reg.snapshot()          # plain-dict summary, JSON-serializable
"""
from __future__ import annotations

import bisect
import math
import random
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "metrics",
           "device_counters", "bump", "merge_device", "DEFAULT_BUCKETS"]


# Default `le` bucket boundaries (seconds-flavoured, Prometheus-style
# exponential ladder).  Histograms that record non-latency values (token
# counts, batch widths) still get count/sum/quantiles; their mass just
# piles into the top buckets.  Pass `buckets=` at first creation for a
# bespoke ladder.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0)


class Counter:
    """Monotonic cumulative count."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def summary(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written value (queue depth, loss, occupancy...)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def summary(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Streaming summary: count/sum/min/max, cumulative `le` bucket
    counts (OpenMetrics histogram exposition), plus a fixed-size
    reservoir sample (Vitter's algorithm R) from which quantiles are
    estimated.

    Deterministic: the reservoir RNG is seeded per-instance so snapshots
    are reproducible run-to-run.

    Thread-safe: `observe()` and `summary()` take a per-instrument lock,
    so a scrape thread can never tear a snapshot mid-update (the serving
    engine's decode thread observes while the HTTP plane scrapes).
    """

    __slots__ = ("count", "total", "min", "max", "reservoir", "buckets",
                 "bucket_counts", "_cap", "_rng", "_lock")

    def __init__(self, reservoir_size: int = 512, seed: int = 0,
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.reservoir: List[float] = []
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        # non-cumulative per-bucket counts; the final slot is the +Inf
        # overflow.  Cumulated at summary() time.
        self.bucket_counts: List[int] = [0] * (len(self.buckets) + 1)
        self._cap = reservoir_size
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            # bucket i counts v <= buckets[i] (cumulative-`le` semantics
            # once summed); NaN falls through to the +Inf overflow slot
            self.bucket_counts[bisect.bisect_left(self.buckets, v)
                               if v == v else len(self.buckets)] += 1
            if len(self.reservoir) < self._cap:
                self.reservoir.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self._cap:
                    self.reservoir[j] = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        if not self.reservoir:
            return 0.0
        xs = sorted(self.reservoir)
        idx = min(int(q * len(xs)), len(xs) - 1)
        return xs[idx]

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            if not self.count:
                return {"type": "histogram", "count": 0}
            cum, counts = 0, []
            for c in self.bucket_counts:
                cum += c
                counts.append(cum)
            # reservoir copied under the lock so quantile() sorts a
            # consistent sample even while observe() keeps streaming
            reservoir = list(self.reservoir)
            out = {"type": "histogram", "count": self.count,
                   "sum": self.total, "mean": self.total / self.count,
                   "min": self.min, "max": self.max,
                   "buckets": [[le, n] for le, n
                               in zip(self.buckets, counts)]
                   + [["+Inf", counts[-1]]]}
        xs = sorted(reservoir)

        def q(p: float) -> float:
            return xs[min(int(p * len(xs)), len(xs) - 1)]

        out["p50"], out["p90"], out["p99"] = q(0.50), q(0.90), q(0.99)
        return out


class Registry:
    """Named instruments, created on first use.  Thread-safe creation;
    single-writer updates (the usual engine/train-loop pattern)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, Any] = {}

    def _get(self, name: str, factory):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.setdefault(name, factory())
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        if buckets is None:
            return self._get(name, Histogram)
        return self._get(name, lambda: Histogram(buckets=buckets))

    def names(self) -> Iterable[str]:
        return sorted(self._instruments)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Plain-dict (JSON-serializable) summary of every instrument.

        The instrument table is copied under the registry lock (no
        concurrent `_get` can resize the dict mid-iteration) and each
        histogram summary is taken under its per-instrument lock, so a
        scrape concurrent with `inc()`/`observe()` from the serving
        engine's decode thread never tears."""
        with self._lock:
            items = sorted(self._instruments.items())
        return {k: inst.summary() for k, inst in items}

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


# The process-global registry.  Subsystems that want isolation (e.g. one
# serving Engine per model) create their own Registry instead.
metrics = Registry()


# ---------------------------------------------------------------------------
# step counters
# ---------------------------------------------------------------------------
#
# PyTorch runs eagerly, so the jit-safe device-counter pattern of the JAX
# package becomes plain host ints: a step builds ``{name: int}``, bumps
# it, and merges it into a registry once, after it has read its results
# back from the device.

def device_counters(*names: str) -> Dict[str, int]:
    """A ``{name: 0}`` dict of step counters."""
    return {n: 0 for n in names}


def bump(counters: Dict[str, int], **kw) -> Dict[str, int]:
    """Functional increment (ints or 0-dim tensors, read as ints)."""
    out = dict(counters)
    for k, v in kw.items():
        out[k] = out[k] + int(v)
    return out


def merge_device(registry: Registry, counters: Dict[str, int],
                 prefix: str = "") -> Dict[str, int]:
    """Add step counters into `registry`; returns the values."""
    vals = {k: int(v) for k, v in counters.items()}
    for k, v in vals.items():
        registry.counter(prefix + k).inc(v)
    return vals
