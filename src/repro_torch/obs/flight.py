"""Crash-forensics flight recorder: a bounded ring buffer of structured
events that dumps a single self-contained ``flight_<ts>.json`` when the
process crashes, a chaos fault plan exhausts, or someone asks
(``SIGUSR1`` / explicit :meth:`FlightRecorder.dump`).  A copy of
``repro.obs.flight``, which imports no JAX; the dump schema is the same,
so one validator reads the dumps of both packages.

The point: every chaos failure yields a *replayable forensic artifact* —
the last N structured events (span closes, fault firings, watchdog
retries, finish reasons, checkpoint save/restore outcomes) plus a
metrics snapshot — instead of a bare stack trace.

Off by default, and the disabled fast path is one attribute read:

    from repro_torch.obs.flight import flight
    flight.record("serving.finish", rid=3, reason="eos")   # no-op when off

    flight.enable()
    ... run ...
    path = flight.dump("/tmp", reason="debug")

Events are plain dicts ``{"seq", "t", "kind", **fields}`` — ``seq`` is a
global monotonic sequence number (survives ring eviction, so a dump
reports how many events were dropped) and ``t`` is seconds since the
recorder's epoch (monotonic clock; the dump carries the epoch's unix
time so timelines can be re-anchored).

`attach_tracer` mirrors finished spans into the ring (kind ``span``), so
a dump interleaves the span timeline with the discrete events.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = ["FlightRecorder", "flight", "validate_flight", "SCHEMA",
           "EVENT_KINDS"]

SCHEMA = "repro.flight/1"

# Every event kind the stack records, by layer.  `validate_flight`
# checks dumps against this table when asked (`strict_kinds=True`) so a
# renamed or mistyped kind fails CI instead of silently orphaning its
# consumers; ad-hoc kinds in user code stay legal by default.
EVENT_KINDS = frozenset({
    # serving engine
    "serving.admit", "serving.first_token", "serving.finish",
    "serving.watchdog.retry", "serving.watchdog.slow_tick",
    "serving.watchdog.gave_up",
    # paged KV pool (serving/kv_pool.py)
    "kv.oom",        # admission blocked: pool can't cover a request
    "kv.evict",      # prefix entry evicted (LRU overflow or pressure)
    "kv.cow",        # copy-on-write split of a shared partial page
    # faults / checkpoint / training
    "fault.fired",
    "ckpt.save", "ckpt.restore",
    "train.recovery.restart", "train.recovery.rewound",
    "train.recovery.gave_up",
    # SIMT machine + recorder plumbing
    "simt.launch", "span", "crash",
})


class FlightRecorder:
    """Bounded ring of structured events with crash-dump plumbing."""

    def __init__(self, capacity: int = 4096) -> None:
        self.enabled = False
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._epoch = time.perf_counter()
        self._epoch_unix = time.time()
        self._tracer = None
        self._metrics_sources: List[Any] = []

    # -- control -----------------------------------------------------------

    def enable(self, capacity: Optional[int] = None) -> None:
        if capacity is not None and capacity != self.capacity:
            with self._lock:
                self.capacity = capacity
                self._ring = deque(self._ring, maxlen=capacity)
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0

    def attach_tracer(self, tracer) -> None:
        """Mirror the tracer's finished spans into the ring as ``span``
        events (name, dur_us, args)."""
        if self._tracer is tracer:
            return
        self._tracer = tracer
        tracer.add_sink(self._span_sink)

    def _span_sink(self, ev: Dict[str, Any]) -> None:
        # mirror spans ("X") and instants ("i"); metadata events are
        # Perfetto presentation detail, not forensics
        if not self.enabled or ev.get("ph") not in ("X", "i"):
            return
        self.record("span", name=ev.get("name"),
                    dur_us=round(ev.get("dur", 0.0), 3),
                    **(ev.get("args") or {}))

    def add_metrics_source(self, source: Any) -> None:
        """A `Registry` (or zero-arg snapshot callable) whose snapshot is
        embedded in every dump — the metric state at the moment of the
        crash rides with the event ring."""
        if source not in self._metrics_sources:
            self._metrics_sources.append(source)

    # -- recording ---------------------------------------------------------

    def record(self, kind: str, **fields: Any) -> None:
        """Append one structured event.  Disabled: a single attribute
        read, no allocation, no clock read."""
        if not self.enabled:
            return
        with self._lock:
            self._seq += 1
            ev = {"seq": self._seq,
                  "t": round(time.perf_counter() - self._epoch, 6),
                  "kind": kind}
            if fields:
                ev.update(fields)
            self._ring.append(ev)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def dropped(self) -> int:
        """Events evicted from the ring (total recorded - retained)."""
        with self._lock:
            return self._seq - len(self._ring)

    # -- dumping -----------------------------------------------------------

    def dump(self, dirpath: str = ".", *, reason: str = "explicit",
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Write ``flight_<ts>.json`` into `dirpath`; returns the path.
        Self-contained: schema id, reason, event ring, drop accounting,
        metrics snapshots, wall-clock anchor."""
        os.makedirs(dirpath, exist_ok=True)
        with self._lock:
            events = list(self._ring)
            seq = self._seq
        metrics: Dict[str, Any] = {}
        for i, src in enumerate(self._metrics_sources):
            try:
                snap = src.snapshot() if hasattr(src, "snapshot") else src()
                metrics[getattr(src, "name", None) or f"registry_{i}"] = snap
            except Exception as e:                     # forensic best-effort
                metrics[f"registry_{i}"] = {"error": repr(e)}
        doc = {
            "schema": SCHEMA,
            "reason": reason,
            "pid": os.getpid(),
            "epoch_unix": self._epoch_unix,
            "written_unix": time.time(),
            "capacity": self.capacity,
            "n_events": len(events),
            "dropped": seq - len(events),
            "events": events,
            "metrics": metrics,
        }
        if extra:
            doc["extra"] = extra
        ts = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        path = os.path.join(dirpath, f"flight_{ts}_{os.getpid()}_{seq}.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, default=str)
        return path

    def install_signal_handler(self, dirpath: str = ".",
                               sig: int = signal.SIGUSR1,
                               callback: Optional[Callable[[str], None]]
                               = None) -> None:
        """Dump on `sig` (default SIGUSR1) — the live-debugging hatch:
        ``kill -USR1 <pid>`` snapshots a running server without stopping
        it.  `callback(path)` runs after the dump (e.g. log the path)."""
        def handler(signum, frame):
            path = self.dump(dirpath, reason=f"signal:{signum}")
            if callback is not None:
                callback(path)
        signal.signal(sig, handler)

    def crash_dump(self, dirpath: str, exc: BaseException) -> Optional[str]:
        """Record the exception and dump; used by `try/except` guards
        around serve/train loops.  Returns the path (None when the
        recorder is disabled)."""
        if not self.enabled:
            return None
        self.record("crash", exc_type=type(exc).__name__, exc=str(exc))
        return self.dump(dirpath, reason="crash",
                         extra={"exc_type": type(exc).__name__,
                                "exc": str(exc)})


def validate_flight(doc: Dict[str, Any], *, strict_kinds: bool = False
                    ) -> None:
    """Schema-validate a flight dump (raises AssertionError).  Checked by
    the chaos CI smoke so dumps stay machine-consumable.

    `strict_kinds=True` additionally requires every event kind to appear
    in :data:`EVENT_KINDS` — use it on dumps produced by the stack's own
    instrumentation (CI smokes); leave it off for dumps that interleave
    ad-hoc user events."""
    assert doc.get("schema") == SCHEMA, f"bad schema: {doc.get('schema')!r}"
    for key in ("reason", "pid", "epoch_unix", "written_unix", "capacity",
                "n_events", "dropped", "events", "metrics"):
        assert key in doc, f"missing key: {key}"
    events = doc["events"]
    assert isinstance(events, list) and len(events) == doc["n_events"]
    assert doc["dropped"] >= 0
    prev_seq = 0
    for ev in events:
        assert isinstance(ev, dict), f"non-dict event: {ev!r}"
        for key in ("seq", "t", "kind"):
            assert key in ev, f"event missing {key}: {ev!r}"
        assert ev["seq"] > prev_seq, "event seq not strictly increasing"
        prev_seq = ev["seq"]
        if strict_kinds:
            assert ev["kind"] in EVENT_KINDS, \
                f"unknown event kind {ev['kind']!r} (add it to EVENT_KINDS)"
    assert isinstance(doc["metrics"], dict)


# the process-global recorder (mirrors `obs.metrics` / `obs.tracer`)
flight = FlightRecorder()
