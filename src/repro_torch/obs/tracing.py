"""Span tracing: nestable spans with monotonic timestamps (a copy of
``repro.obs.tracing``, which imports no JAX).

Off by default.  When disabled, ``span(...)`` returns a shared no-op
context manager — the cost is one attribute read and one function call,
no allocation, no clock read.  Enable with ``tracer.enable()`` (or
``repro_torch.obs.enable_tracing()``).

    from repro_torch.obs import trace
    with trace.span("prefill", rid=3):
        ...
    trace.span("step")(fn)          # decorator form

Finished spans accumulate as "complete" events (Chrome trace-event
``ph: "X"``) which ``repro_torch.obs.export`` writes as
Perfetto-loadable JSON.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Tracer", "tracer", "trace"]


class _NoopSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return fn


_NOOP = _NoopSpan()


class Span:
    __slots__ = ("tracer", "name", "args", "t0", "tid", "depth")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0
        self.tid = 0
        self.depth = 0

    def __enter__(self) -> "Span":
        local = self.tracer._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
        self.depth = len(stack)
        stack.append(self)
        self.tid = threading.get_ident()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        self.tracer._local.stack.pop()
        self.tracer._record(self, t1)
        return False

    def __call__(self, fn):
        """Decorator form: ``@trace.span("name")``."""
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with Span(self.tracer, self.name, self.args):
                return fn(*a, **kw)
        return wrapped


class Tracer:
    """Collects finished spans as Chrome trace "complete" events."""

    def __init__(self) -> None:
        self.enabled = False
        self.events: List[Dict[str, Any]] = []
        self._local = threading.local()
        self._lock = threading.Lock()
        # trace timestamps are relative to tracer creation so they stay
        # small and Perfetto's timeline starts near zero
        self._epoch_ns = time.perf_counter_ns()
        # optional event sinks (e.g. the flight recorder mirrors span
        # close events into its ring); empty list on the default path
        self._sinks: List[Any] = []

    def add_sink(self, fn) -> None:
        """`fn(event_dict)` is called for every recorded event.  Used by
        the flight recorder to mirror span open/close into its ring."""
        if fn not in self._sinks:
            self._sinks.append(fn)

    def remove_sink(self, fn) -> None:
        if fn in self._sinks:
            self._sinks.remove(fn)

    # -- control -----------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self.events = []

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **args):
        """Context manager / decorator; no-op (shared object) when
        disabled."""
        if not self.enabled:
            return _NOOP
        return Span(self, name, args)

    def instant(self, name: str, *, pid: int = 0,
                tid: Optional[int] = None, **args) -> None:
        """Zero-duration marker event.  `pid`/`tid` place the marker on
        an explicit track (request timelines use pid=1, tid=rid); the
        default is the calling thread's track."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": (time.perf_counter_ns() - self._epoch_ns) / 1e3,
              "pid": pid,
              "tid": (threading.get_ident() & 0xFFFF) if tid is None
              else tid}
        if args:
            ev["args"] = args
        self._append(ev)

    def complete(self, name: str, t0_s: float, t1_s: float, *,
                 pid: int = 0, tid: Optional[int] = None, **args) -> None:
        """Record an explicit-interval "X" event from perf_counter
        timestamps (seconds).  This is how request-scoped timelines are
        built: the caller keeps its own start/end marks (e.g. submit and
        admit times) and lays the interval on a per-request track
        (pid, tid) instead of the calling thread's."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X",
              "ts": (t0_s * 1e9 - self._epoch_ns) / 1e3,     # microseconds
              "dur": max((t1_s - t0_s) * 1e6, 0.001),
              "pid": pid,
              "tid": (threading.get_ident() & 0xFFFF) if tid is None
              else tid}
        if args:
            ev["args"] = args
        self._append(ev)

    def thread_name(self, pid: int, tid: int, label: str) -> None:
        """Metadata event naming a (pid, tid) track — Perfetto shows the
        label instead of the raw tid (e.g. "req 3" for request tracks)."""
        if not self.enabled:
            return
        self._append({"name": "thread_name", "ph": "M", "pid": pid,
                      "tid": tid, "args": {"name": label}})

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self.events.append(ev)
        for sink in self._sinks:
            sink(ev)

    def _record(self, sp: Span, t1_ns: int) -> None:
        ev = {"name": sp.name, "ph": "X",
              "ts": (sp.t0 - self._epoch_ns) / 1e3,          # microseconds
              "dur": max((t1_ns - sp.t0) / 1e3, 0.001),
              "pid": 0, "tid": sp.tid & 0xFFFF}
        if sp.args:
            ev["args"] = dict(sp.args)
        self._append(ev)

    # -- draining ----------------------------------------------------------

    def drain(self) -> List[Dict[str, Any]]:
        """Return and clear the buffered events."""
        with self._lock:
            evs, self.events = self.events, []
        return evs

    def snapshot_events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self.events)


# the process-global tracer; `trace` is the conventional alias
tracer = Tracer()
trace = tracer
