"""Telemetry of the port: the twin of ``repro.obs``, with the same API.

Everything is **off by default** and safe to leave imported in hot paths:

* metrics: a host-side `Registry` of counters, gauges and histograms,
  with `device_counters` / `bump` / `merge_device` as plain host ints
  merged once per step (PyTorch runs eagerly; see ``registry.py``).
* tracing: `trace.span("name", **args)` context manager / decorator; a
  shared no-op object when disabled, Chrome trace-event ("X") records
  when enabled.  Export with `write_chrome_trace` and open in Perfetto.
* the flight recorder (`flight`), the HTTP plane (`ObsServer` with a
  `Liveness`) and `PerfReport`: copies of the JAX package's modules,
  which import no JAX.
* kernel wrappers: `instrument_kernel` wraps a kernel's public entry
  with launch counting and timing, gated on `enable_kernel_timing()`.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Optional

import torch

from repro_torch.obs.export import (event_tree, load_chrome_trace,
                                    text_summary, to_openmetrics,
                                    write_chrome_trace)
from repro_torch.obs.flight import FlightRecorder, flight, validate_flight
from repro_torch.obs.perf import PerfReport
from repro_torch.obs.registry import (Counter, Gauge, Histogram, Registry,
                                      bump, device_counters, merge_device,
                                      metrics)
from repro_torch.obs.server import Liveness, ObsServer
from repro_torch.obs.tracing import Tracer, trace, tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "metrics",
    "device_counters", "bump", "merge_device",
    "Tracer", "trace", "tracer",
    "write_chrome_trace", "load_chrome_trace", "event_tree", "text_summary",
    "to_openmetrics",
    "PerfReport",
    "FlightRecorder", "flight", "validate_flight",
    "Liveness", "ObsServer",
    "enable_tracing", "disable_tracing", "tracing_enabled",
    "enable_kernel_timing", "disable_kernel_timing",
    "kernel_timing_enabled", "instrument_kernel",
]


# ---------------------------------------------------------------------------
# global switches
# ---------------------------------------------------------------------------

def enable_tracing() -> None:
    tracer.enable()


def disable_tracing() -> None:
    tracer.disable()


def tracing_enabled() -> bool:
    return tracer.enabled


_kernel_timing = False


def enable_kernel_timing() -> None:
    global _kernel_timing
    _kernel_timing = True


def disable_kernel_timing() -> None:
    global _kernel_timing
    _kernel_timing = False


def kernel_timing_enabled() -> bool:
    return _kernel_timing


# ---------------------------------------------------------------------------
# kernel instrumentation
# ---------------------------------------------------------------------------

def _cuda_device(args, kwargs) -> Optional[torch.device]:
    """The device of the first CUDA tensor argument, else None."""
    for x in (*args, *kwargs.values()):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            return x.device
    return None


def instrument_kernel(name: str, fn: Callable,
                      registry: Optional[Registry] = None) -> Callable:
    """Wrap a kernel's public entry with optional launch counting and
    timing.

    Disabled (default): one module-global bool check, then straight into
    `fn`: no counters, no clock reads, no device sync.

    Enabled: bumps ``kernels.<name>.launches`` and records
    ``kernels.<name>.time_s``, the wall time of the call between two
    device syncs (CPU tensors need none).  A call made while the current
    CUDA stream is capturing a graph counts as a launch but is not timed:
    a sync would break the capture, and the kernel runs when the graph is
    replayed (the twin of the JAX wrapper's test for tracers).
    """
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not _kernel_timing:
            return fn(*args, **kwargs)
        reg = registry if registry is not None else metrics
        reg.counter(f"kernels.{name}.launches").inc()
        dev = _cuda_device(args, kwargs)
        if dev is not None and torch.cuda.is_current_stream_capturing():
            return fn(*args, **kwargs)
        with trace.span(f"kernel:{name}"):
            if dev is not None:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if dev is not None:
                torch.cuda.synchronize(dev)
            reg.histogram(f"kernels.{name}.time_s").observe(
                time.perf_counter() - t0)
        return out

    return wrapped
