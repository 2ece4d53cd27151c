"""Telemetry for the port: the metrics registry only.  The tracing,
flight-recorder and HTTP planes of ``repro.obs`` come with a later
slice."""
from repro_torch.obs.registry import (Counter, Gauge, Histogram, Registry,
                                      bump, device_counters, merge_device,
                                      metrics)

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "metrics",
           "device_counters", "bump", "merge_device"]
