"""Trace/metrics export: Chrome trace-event JSON (Perfetto-loadable), a
plain hierarchical text summary, and an OpenMetrics text exposition of a
metrics registry.  A copy of ``repro.obs.export``, which imports no JAX.

The trace format is the Trace Event Format's JSON-object flavor:
``{"traceEvents": [...], "displayTimeUnit": "ms"}`` with "X" (complete)
events carrying ``ts``/``dur`` in microseconds.  Load the file at
https://ui.perfetto.dev or chrome://tracing.
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional

__all__ = ["write_chrome_trace", "load_chrome_trace", "event_tree",
           "text_summary", "to_openmetrics"]


def write_chrome_trace(path: str, events: List[Dict[str, Any]],
                       metadata: Optional[Dict[str, Any]] = None) -> str:
    doc = {"traceEvents": list(events), "displayTimeUnit": "ms"}
    if metadata:
        doc["otherData"] = metadata
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def load_chrome_trace(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):          # array flavor is also legal
        return doc
    return doc["traceEvents"]


def _om_name(name: str) -> str:
    """Registry names are dotted (``serving.tokens``); OpenMetrics names
    are ``[a-zA-Z_:][a-zA-Z0-9_:]*``.  Dots become underscores and any
    other illegal character is dropped."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name.replace(".", "_"))
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _om_num(v: Any) -> str:
    """Stable OpenMetrics number rendering: ints stay integral, floats use
    repr (shortest round-trip form, deterministic across runs)."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def to_openmetrics(source: Any) -> str:
    """Render a metrics `Registry` (or its `.snapshot()` dict) in the
    OpenMetrics text exposition format.

    Counters become ``<name>_total``; gauges expose their last value
    (unset gauges are skipped).  Histograms with cumulative bucket
    counts (`registry.Histogram` snapshots carry ``buckets``) export as
    proper OpenMetrics histograms — ``<name>_bucket{le="..."}`` lines
    cumulative up to the mandatory ``le="+Inf"``, plus
    ``_count``/``_sum``; snapshot dicts without bucket data (foreign or
    pre-bucket snapshots) fall back to the quantile-summary exposition.
    Output is fully deterministic for a given registry state (sorted
    names, stable number formatting), which is what makes it
    golden-testable, and ends with the mandatory ``# EOF`` terminator.
    """
    snap = source.snapshot() if hasattr(source, "snapshot") else dict(source)
    lines: List[str] = []
    for name in sorted(snap):
        s = snap[name]
        om = _om_name(name)
        kind = s.get("type")
        if kind == "counter":
            lines.append(f"# TYPE {om} counter")
            lines.append(f"{om}_total {_om_num(s['value'])}")
        elif kind == "gauge":
            if s.get("value") is None:
                continue
            lines.append(f"# TYPE {om} gauge")
            lines.append(f"{om} {_om_num(s['value'])}")
        elif kind == "histogram":
            buckets = s.get("buckets")
            if buckets:
                lines.append(f"# TYPE {om} histogram")
                for le, n in buckets:
                    le_s = "+Inf" if le == "+Inf" else _om_num(le)
                    lines.append(f'{om}_bucket{{le="{le_s}"}} {_om_num(n)}')
            else:
                lines.append(f"# TYPE {om} summary")
                for q, key in (("0.5", "p50"), ("0.9", "p90"),
                               ("0.99", "p99")):
                    if key in s:
                        lines.append(f'{om}{{quantile="{q}"}} '
                                     f"{_om_num(s[key])}")
            lines.append(f"{om}_count {_om_num(s.get('count', 0))}")
            lines.append(f"{om}_sum {_om_num(s.get('sum', 0.0))}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def event_tree(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Reconstruct span nesting from "X" events by interval containment
    within each (pid, tid) track.  Returns a forest of
    ``{"name", "ts", "dur", "args", "children": [...]}`` nodes sorted by
    start time."""
    xs = [e for e in events if e.get("ph") == "X"]
    tracks: Dict[Any, List[Dict[str, Any]]] = {}
    for e in xs:
        tracks.setdefault((e.get("pid", 0), e.get("tid", 0)), []).append(e)
    roots: List[Dict[str, Any]] = []
    for _key, evs in sorted(tracks.items()):
        # sort: earlier start first; on ties, longer (outer) span first
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: List[Dict[str, Any]] = []
        for e in evs:
            node = {"name": e["name"], "ts": e["ts"],
                    "dur": e.get("dur", 0), "args": e.get("args", {}),
                    "children": []}
            end = node["ts"] + node["dur"]
            while stack and node["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
                stack.pop()
            if stack and end <= stack[-1]["ts"] + stack[-1]["dur"] + 1e-9:
                stack[-1]["children"].append(node)
            else:
                roots.append(node)
            stack.append(node)
    roots.sort(key=lambda n: n["ts"])
    return roots


def _aggregate(nodes: List[Dict[str, Any]],
               out: Dict[str, Dict[str, float]]) -> None:
    for n in nodes:
        agg = out.setdefault(n["name"], {"count": 0, "total_us": 0.0})
        agg["count"] += 1
        agg["total_us"] += n["dur"]
        _aggregate(n["children"], out)


def text_summary(events: List[Dict[str, Any]], max_depth: int = 6,
                 max_children: int = 8) -> str:
    """Hierarchical plain-text rendering of a trace, plus per-name
    aggregate totals."""
    roots = event_tree(events)
    lines: List[str] = []

    def fmt(n: Dict[str, Any], depth: int) -> None:
        if depth >= max_depth:
            return
        ms = n["dur"] / 1e3
        args = ""
        if n["args"]:
            args = "  " + ", ".join(f"{k}={v}" for k, v in n["args"].items())
        lines.append(f"{'  ' * depth}{n['name']:<24s} {ms:10.3f} ms{args}")
        shown = n["children"][:max_children]
        for c in shown:
            fmt(c, depth + 1)
        hidden = len(n["children"]) - len(shown)
        if hidden > 0:
            lines.append(f"{'  ' * (depth + 1)}... {hidden} more")

    for r in roots[:64]:
        fmt(r, 0)

    agg: Dict[str, Dict[str, float]] = {}
    _aggregate(roots, agg)
    if agg:
        lines.append("")
        lines.append(f"{'span':<24s} {'count':>8s} {'total ms':>12s} "
                     f"{'mean ms':>10s}")
        for name in sorted(agg, key=lambda k: -agg[k]["total_us"]):
            a = agg[name]
            lines.append(
                f"{name:<24s} {int(a['count']):>8d} "
                f"{a['total_us'] / 1e3:>12.3f} "
                f"{a['total_us'] / 1e3 / max(a['count'], 1):>10.3f}")
    return "\n".join(lines)
