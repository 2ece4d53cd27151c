"""Live observability plane (a copy of ``repro.obs.server``, which
imports no JAX): a stdlib ``http.server`` thread exposing

  ``/metrics``          OpenMetrics text (``to_openmetrics`` over every
                        attached registry, ``le``-bucketed histograms)
  ``/healthz``          liveness JSON derived from watchdog tick age
                        (200 healthy / 503 unhealthy)
  ``/debug/requests``   JSON of in-flight request states (serving)
  ``/debug/flight``     JSON snapshot of the flight-recorder ring

Wire-up is pull-only: the server holds *references* (registries, a
`Liveness`, callables) and renders on GET — nothing is pushed, so
attaching the server never touches the serving/training hot path, and
the default-off discipline holds (no server, no thread, no sockets).

    srv = ObsServer(port=0, registries=[eng.metrics, obs.metrics],
                    health=live, requests=eng.debug_requests,
                    flight=flight)
    port = srv.start()          # port 0 -> ephemeral, returns the real one
    ... curl http://127.0.0.1:<port>/metrics ...
    srv.stop()
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.obs.export import to_openmetrics

__all__ = ["Liveness", "ObsServer", "OPENMETRICS_CONTENT_TYPE"]

OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


class Liveness:
    """Watchdog-tick liveness: the driving loop calls `beat()` once per
    tick; `/healthz` derives health from the age of the last beat.

    States: ``starting`` (no beat yet), ``live`` (beat within
    `max_age_s`), ``stalled`` (beat older than `max_age_s` — the loop is
    wedged), ``finished`` (`done()` called — the run completed, old
    beats are fine)."""

    def __init__(self, max_age_s: float = 5.0) -> None:
        self.max_age_s = max_age_s
        self.beats = 0
        self._last_beat: Optional[float] = None
        self._done = False

    def beat(self) -> None:
        self.beats += 1
        self._last_beat = time.perf_counter()

    def done(self) -> None:
        self._done = True

    def age_s(self) -> Optional[float]:
        if self._last_beat is None:
            return None
        return time.perf_counter() - self._last_beat

    def status(self) -> Dict[str, Any]:
        age = self.age_s()
        if self._done:
            state = "finished"
        elif age is None:
            state = "starting"
        elif age <= self.max_age_s:
            state = "live"
        else:
            state = "stalled"
        return {"healthy": state != "stalled", "state": state,
                "beats": self.beats,
                "last_tick_age_s": None if age is None else round(age, 4),
                "max_age_s": self.max_age_s}


def _merged_snapshot(registries: Sequence[Any]) -> Dict[str, Any]:
    """One combined snapshot dict: a registry, or a zero-arg callable
    returning a snapshot dict.  Later sources win name collisions (the
    engine registry is listed first, so process-global metrics with the
    same name — there are none today — would shadow it, not vice versa).
    """
    merged: Dict[str, Any] = {}
    for src in registries:
        snap = src.snapshot() if hasattr(src, "snapshot") else src()
        merged.update(snap)
    return merged


class ObsServer:
    """Background HTTP thread serving the observability plane."""

    def __init__(self, *, port: int = 0, host: str = "127.0.0.1",
                 registries: Sequence[Any] = (),
                 health: Optional[Any] = None,
                 requests: Optional[Callable[[], List[Dict[str, Any]]]]
                 = None,
                 flight: Optional[Any] = None) -> None:
        """`registries`: Registry objects (or snapshot callables) merged
        into `/metrics`.  `health`: a `Liveness` (or zero-arg callable
        returning a status dict with a "healthy" bool).  `requests`:
        zero-arg callable for `/debug/requests`.  `flight`: a
        `FlightRecorder` for `/debug/flight`."""
        self.host = host
        self.port = port
        self.registries = list(registries)
        self.health = health
        self.requests_cb = requests
        self.flight = flight
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- rendering (also unit-testable without sockets) --------------------

    def render_metrics(self) -> str:
        return to_openmetrics(_merged_snapshot(self.registries))

    def render_health(self) -> Dict[str, Any]:
        if self.health is None:
            return {"healthy": True, "state": "unknown",
                    "note": "no liveness source attached"}
        status = (self.health.status() if hasattr(self.health, "status")
                  else self.health())
        return status

    # -- server lifecycle --------------------------------------------------

    def start(self) -> int:
        """Bind + serve on a daemon thread; returns the bound port."""
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):      # silence per-request log
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, doc: Any) -> None:
                self._send(code, json.dumps(doc, default=str).encode(),
                           "application/json")

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(200, outer.render_metrics().encode(),
                                   OPENMETRICS_CONTENT_TYPE)
                    elif path == "/healthz":
                        status = outer.render_health()
                        self._send_json(
                            200 if status.get("healthy") else 503, status)
                    elif path == "/debug/requests":
                        if outer.requests_cb is None:
                            self._send_json(404, {"error":
                                                  "no request source"})
                        else:
                            self._send_json(200, outer.requests_cb())
                    elif path == "/debug/flight":
                        if outer.flight is None:
                            self._send_json(404, {"error":
                                                  "no flight recorder"})
                        else:
                            self._send_json(200, {
                                "enabled": outer.flight.enabled,
                                "capacity": outer.flight.capacity,
                                "dropped": outer.flight.dropped,
                                "events": outer.flight.snapshot()})
                    else:
                        self._send_json(404, {
                            "error": f"unknown path {path}",
                            "paths": ["/metrics", "/healthz",
                                      "/debug/requests", "/debug/flight"]})
                except (BrokenPipeError, ConnectionResetError):
                    pass          # scraper went away mid-response
                except Exception as e:
                    try:
                        self._send_json(500, {"error": repr(e)})
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="obs-server", daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "ObsServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
