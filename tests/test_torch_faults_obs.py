"""The port's fault injection, step watchdog and observability plane
against the JAX package's: the serving tests of tests/test_faults.py
(the same tokens, finish reasons and counters as the JAX engine under
the same seeded plans, in fp32 on the same weights), the HTTP, flight
and tracing tests of tests/test_obs_server.py (bit-identical serving
with the whole plane on), kernel instrumentation, and the serve CLI's
paged chaos run on the CPU."""
import glob
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.obs.flight import validate_flight as jvalidate_flight  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro_torch import bridge, faults, obs  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.faults import (Fault, FaultInjector, FaultPlan,  # noqa: E402
                                TransientFault, serving_plan)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.obs.flight import (FlightRecorder, flight,  # noqa: E402
                                    validate_flight)
from repro_torch.obs.server import (OPENMETRICS_CONTENT_TYPE,  # noqa: E402
                                    Liveness, ObsServer)
from repro_torch.serving.engine import Engine  # noqa: E402

JCFG = jax_reduced_config("phi3-mini-3.8b").replace(num_layers=2,
                                                    dtype="float32")
CFG = reduced_config("phi3-mini-3.8b").replace(num_layers=2, dtype="float32")
PROMPTS = [[5, 9, 2], [7, 1], [3, 3, 3, 3]]


@pytest.fixture(scope="module")
def weights():
    params = japi.build_params(jax.random.PRNGKey(0), JCFG)
    return params, bridge.from_numpy(jax.tree.map(np.asarray, params), CFG,
                                     device="cpu")


@pytest.fixture(autouse=True)
def _clean_globals():
    """The tracer, the flight recorder and kernel timing are
    process-global: leave them exactly as found."""
    yield
    obs.tracer.disable()
    obs.tracer.clear()
    flight.disable()
    flight.clear()
    obs.disable_kernel_timing()


def _get(url, timeout=5):
    try:
        r = urllib.request.urlopen(url, timeout=timeout)
        return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


# ---------------------------------------------------------------------------
# fault plans: the port's copy gives the JAX package's schedules
# ---------------------------------------------------------------------------

def test_plans_match_jax_and_replay():
    rates = {("serving.logits", "nan_logits"): 0.3,
             ("train.step", "exception"): 0.2,
             ("pod", "pod_stall"): 0.25}
    a = FaultPlan.generate(11, horizon=128, rates=rates, n_pods=4)
    b = FaultPlan.generate(11, horizon=128,
                           rates=dict(reversed(rates.items())), n_pods=4)
    assert a == b and len(a) > 0
    assert a != FaultPlan.generate(12, horizon=128, rates=rates, n_pods=4)
    want = jfaults.FaultPlan.generate(11, horizon=128, rates=rates, n_pods=4)
    assert [tuple(vars(f).values()) for f in a.schedule()] == \
        [tuple(vars(f).values()) for f in want.schedule()]
    for seed in (123, 1234):
        assert serving_plan(seed).schedule() == serving_plan(seed).schedule()
        assert [tuple(vars(f).values())
                for f in serving_plan(seed).schedule()] == \
            [tuple(vars(f).values())
             for f in jfaults.serving_plan(seed).schedule()]


def test_injector_cursor_and_pop_once():
    inj = FaultInjector(FaultPlan([Fault("s", 2, "exception"),
                                   Fault("s", 2, "slow", 0.1)]))
    assert inj.poll("s") == [] and inj.poll("s") == []
    assert sorted(f.kind for f in inj.poll("s")) == ["exception", "slow"]
    assert inj.remaining() == 0
    inj._cursor["s"] = 2            # a replayed tick must NOT re-fire
    assert inj.poll("s") == []
    assert inj.metrics.snapshot()["faults.injected"]["value"] == 2


# ---------------------------------------------------------------------------
# serving fault classes: port engine vs JAX engine, same plans
# ---------------------------------------------------------------------------

COUNTER_PREFIXES = ("serving.requests_completed", "serving.degraded",
                    "serving.decode.nonfinite_logit_rows",
                    "serving.decode.sampled_tokens", "serving.watchdog.",
                    "serving.faults.", "serving.tokens",
                    "serving.prefill_chunks", "serving.prefix_cache.hits")


def _counters(snap, skip=()):
    return {k: v["value"] for k, v in snap.items()
            if k.startswith(COUNTER_PREFIXES) and "value" in v
            and k not in skip and v.get("type", "counter") == "counter"}


def _run_pair(weights, plan_of, prompts=PROMPTS, max_new=4,
              skip=("serving.watchdog.slow_ticks",), **kw):
    """The same workload through both engines, each with its own
    injector on `plan_of(faults package)` (None: no injector)."""
    out = []
    for cls, cfg, params, pkg in ((JaxEngine, JCFG, weights[0], jfaults),
                                  (Engine, CFG, weights[1], faults)):
        plan = plan_of(pkg)
        inj = None if plan is None else pkg.FaultInjector(plan)
        eng = cls(cfg, params, n_slots=2, max_len=64, prompt_bucket=8,
                  eos_id=-1, faults=inj, **kw)
        rids = [eng.submit(p, max_new=max_new) for p in prompts]
        eng.run()
        out.append({
            "tokens": [eng.requests[r].out for r in rids],
            "reasons": [eng.requests[r].finish_reason for r in rids],
            "counters": _counters(eng.metrics_snapshot(), skip),
            "faults": (None if inj is None
                       else {k: v["value"] for k, v in
                             inj.metrics.snapshot().items()}),
            "remaining": None if inj is None else inj.remaining(),
            "eng": eng})
    want, got = out
    for key in ("tokens", "reasons", "counters", "faults", "remaining"):
        assert got[key] == want[key], key
    return got


def test_nan_logits_degrade_not_crash(weights):
    got = _run_pair(weights, lambda pkg: pkg.FaultPlan(
        [pkg.Fault("serving.logits", 0, "nan_logits"),
         pkg.Fault("serving.logits", 1, "inf_logits")]))
    c = got["counters"]
    assert c["serving.degraded_samples"] >= 2
    assert c["serving.requests_completed.degraded"] >= 1
    assert c["serving.decode.nonfinite_logit_rows"] >= 2
    assert all(len(t) == 5 and all(0 <= x < CFG.vocab_size for x in t)
               for t in got["tokens"])
    assert got["remaining"] == 0


def test_transient_step_fault_retries_same_output(weights):
    plain = _run_pair(weights, lambda pkg: None)
    got = _run_pair(weights, lambda pkg: pkg.FaultPlan(
        [pkg.Fault("serving.step", 1, "exception"),
         pkg.Fault("serving.step", 3, "exception")]),
        retry_base_s=0.001, retry_max_s=0.002)
    assert got["counters"]["serving.watchdog.transient_faults"] == 2
    assert got["counters"]["serving.watchdog.retries"] == 2
    assert got["tokens"] == plain["tokens"]
    assert got["reasons"] == ["max_new"] * 3


def test_fault_free_injector_bit_identical(weights):
    """An injector with an empty plan polls every hook and changes
    nothing: tokens and counters equal serving without one."""
    plain = _run_pair(weights, lambda pkg: None)
    got = _run_pair(weights, lambda pkg: pkg.FaultPlan())
    assert got["tokens"] == plain["tokens"]
    assert got["reasons"] == plain["reasons"]
    assert got["counters"] == plain["counters"]
    assert "serving.degraded_samples" not in got["counters"]


def test_chaos_plan_on_paged_engine_matches_jax(weights):
    """The --chaos-seed plan through the paged engine: every request
    finishes with the JAX engine's tokens, reasons and counters."""
    got = _run_pair(weights, lambda pkg: pkg.serving_plan(1234),
                    prompts=[[7] * 40 + [i, i + 1] for i in range(5)],
                    max_new=8, prefill_mode="chunked", prefill_chunk=8,
                    prefix_cache_entries=8, kv_layout="paged",
                    kv_page_size=8, retry_base_s=0.001, retry_max_s=0.002)
    assert got["counters"]["serving.watchdog.retries"] >= 1
    assert set(got["reasons"]) <= {"max_new", "degraded"}
    assert got["counters"]["serving.requests_completed"] == 5


def test_hung_tick_and_deadline_timeout(weights):
    out = []
    for cls, cfg, params, pkg in ((JaxEngine, JCFG, weights[0], jfaults),
                                  (Engine, CFG, weights[1], faults)):
        inj = pkg.FaultInjector(pkg.FaultPlan(
            [pkg.Fault("serving.decode", 0, "hang", 0.2)]))
        eng = cls(cfg, params, n_slots=2, max_len=64, prompt_bucket=8,
                  eos_id=-1, faults=inj, tick_budget_s=0.05)
        a = eng.submit([5, 9, 2], max_new=8)
        b = eng.submit([7, 1], max_new=8, deadline_s=0.05)
        eng.run()
        snap = eng.metrics_snapshot()
        assert snap["serving.faults.delayed_decode_ticks"]["value"] >= 1
        assert snap["serving.watchdog.slow_ticks"]["value"] >= 1
        assert snap["serving.requests_completed.timeout"]["value"] == 1
        out.append((eng.requests[a].out, eng.requests[a].finish_reason,
                    eng.requests[b].finish_reason))
    assert out[1] == out[0] and out[1][1:] == ("max_new", "timeout")


def test_bounded_queue_sheds(weights):
    got = _run_pair(weights, lambda pkg: None,
                    prompts=[[1, 2], [3, 4], [5, 6], [7, 8], [9, 10]],
                    max_new=2, max_queue=2, shed_policy="reject-new")
    shed = got["reasons"].count("shed")
    assert shed >= 1
    assert got["counters"]["serving.requests_completed.shed"] == shed
    assert set(got["reasons"]) == {"shed", "max_new"}


def test_watchdog_gives_up_after_retry_budget(weights):
    inj = FaultInjector(FaultPlan(
        [Fault("serving.step", t, "exception") for t in (1, 2, 3)]))
    eng = Engine(CFG, weights[1], n_slots=2, max_len=64, prompt_bucket=8,
                 eos_id=-1, faults=inj, step_retries=2, retry_base_s=0.001,
                 retry_max_s=0.002)
    eng.submit([5, 9, 2], max_new=8)
    flight.enable()
    with pytest.raises(TransientFault):
        eng.run()
    snap = eng.metrics_snapshot()
    assert snap["serving.watchdog.gave_up"]["value"] == 1
    assert snap["serving.watchdog.retries"]["value"] == 2
    kinds = [e["kind"] for e in flight.snapshot()]
    assert kinds.count("serving.watchdog.retry") == 2
    assert kinds[-1] == "serving.watchdog.gave_up"


def test_retried_tick_writes_the_cache_once(weights):
    """The injected step fault fires before the tick touches anything,
    so a retried tick leaves the pool as an unfaulted run does."""
    pools = []
    for plan in (FaultPlan(), FaultPlan([Fault("serving.step", 2,
                                               "exception")])):
        eng = Engine(CFG, weights[1], n_slots=2, max_len=64, eos_id=-1,
                     prefill_chunk=8, kv_layout="paged", kv_page_size=8,
                     faults=FaultInjector(plan), retry_base_s=0.001)
        for p in PROMPTS[:2]:
            eng.submit(p, max_new=3)
        for _ in range(3):
            eng.step()
        pools.append(eng.caches)
    for st in pools[0]:
        for k in pools[0][st]:
            assert torch.equal(pools[0][st][k], pools[1][st][k])


# ---------------------------------------------------------------------------
# HTTP plane
# ---------------------------------------------------------------------------

def test_metrics_endpoint_serves_openmetrics():
    reg = obs.Registry()
    reg.counter("reqs").inc(3)
    reg.histogram("lat_s").observe(0.2)
    with ObsServer(port=0, registries=[reg]) as srv:
        code, headers, body = _get(f"http://127.0.0.1:{srv.port}/metrics")
    assert code == 200
    assert headers["Content-Type"] == OPENMETRICS_CONTENT_TYPE
    text = body.decode()
    assert "reqs_total 3" in text and '_bucket{le="' in text
    assert 'le="+Inf"' in text and text.endswith("# EOF\n")


def test_healthz_transitions_and_status_codes():
    live = Liveness(max_age_s=0.05)
    with ObsServer(port=0, health=live) as srv:
        url = f"http://127.0.0.1:{srv.port}/healthz"
        code, _, body = _get(url)
        assert code == 200 and json.loads(body)["state"] == "starting"
        live.beat()
        code, _, body = _get(url)
        assert code == 200 and json.loads(body)["state"] == "live"
        time.sleep(0.1)
        code, _, body = _get(url)
        assert code == 503 and json.loads(body)["state"] == "stalled"
        live.done()
        code, _, body = _get(url)
        assert code == 200 and json.loads(body)["state"] == "finished"


def test_debug_endpoints_and_unknown_path():
    fr = FlightRecorder()
    fr.enable()
    fr.record("x", a=1)
    with ObsServer(port=0, requests=lambda: [{"rid": 0, "state": "decode"}],
                   flight=fr) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        code, _, body = _get(f"{base}/debug/requests")
        assert code == 200 and json.loads(body)[0]["state"] == "decode"
        code, _, body = _get(f"{base}/debug/flight")
        doc = json.loads(body)
        assert code == 200 and doc["enabled"] and len(doc["events"]) == 1
        code, _, body = _get(f"{base}/nope")
        assert code == 404 and "/metrics" in json.loads(body)["paths"]
    with ObsServer(port=0) as srv:
        code, _, _ = _get(f"http://127.0.0.1:{srv.port}/debug/requests")
    assert code == 404


# ---------------------------------------------------------------------------
# flight recorder and tracer
# ---------------------------------------------------------------------------

def test_flight_ring_bounds_and_drop_accounting():
    fr = FlightRecorder(capacity=8)
    fr.enable()
    for i in range(20):
        fr.record("tick", i=i)
    assert len(fr) == 8 and fr.dropped == 12
    evs = fr.snapshot()
    assert [e["i"] for e in evs] == list(range(12, 20))
    assert evs[-1]["seq"] == 20


def test_flight_dumps_validate_in_both_packages(tmp_path):
    fr = FlightRecorder(capacity=16)
    fr.enable()
    reg = obs.Registry()
    reg.counter("c").inc(5)
    fr.add_metrics_source(reg)
    for i in range(20):
        fr.record("e", i=i)
    doc = json.load(open(fr.dump(str(tmp_path), reason="test")))
    validate_flight(doc)
    jvalidate_flight(doc)           # one schema for both packages
    assert doc["reason"] == "test"
    assert doc["dropped"] == 4 and doc["n_events"] == 16
    (snap,) = doc["metrics"].values()
    assert snap["c"]["value"] == 5
    doc = json.load(open(fr.crash_dump(str(tmp_path), ValueError("boom"))))
    validate_flight(doc)
    assert doc["reason"] == "crash"
    assert doc["events"][-1]["exc_type"] == "ValueError"


def test_flight_mirrors_tracer_spans_not_metadata():
    fr = FlightRecorder()
    fr.enable()
    tr = obs.Tracer()
    tr.enable()
    fr.attach_tracer(tr)
    with tr.span("work", rid=7):
        pass
    tr.instant("marker")
    tr.thread_name(1, 7, "req 7")
    kinds = [(e["kind"], e.get("name")) for e in fr.snapshot()]
    assert ("span", "work") in kinds and ("span", "marker") in kinds
    assert ("span", "thread_name") not in kinds


def test_disabled_telemetry_allocates_nothing():
    fr = FlightRecorder()
    fr.record("e")
    assert len(fr) == 0 and fr.dropped == 0
    assert fr.crash_dump("/nonexistent", ValueError()) is None
    assert obs.tracer.span("a") is obs.tracer.span("b")
    n_events = len(obs.tracer.snapshot_events())
    obs.tracer.instant("x")
    obs.tracer.complete("y", 0.0, 1.0)
    obs.tracer.thread_name(1, 2, "z")
    assert len(obs.tracer.snapshot_events()) == n_events
    seq0 = flight._seq
    flight.record("e", heavy="payload")
    assert flight._seq == seq0 and len(flight) == 0


# ---------------------------------------------------------------------------
# the whole plane on: bit-identical serving
# ---------------------------------------------------------------------------

GATE_KEYS = ("serving.prefix_cache.hits", "serving.prefill_chunks",
             "serving.tokens")   # the JAX GATE_KEYS but its jit counter


def _obs_run(model, **kw):
    eng = Engine(CFG, model, n_slots=4, max_len=64, prefill_chunk=8,
                 prefix_cache_entries=8, eos_id=-1, **kw)
    for i in range(5):
        eng.submit([7] * 8 + [11 + i, 13 + i, 17 + i], max_new=4)
    return eng


@pytest.mark.parametrize("kv_layout", ["contiguous", "paged"])
def test_enabling_obs_plane_is_bit_identical(weights, kv_layout):
    """Tokens and the gated counters are bit-identical with the whole
    plane on (tracer, flight, kernel timing and an HTTP server scraped
    mid-run) and with everything off; the plane saw the run."""
    base = _obs_run(weights[1], kv_layout=kv_layout)
    base.run()
    base_snap = base.metrics_snapshot()

    obs.tracer.enable()
    flight.enable()
    flight.attach_tracer(obs.tracer)
    obs.enable_kernel_timing()
    kreg = obs.Registry()
    eng = _obs_run(weights[1], kv_layout=kv_layout)
    with ObsServer(port=0, registries=[eng.metrics, kreg],
                   health=eng.liveness, requests=eng.debug_requests,
                   flight=flight) as srv:
        eng.step()
        code, _, body = _get(f"http://127.0.0.1:{srv.port}/metrics")
        assert code == 200 and body.decode().endswith("# EOF\n")
        code, _, body = _get(f"http://127.0.0.1:{srv.port}/debug/requests")
        assert code == 200
        assert {r["state"] for r in json.loads(body)} <= {
            "queued", "prefill", "decode", "done"}
        eng.run()
    snap = eng.metrics_snapshot()
    assert eng.results() == base.results()
    for key in GATE_KEYS:
        assert snap[key]["value"] == base_snap[key]["value"], key
    kinds = {e["kind"] for e in flight.snapshot()}
    assert {"serving.admit", "serving.first_token",
            "serving.finish", "span"} <= kinds
    names = {e["name"] for e in obs.tracer.snapshot_events()
             if e.get("ph") == "X"}
    assert {"prefill_chunk", "decode_tick", "request", "queue_wait",
            "decode", "prefill"} <= names
    # kernel timing counted the norm kernels' (CPU) plain versions
    assert obs.metrics.counter("kernels.add_rmsnorm.launches").value > 0


def test_instrument_kernel_counts_and_times_only_when_enabled():
    reg = obs.Registry()
    calls = []
    fn = obs.instrument_kernel("k", lambda x: calls.append(x) or x, reg)
    fn(torch.ones(2))
    assert "kernels.k.launches" not in reg.snapshot() and len(calls) == 1
    obs.enable_kernel_timing()
    fn(torch.ones(2))
    fn(torch.ones(2))
    snap = reg.snapshot()
    assert snap["kernels.k.launches"]["value"] == 2
    assert snap["kernels.k.time_s"]["count"] == 2
    assert len(calls) == 3


def test_kernel_launch_counts_of_a_forward():
    """With kernel timing on, one reduced prefill counts each wrapper
    once per call site: the first norm, two fused norms per layer, and
    one flash call per layer."""
    model = api.build_params(CFG, torch.Generator().manual_seed(0),
                             device="cpu")
    obs.metrics.reset()
    obs.enable_kernel_timing()
    api.forward(model, {"tokens": torch.zeros((1, 8), dtype=torch.long)},
                CFG, mode="prefill")
    snap = obs.metrics.snapshot()
    L = CFG.num_layers
    assert {k: v["value"] for k, v in snap.items()
            if k.endswith(".launches")} == {
        "kernels.rmsnorm.launches": 1,
        "kernels.add_rmsnorm.launches": 2 * L,
        "kernels.flash_attention.launches": L}
    obs.metrics.reset()


# ---------------------------------------------------------------------------
# the serve CLI: paged, chaos, live HTTP plane and flight dump on the CPU
# ---------------------------------------------------------------------------

def test_serve_cli_paged_chaos_smoke(tmp_path):
    """`serve --kv-layout paged --metrics-port 0 --chaos-seed 1234
    --flight-dir ...` serves valid OpenMetrics and /healthz while
    handling traffic, and leaves a flight dump that both packages'
    validators accept, holding the fault firing, the watchdog retry and
    every request's finish reason."""
    serve.last_server = None
    out = {}

    def run():
        out["rc"] = serve.main([
            "--arch", "phi3-mini-3.8b", "--reduced", "--device", "cpu",
            "--requests", "5", "--slots", "4", "--max-new", "8",
            "--max-len", "128", "--kv-layout", "paged", "--shared-prefix",
            "40", "--metrics-port", "0", "--chaos-seed", "1234",
            "--flight-dir", str(tmp_path)])

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.time() + 240
    while serve.last_server is None and time.time() < deadline:
        time.sleep(0.02)
    assert serve.last_server is not None, "server never started"
    port = serve.last_server.port
    scraped = {}
    while t.is_alive() and time.time() < deadline:
        try:
            code, headers, body = _get(f"http://127.0.0.1:{port}/metrics",
                                       timeout=2)
            if code == 200:
                scraped["ct"] = headers["Content-Type"]
                scraped["body"] = body.decode()
            code, _, hb = _get(f"http://127.0.0.1:{port}/healthz",
                               timeout=2)
            scraped["health"] = (code, json.loads(hb))
        except (urllib.error.URLError, ConnectionError, OSError):
            pass               # the server may be shutting down
        time.sleep(0.01)
    t.join(timeout=240)
    assert out.get("rc") == 0
    assert scraped["ct"] == OPENMETRICS_CONTENT_TYPE
    assert scraped["body"].endswith("# EOF\n")
    code, health = scraped["health"]
    assert code in (200, 503) and "state" in health
    dumps = sorted(glob.glob(str(tmp_path / "flight_*.json")))
    assert dumps, "no flight dump written"
    doc = json.load(open(dumps[-1]))
    validate_flight(doc)
    jvalidate_flight(doc)
    kinds = [e["kind"] for e in doc["events"]]
    assert "fault.fired" in kinds and "serving.watchdog.retry" in kinds
    finishes = [e for e in doc["events"] if e["kind"] == "serving.finish"]
    assert len(finishes) == 5
    assert all(e["reason"] in ("max_new", "degraded") for e in finishes)
