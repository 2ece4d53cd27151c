"""The port's paged KV layout against its contiguous layout and the JAX
package's paged engine, in fp32 on the same weights (reduced phi3 and
deepseek-moe-16b, 2 layers): the same tokens and finish reasons, the
same ``serving.kv.*`` counters and flight events as the JAX engine in
its three paged behaviours (copy-on-write, admission under pool
pressure, prefix eviction), and the shared-prefix counters of the
serving benchmark's workload pinned exactly."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks import serving as bench  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.obs.flight import flight as jflight  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.obs.flight import flight  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

ARCHS = ("phi3-mini-3.8b", "deepseek-moe-16b")
KV_KEYS = ("serving.kv.pages_shared", "serving.kv.pages_copied",
           "serving.kv.cow_splits", "serving.kv.admit_blocked",
           "serving.kv.evicted_pages", "serving.prefix_cache.hits",
           "serving.prefix_cache.hit_tokens", "serving.prefix_cache.inserts",
           "serving.prefix_cache.evictions", "serving.prefill_chunks",
           "serving.tokens")


@pytest.fixture(scope="module")
def models():
    """{arch: (jax cfg, port cfg, jax params, port model)}, fp32."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_reduced_config(arch).replace(num_layers=2,
                                                dtype="float32")
        cfg = reduced_config(arch).replace(num_layers=2, dtype="float32")
        params = japi.build_params(jax.random.PRNGKey(0), jcfg)
        out[arch] = (jcfg, cfg, params, bridge.from_numpy(
            jax.tree.map(np.asarray, params), cfg, device="cpu"))
    return out


@pytest.fixture(autouse=True)
def _clean_flight():
    """Both flight recorders are process-global: leave them off and
    empty whatever a test did."""
    yield
    for fr in (flight, jflight):
        fr.disable()
        fr.clear()


def _run(engine_cls, cfg, params, prompts, max_new, *, layout,
         page_size=8, n_slots=2, prefix_entries=0, kv_pages=None):
    """tests/test_serving.py's `_run_workload`, for either engine."""
    eng = engine_cls(cfg, params, n_slots=n_slots, max_len=64,
                     prompt_bucket=8, prefill_chunk=8,
                     prefill_mode="chunked", eos_id=-1,
                     prefix_cache_entries=prefix_entries, kv_layout=layout,
                     kv_page_size=page_size, kv_pages=kv_pages)
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run()
    res = eng.results()
    snap = eng.metrics_snapshot()
    return ([res[r] for r in rids],
            [eng.requests[r].finish_reason for r in rids],
            {k: snap.get(k, {}).get("value", 0) for k in KV_KEYS}, eng)


def _both(models, arch, prompts, max_new, recorders=False, **kw):
    """(JAX paged run, port paged run, JAX flight events, port flight
    events) on the same weights."""
    jcfg, cfg, jparams, model = models[arch]
    runs, events = [], []
    for fr, cls, c, p in ((jflight, JaxEngine, jcfg, jparams),
                          (flight, Engine, cfg, model)):
        if recorders:
            fr.enable()
            fr.clear()
        runs.append(_run(cls, c, p, prompts, max_new, layout="paged", **kw))
        events.append(fr.snapshot() if recorders else [])
        fr.disable()
    return runs[0], runs[1], events[0], events[1]


WORKLOADS = {   # tests/test_serving.py's paged gate, in fp32
    "ragged": ([[5, 9, 2], [7, 1], [3, 3, 3, 3], [11, 4, 6], [8], [2, 9]],
               5, 0),
    "multi_chunk": ([list(range(1, 12)), [4, 4, 2, 1], [9] * 20], 4, 0),
    "shared_prefix": ([list(range(1, 17)) + t
                       for t in ([21, 22, 23], [31, 32], [41])], 3, 4),
}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_paged_matches_contiguous_and_jax_paged(models, arch, name):
    """Paged tokens equal contiguous tokens and the JAX paged engine's;
    the kv and prefix-cache counters equal the JAX engine's."""
    prompts, max_new, entries = WORKLOADS[name]
    jcfg, cfg, jparams, model = models[arch]
    cont = _run(Engine, cfg, model, prompts, max_new, layout="contiguous",
                prefix_entries=entries)
    want, got, _, _ = _both(models, arch, prompts, max_new,
                            prefix_entries=entries)
    assert got[:2] == cont[:2] == want[:2]
    assert got[2] == want[2]
    assert all(len(t) == max_new + 1 for t in got[0])
    if name == "shared_prefix":
        # 16-token prefix, page size 8: hits pin whole pages, no copy
        assert got[2]["serving.kv.pages_shared"] > 0
        assert got[2]["serving.kv.pages_copied"] == 0
        assert got[2]["serving.kv.cow_splits"] == 0
    eng = got[3]
    held = sum(len(e.pages) for e in eng.prefix._entries.values()) \
        if eng.prefix is not None else 0
    assert eng._kv.pool.free_pages + held == eng._kv.pool.n_pages
    eng._kv.pool.check()


def test_paged_cow_split_copies_one_partial_page_per_hit(models):
    """An 8-token prefix on 16-token pages: each hit pins the shared
    partial page and copies it once, on the hitter's first write."""
    shared = list(range(1, 9))
    prompts = [shared + t for t in ([21, 22, 23], [31, 32], [41])]
    _, cfg, _, model = models["phi3-mini-3.8b"]
    cont = _run(Engine, cfg, model, prompts, 3, layout="contiguous",
                n_slots=1, prefix_entries=4)
    want, got, jev, tev = _both(models, "phi3-mini-3.8b", prompts, 3,
                                recorders=True, page_size=16, n_slots=1,
                                prefix_entries=4)
    assert got[:2] == cont[:2] == want[:2]
    assert got[2] == want[2]
    hits = got[2]["serving.prefix_cache.hits"]
    assert hits == 2
    assert got[2]["serving.kv.cow_splits"] == hits
    assert got[2]["serving.kv.pages_copied"] == hits + 1
    assert got[2]["serving.kv.pages_shared"] == hits
    cow = [{k: e[k] for k in ("slot", "pos", "old_page", "new_page")}
           for e in tev if e["kind"] == "kv.cow"]
    assert cow and cow == [{k: e[k] for k in cow[0]}
                           for e in jev if e["kind"] == "kv.cow"]


def test_paged_admission_blocks_until_pages_free(models):
    """A request admits only when the pool covers its worst case; until
    then it waits (kv.oom, admit_blocked) and completes correctly."""
    prompts = [[i + 1] * 20 for i in range(4)]   # cap 24 tokens = 2 pages
    want, got, jev, tev = _both(models, "phi3-mini-3.8b", prompts, 4,
                                recorders=True, page_size=16, n_slots=4,
                                kv_pages=4)
    assert got[:3] == want[:3]
    assert got[1] == ["max_new"] * 4
    assert got[2]["serving.kv.admit_blocked"] > 0
    oom = [(e["rid"], e["need_pages"], e["free_pages"]) for e in tev
           if e["kind"] == "kv.oom"]
    assert oom and oom == [(e["rid"], e["need_pages"], e["free_pages"])
                           for e in jev if e["kind"] == "kv.oom"]
    eng = got[3]
    assert eng._kv.pool.free_pages == eng._kv.pool.n_pages


def test_paged_prefix_eviction_releases_pages(models):
    """Evicting a prefix entry (capacity 1) returns its pinned pages to
    the pool and records kv.evict."""
    prompts = [[i + 1] * 8 + [40 + i] for i in range(3)]
    want, got, jev, tev = _both(models, "phi3-mini-3.8b", prompts, 3,
                                recorders=True, page_size=8, n_slots=1,
                                prefix_entries=1)
    assert got[:3] == want[:3]
    assert got[2]["serving.kv.evicted_pages"] > 0
    ev = [(e["pages"], e["freed"], e["n_tokens"]) for e in tev
          if e["kind"] == "kv.evict"]
    assert ev and ev == [(e["pages"], e["freed"], e["n_tokens"])
                         for e in jev if e["kind"] == "kv.evict"]
    eng = got[3]
    held = sum(len(e.pages) for e in eng.prefix._entries.values())
    assert eng._kv.pool.free_pages + held == eng._kv.pool.n_pages
    eng._kv.pool.check()


def test_shared_prefix_bench_counters_pinned(models):
    """The serving benchmark's shared_prefix workload (128-token prefix,
    32-token tails, 16 requests after two warm-ups, 8 slots, chunk 32,
    page 32) on the paged engine: 17 hits pin the prefix's 4 pages each
    (68 pages shared) and nothing is copied, as the committed JAX
    baseline gates."""
    _, cfg, _, model = models["phi3-mini-3.8b"]
    wl = bench.make_workloads()["shared_prefix"]
    eng = Engine(cfg, model, n_slots=bench.N_SLOTS, max_len=bench.MAX_LEN,
                 prompt_bucket=64, prefill_chunk=bench.CHUNK,
                 prefill_mode="chunked", prefix_cache_entries=64, eos_id=-1,
                 kv_layout="paged", kv_page_size=bench.PAGE_SIZE)
    res = bench.run_workload(eng, wl["warmup"], wl["prompts"])
    assert res["tokens"] == bench.N_REQUESTS * (bench.MAX_NEW + 1)
    snap = eng.metrics_snapshot()
    shared = snap["serving.kv.pages_shared"]["value"]
    copied = snap.get("serving.kv.pages_copied", {"value": 0})["value"]
    assert (shared, copied) == (68, 0)
    path = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "baselines", "BENCH_serving.json")
    gate = json.load(open(path))["gate"]
    assert shared == gate["paged_shared_prefix_pages_shared"]["value"]
    assert copied == gate["paged_shared_prefix_pages_copied"]["value"]
