"""The port's serving stack against the JAX package: sampling, the
scheduler's mask algebra, and the serving-contract workloads of
tests/test_serving.py through both engines on the same fp32 weights
(reduced phi3, 2 layers; reduced deepseek-moe-16b, 2 layers,
zamba2-7b, 4 layers, and h2o-danube-1.8b, 2 layers, whose 16-token
window is shorter than max_len 64, so its ring cache wraps), plus the
serve CLI on the CPU."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.core.simt import scheduler as hw  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving import sampler as jsampler  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import sampler  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.scheduler import step_masks_np  # noqa: E402

JCFG = jax_reduced_config("phi3-mini-3.8b").replace(num_layers=2,
                                                    dtype="float32")
CFG = reduced_config("phi3-mini-3.8b").replace(num_layers=2, dtype="float32")


@pytest.fixture(scope="module")
def weights():
    params = japi.build_params(jax.random.PRNGKey(0), JCFG)
    model = bridge.from_numpy(jax.tree.map(np.asarray, params), CFG,
                              device="cpu")
    return params, model


def _run(engine_cls, cfg, params, prompts, max_new, **kw):
    eng = engine_cls(cfg, params, max_len=64, prompt_bucket=8, eos_id=-1,
                     **kw)
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run()
    snap = eng.metrics_snapshot()
    res = eng.results()
    return ([res[r] for r in rids],
            [eng.requests[r].finish_reason for r in rids],
            {k: snap.get(k, {}).get("value")
             for k in ("serving.prefix_cache.hits",
                       "serving.prefix_cache.hit_tokens")})


CHUNKED8 = dict(n_slots=2, prefill_chunk=8)
WORKLOADS = {   # the contract workloads of tests/test_serving.py
    "sequential": ([[5, 9, 2], [7, 1], [3, 3, 3, 3], [11, 4, 6], [8],
                    [2, 9]], 5, dict(n_slots=4)),
    "recycling": ([[i + 1, i + 2] for i in range(5)], 3, dict(n_slots=2)),
    "chunked": ([list(range(1, 12)), [4, 4, 2, 1], [9] * 20], 4,
                dict(CHUNKED8, prefill_mode="chunked")),
    "legacy": ([list(range(1, 12)), [4, 4, 2, 1], [9] * 20], 4,
               dict(CHUNKED8, prefill_mode="legacy")),
    "prefix_cache": ([list(range(1, 17)) + t
                      for t in ([21, 22, 23], [31, 32], [41])], 3,
                     dict(n_slots=1, prefill_chunk=8, prefill_mode="chunked",
                          prefix_cache_entries=4)),
}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_contract_workload_matches_jax_engine(weights, name):
    """Same tokens, finish reasons and prefix-cache counters as the JAX
    engine on the same fp32 weights."""
    jparams, model = weights
    prompts, max_new, kw = WORKLOADS[name]
    want = _run(JaxEngine, JCFG, jparams, prompts, max_new, **kw)
    got = _run(Engine, CFG, model, prompts, max_new, **kw)
    assert got == want
    if name == "prefix_cache":
        assert got[2] == {"serving.prefix_cache.hits": 4,
                          "serving.prefix_cache.hit_tokens": 32}


FAMILY_RUNS = [("deepseek-moe-16b", "chunked"), ("deepseek-moe-16b", "legacy"),
               ("deepseek-moe-16b", "prefix_cache"), ("zamba2-7b", "legacy"),
               ("zamba2-7b", "sequential"),
               # danube's ring cache: auto mode prefills legacy (as the
               # JAX engine does for a window below max_len); 'legacy'
               # has a 20-token prompt, past the 16-token window
               ("h2o-danube-1.8b", "sequential"),
               ("h2o-danube-1.8b", "recycling"),
               ("h2o-danube-1.8b", "legacy")]


@pytest.fixture(scope="module")
def family_weights():
    """{arch: (jax cfg, port cfg, jax params, port model)}, built once."""
    out = {}
    for arch, layers in (("deepseek-moe-16b", 2), ("zamba2-7b", 4),
                         ("h2o-danube-1.8b", 2)):
        jcfg = jax_reduced_config(arch).replace(num_layers=layers,
                                                dtype="float32")
        cfg = reduced_config(arch).replace(num_layers=layers,
                                           dtype="float32")
        params = japi.build_params(jax.random.PRNGKey(0), jcfg)
        out[arch] = (jcfg, cfg, params, bridge.from_numpy(
            jax.tree.map(np.asarray, params), cfg, device="cpu"))
    return out


@pytest.mark.parametrize("arch,name", FAMILY_RUNS)
def test_family_workload_matches_jax_engine(family_weights, arch, name):
    """The MoE family (chunked and legacy prefill, prefix-cache hits)
    and the hybrid family (legacy prefill, pads through the recurrent
    state as in the reference) give the JAX engine's tokens, finish
    reasons and prefix-cache counters."""
    jcfg, cfg, jparams, model = family_weights[arch]
    prompts, max_new, kw = WORKLOADS[name]
    want = _run(JaxEngine, jcfg, jparams, prompts, max_new, **kw)
    got = _run(Engine, cfg, model, prompts, max_new, **kw)
    assert got == want
    assert all(len(t) == max_new + 1 for t in got[0])
    if name == "prefix_cache":
        assert got[2]["serving.prefix_cache.hits"] == 4


def test_danube_ring_wraps_in_decode_like_jax_engine(family_weights):
    """24 decode steps take every slot past the 16-token window, so
    decode writes wrap around the ring: same tokens as the JAX engine."""
    jcfg, cfg, jparams, model = family_weights["h2o-danube-1.8b"]
    prompts = [[5, 9, 2], list(range(1, 21)), [7, 1, 3, 8]]
    kw = dict(n_slots=2)
    want = _run(JaxEngine, jcfg, jparams, prompts, 24, **kw)
    got = _run(Engine, cfg, model, prompts, 24, **kw)
    assert got == want
    assert all(len(t) == 25 for t in got[0])


def test_max_new_contract_and_finish_reason(weights):
    eng = Engine(CFG, weights[1], n_slots=2, max_len=64, prompt_bucket=8,
                 eos_id=-1)
    rid = eng.submit([5, 9, 2], max_new=4)
    eng.run()
    req = eng.requests[rid]
    assert len(req.out) == 5
    assert req.finish_reason == "max_new"
    snap = eng.metrics_snapshot()
    assert snap["serving.requests_completed"]["value"] == 1
    assert snap["serving.requests_completed.max_new"]["value"] == 1
    assert snap["serving.ttft_s"]["count"] == 1
    assert snap["serving.itl_s"]["count"] == 4
    assert snap["serving.tokens"]["value"] == 5
    assert eng._slot_req == {} and eng._prefill_pos == {}


def test_unselected_slots_stay_bit_identical(weights):
    """A decode tick writes only the picked slots' caches."""
    eng = Engine(CFG, weights[1], n_slots=2, max_len=64, eos_id=-1,
                 decode_width=1, prefill_chunk=8, prefix_cache_entries=0)
    eng.submit([3, 1, 4, 1, 5], max_new=6)
    eng.submit([2, 7, 1, 8], max_new=6)
    eng.step()                                  # both prefill, one decodes
    before = {k: v.clone() for k, v in eng.caches["stage1"].items()}
    picked = eng.sched.next_batch(1)            # peek the next pick
    eng.sched.visible[picked] = True            # and put it back
    eng.step()
    other = 1 - picked[0]
    for k, v in eng.caches["stage1"].items():
        assert torch.equal(v[:, other], before[k][:, other])
        assert not torch.equal(v[:, picked[0]], before[k][:, picked[0]])


def test_deadline_shed_and_nan_guard(weights):
    eng = Engine(CFG, weights[1], n_slots=1, max_len=64, eos_id=-1,
                 max_queue=2)
    a = eng.submit([1, 2], max_new=2)
    b = eng.submit([3, 4], max_new=2, deadline_s=0.0)
    c = eng.submit([5, 6], max_new=2)           # queue full: shed
    eng.run()
    reasons = {r: eng.requests[r].finish_reason for r in (a, b, c)}
    assert reasons == {a: "max_new", b: "timeout", c: "shed"}

    bad = bridge.from_numpy(bridge.to_numpy(weights[1]), CFG, device="cpu")
    bad.lm_head.data[:, 7] = float("nan")
    eng = Engine(CFG, bad, n_slots=1, max_len=64, eos_id=-1)
    rid = eng.submit([1, 2, 3], max_new=2)
    eng.run()
    assert eng.requests[rid].finish_reason == "degraded"
    assert len(eng.requests[rid].out) == 3
    snap = eng.metrics_snapshot()
    assert snap["serving.decode.nonfinite_logit_rows"]["value"] == 2


def test_deferred_features_raise(weights, family_weights):
    """What the port refuses: zamba2 with the paged layout (its SSM and
    conv states have no sequence axis to page, and it prefills legacy
    only, as in the JAX engine) and chunked prefill into int8 KV caches
    (decode-only, as in the JAX package).  (zamba2's
    long-context windowed attention is ported: its parity test is
    ``test_torch_hybrid.test_long_context_matches_jax_through_ring_wrap``.)
    """
    _, zcfg, _, zmodel = family_weights["zamba2-7b"]
    with pytest.raises(ValueError, match="chunked prefill"):
        Engine(zcfg, zmodel, max_len=64, kv_layout="paged")
    with pytest.raises(ValueError, match="seq=64"):
        Engine(zcfg, zmodel, max_len=64, prefill_mode="chunked",
               kv_layout="paged")
    with pytest.raises(ValueError, match="multiple of kv_page_size"):
        Engine(CFG, weights[1], max_len=64, kv_layout="paged",
               kv_page_size=24)
    caches = api.init_caches(CFG, 1, 64, device="cpu", kv_quant=True)
    with pytest.raises(ValueError, match="int8"):
        api.forward(weights[1], {"tokens": torch.zeros(1, 4,
                                                       dtype=torch.int32)},
                    CFG, mode="chunk", caches=caches)


def test_sample_guarded_greedy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 640), np.float32)
    logits[1, 5] = np.nan
    logits[2, :] = np.inf
    logits[3, 100] = -np.inf
    logits[4, 600] = 50.0                       # padded column: masked
    cfg = sampler.SamplerConfig()
    tok, bad = sampler.sample_guarded(torch.from_numpy(logits), 512, cfg)
    jtok, jbad = jsampler.sample_guarded(jnp.asarray(logits), 512,
                                         jsampler.SamplerConfig())
    assert np.array_equal(tok.numpy(), np.asarray(jtok))
    assert np.array_equal(bad.numpy(), np.asarray(jbad))
    ent = sampler.logit_entropy(torch.from_numpy(logits[[0, 4]]), 512)
    jent = jsampler.logit_entropy(jnp.asarray(logits[[0, 4]]), 512)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jent), rtol=1e-5)


def test_stochastic_sampling_statistics():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((4, 640), np.float32))
    gen = torch.Generator().manual_seed(0)
    greedy = sampler.sample(logits, 512, sampler.SamplerConfig())
    top1 = sampler.sample(logits, 512, sampler.SamplerConfig(
        temperature=0.7, top_k=1), gen)
    assert torch.equal(top1, greedy)
    k = 5
    topk = torch.topk(logits[:, :512], k).indices
    draws = torch.stack([sampler.sample(logits, 512, sampler.SamplerConfig(
        temperature=1.0, top_k=k), gen) for _ in range(2000)])
    for row in range(4):
        assert set(draws[:, row].tolist()) <= set(topk[row].tolist())
    # frequencies follow softmax over the top k (2000 draws: 4 sigma)
    p = torch.softmax(logits[0, topk[0]], dim=0)
    freq = torch.stack([(draws[:, 0] == t).float().mean() for t in topk[0]])
    assert torch.all((freq - p).abs() <= 4 * torch.sqrt(p * (1 - p) / 2000))


def test_step_masks_np_matches_hw_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        W = int(rng.integers(1, 9))
        vis, act, st, bar = (rng.random(W) < 0.5 for _ in range(4))
        wid_np, vis_np = step_masks_np(vis, act, st, bar)
        wid_hw, vis_hw = hw.step_masks(jnp.asarray(vis), jnp.asarray(act),
                                       jnp.asarray(st), jnp.asarray(bar))
        assert wid_np == int(wid_hw)
        assert (vis_np == np.asarray(vis_hw)).all()


def test_serve_cli_on_cpu(capsys):
    rc = serve.main(["--arch", "phi3-mini-3.8b", "--reduced", "--device",
                     "cpu", "--requests", "3", "--slots", "2", "--max-new",
                     "4", "--max-len", "64", "--shared-prefix", "40"])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("req ")]
    assert len(lines) == 3
    assert all(": 5 tokens" in ln for ln in lines)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "zamba2-7b"])
def test_serve_cli_new_families_on_cpu(capsys, arch):
    rc = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--requests", "2", "--slots", "2", "--max-new", "3",
                     "--max-len", "64", "--shared-prefix", "32"])
    assert rc == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("req ")]
    assert len(lines) == 2 and all(": 4 tokens" in ln for ln in lines)
    mode = "legacy" if arch == "zamba2-7b" else "chunked"
    assert f"prefill={mode}" in out


def test_serve_cli_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        serve.main(["--arch", "phi3-mini-3.8b", "--reduced",
                    "--requests", "1"])
    with pytest.raises(ValueError, match="paged KV requires chunked"):
        serve.main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
                    "--kv-layout", "paged"])
