"""The port's model path against the JAX package on the same inputs:
building blocks, attention pieces, cache writes, and full fp32
forwards in the prefill, chunk and decode modes (reduced phi3, 2
layers; fp32 so that greedy ties cannot decide a comparison)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import api, attention, common  # noqa: E402

JCFG = jax_reduced_config("phi3-mini-3.8b").replace(num_layers=2,
                                                    dtype="float32")
CFG = reduced_config("phi3-mini-3.8b").replace(num_layers=2, dtype="float32")
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(np.asarray,
                        japi.build_params(jax.random.PRNGKey(0), JCFG))
    return tree, bridge.from_numpy(tree, CFG, device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_config_copy_matches_reference():
    for name in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                 "d_ff", "vocab_size", "resolved_head_dim", "rope_theta",
                 "norm_eps", "dtype", "family"):
        assert getattr(CFG, name) == getattr(JCFG, name), name
    assert common.padded_vocab(32064) == jcommon.padded_vocab(32064) == 32128


def test_apply_rope_and_swiglu_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 32), np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    got = common.apply_rope(_t(x), _t(pos), 10_000.0).numpy()
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    g = rng.standard_normal((3, 64), np.float32) * 4
    u = rng.standard_normal((3, 64), np.float32)
    np.testing.assert_allclose(
        common.swiglu(_t(g), _t(u)).numpy(),
        np.asarray(jcommon.swiglu(jnp.asarray(g), jnp.asarray(u))),
        atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("window,smax", [(None, 32), (8, 32), (16, 16)])
def test_decode_attention_ragged_matches_jax(window, smax):
    """Per-slot lengths, the non-ring window and the ring (Smax ==
    window) branch."""
    rng = np.random.default_rng(1)
    B, H, KV, D = 3, 4, 2, 32
    q = rng.standard_normal((B, 1, H, D), np.float32)
    kc = rng.standard_normal((B, smax, KV, D), np.float32)
    vc = rng.standard_normal((B, smax, KV, D), np.float32)
    lens = np.array([1, 9, 20], np.int32)
    got = attention.decode_attention(_t(q), _t(kc), _t(vc), _t(lens),
                                     window=window).numpy()
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(lens),
                                  window=window)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [None, 6])
def test_chunk_attention_matches_jax(window):
    rng = np.random.default_rng(2)
    B, C, H, KV, D, S = 2, 8, 4, 2, 32, 32
    q = rng.standard_normal((B, C, H, D), np.float32)
    kc = rng.standard_normal((B, S, KV, D), np.float32)
    vc = rng.standard_normal((B, S, KV, D), np.float32)
    lens = np.array([0, 13], np.int32)
    got = attention.chunk_attention(_t(q), _t(kc), _t(vc), _t(lens),
                                    window=window).numpy()
    want = jattn.chunk_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(lens),
                                 window=window)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_cache_updates_match_jax_and_respect_rows():
    rng = np.random.default_rng(3)
    B, S, KV, D, C = 3, 16, 2, 8, 4
    kc = rng.standard_normal((B, S, KV, D), np.float32)
    vc = rng.standard_normal((B, S, KV, D), np.float32)
    kn = rng.standard_normal((B, C, KV, D), np.float32)
    vn = rng.standard_normal((B, C, KV, D), np.float32)
    lens = np.array([0, 5, 12], np.int32)
    k_t, v_t = _t(kc.copy()), _t(vc.copy())
    attention.chunk_cache_update(k_t, v_t, _t(kn), _t(vn), _t(lens))
    kj, vj = jattn.chunk_cache_update(*(jnp.asarray(a) for a in
                                        (kc, vc, kn, vn, lens)))
    chunk_k = np.asarray(kj)
    assert np.array_equal(k_t.numpy(), chunk_k)
    assert np.array_equal(v_t.numpy(), np.asarray(vj))

    k_t, v_t = _t(kc.copy()), _t(vc.copy())
    attention.cache_update(k_t, v_t, _t(kn[:, :1]), _t(vn[:, :1]), _t(lens))
    kj, vj = jattn.cache_update(*(jnp.asarray(a) for a in
                                  (kc, vc, kn[:, :1], vn[:, :1], lens)))
    assert np.array_equal(k_t.numpy(), np.asarray(kj))
    assert np.array_equal(v_t.numpy(), np.asarray(vj))

    # a rows mask writes only the selected slots; the rest stay exact
    k_t, v_t = _t(kc.copy()), _t(vc.copy())
    rows = torch.tensor([0, 2])
    attention.chunk_cache_update(k_t, v_t, _t(kn), _t(vn), _t(lens),
                                 rows=rows)
    assert np.array_equal(k_t.numpy()[1], kc[1])
    assert np.array_equal(v_t.numpy()[1], vc[1])
    assert np.array_equal(k_t.numpy()[[0, 2]], chunk_k[[0, 2]])


def test_flash_chunked_plain_twin_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 64, 4, 32), np.float32)
    k = rng.standard_normal((1, 64, 2, 32), np.float32)
    v = rng.standard_normal((1, 64, 2, 32), np.float32)
    for window in (None, 24):
        got = attention.flash_attention_chunked(
            _t(q), _t(k), _t(v), window=window, q_chunk=16, k_chunk=16)
        want = jattn.flash_attention_jnp(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
            q_chunk=16, k_chunk=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


def test_forward_prefill_decode_chunk_match_jax(weights):
    tree, model = weights
    P = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, CFG.vocab_size, (2, 16)).astype(np.int32)
    lj, _, cj = japi.forward(P, {"tokens": jnp.asarray(toks)}, JCFG,
                             mode="prefill", remat="none")
    lt, _, ct = api.forward(model, {"tokens": _t(toks)}, CFG, mode="prefill")
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(ct["stage1"]["k"].numpy(),
                               np.asarray(cj["stage1"]["k"]), **TOL)

    cj = japi.grow_caches(JCFG, cj, 32)
    ct = api.grow_caches(CFG, ct, 32)
    assert tuple(ct["stage1"]["k"].shape) == cj["stage1"]["k"].shape
    lens = np.array([16, 11], np.int32)           # ragged slots
    cj["len"], ct["len"] = jnp.asarray(lens), _t(lens)
    nt = rng.integers(0, CFG.vocab_size, (2, 1)).astype(np.int32)
    lj, _, cj = japi.forward(P, {"tokens": jnp.asarray(nt)}, JCFG,
                             mode="decode", caches=cj, remat="none")
    lt, _, ct = api.forward(model, {"tokens": _t(nt)}, CFG, mode="decode",
                            caches=ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert np.array_equal(ct["len"].numpy(), np.asarray(cj["len"]))

    ch = rng.integers(0, CFG.vocab_size, (2, 8)).astype(np.int32)
    lj, _, cj = japi.forward(P, {"tokens": jnp.asarray(ch)}, JCFG,
                             mode="chunk", caches=cj, remat="none")
    lt, _, ct = api.forward(model, {"tokens": _t(ch)}, CFG, mode="chunk",
                            caches=ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(ct["stage1"]["v"].numpy(),
                               np.asarray(cj["stage1"]["v"]), **TOL)
    assert np.array_equal(ct["len"].numpy(), np.asarray(cj["len"]))


def test_chunk_past_capacity_raises(weights):
    _, model = weights
    caches = api.init_caches(CFG, 1, 16, device="cpu")
    caches["len"] = torch.tensor([12], dtype=torch.int32)
    with pytest.raises(ValueError):
        api.forward(model, {"tokens": torch.zeros(1, 8, dtype=torch.int32)},
                    CFG, mode="chunk", caches=caches)


def test_bridge_round_trip_is_exact(weights):
    tree, model = weights
    back = bridge.to_numpy(model)
    flat = dict(bridge._leaves(tree))
    assert dict(bridge._leaves(back)).keys() == flat.keys()
    for name, arr in bridge._leaves(back):
        assert np.array_equal(arr, flat[name]), name
    assert tuple(model.stage1.attn["wq"].shape) == (2, 128, 128)


def test_init_params_scales():
    g = torch.Generator().manual_seed(0)
    model = api.build_params(CFG.replace(num_layers=1), g, device="cpu")
    assert torch.equal(model.final_norm, torch.ones(CFG.d_model))
    assert torch.equal(model.stage1.norm1, torch.ones(1, CFG.d_model))
    assert abs(float(model.embed.std()) - 0.02) < 2e-3
    wq = model.stage1.attn["wq"]
    assert abs(float(wq.std()) - CFG.d_model ** -0.5) < 0.01
    w_down = model.stage1.mlp["w_down"]
    assert abs(float(w_down.std()) - CFG.d_ff ** -0.5) < 0.01


def test_param_tree_stack_of_no_layers():
    """A Stack of 0 layers has [0, ...] leaves and no layers; an
    unstacked leaf has no leading axis (stacking is explicit)."""
    from repro_torch.models import params as P
    w = {"w": P.dense(2, 3, fan_in=2)}
    tree = P.ParamTree({"a": P.ones(3), "s": P.Stack(0, w),
                        "t": P.Stack(2, w)}, dtype=torch.float32,
                       device=torch.device("cpu"))
    assert tree.n is None and tuple(tree.a.shape) == (3,)
    assert tree.s.n == 0 and tuple(tree.s.w.shape) == (0, 2, 3)
    assert tree.s.layers() == []
    assert tuple(tree.t.w.shape) == (2, 2, 3) and len(tree.t.layers()) == 2
    assert [n for *_, n in tree.leaves()] == [None, 0, 2]


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        api.build_params(CFG)
    with pytest.raises(RuntimeError):
        api.init_caches(CFG, 1, 16)
    with pytest.raises(RuntimeError):
        api.init_caches(CFG, 1, 16, kv_quant=True)
