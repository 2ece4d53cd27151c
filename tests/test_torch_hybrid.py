"""The port's hybrid-SSM family (zamba2) against the JAX package on the
same inputs: the plain SSD intra-chunk block against the Pallas kernel
(interpret mode), ``causal_conv``, ``ssd_chunked`` (init state, a
forced head-group split, a chunk length that is no tile multiple),
``ssd_decode_step``, ``mamba2_forward`` and the whole model in the
prefill and decode modes (reduced zamba2-7b, fp32), also with the
long-context cell's windowed shared attention through a ring that
wraps."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels.ssm_scan.ops import ssd_intra as pallas_ssd  # noqa: E402
from repro.kernels.ssm_scan.ref import ssd_intra_ref as jssd_ref  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssd_intra_ref  # noqa: E402
from repro_torch.models import api, ssm, zamba  # noqa: E402

ARCH = "zamba2-7b"
JCFG = jax_reduced_config(ARCH).replace(dtype="float32")
CFG = reduced_config(ARCH).replace(dtype="float32")
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(np.asarray,
                        japi.build_params(jax.random.PRNGKey(0), JCFG))
    return tree, bridge.from_numpy(tree, CFG, device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ssd_inputs(rng, B, nc, Q, H, P, N):
    cum = np.cumsum(-np.abs(rng.standard_normal((B, nc, Q, H))), axis=2)
    return (cum.astype(np.float32),
            rng.standard_normal((B, nc, Q, H, P)).astype(np.float32),
            rng.standard_normal((B, nc, Q, N)).astype(np.float32),
            rng.standard_normal((B, nc, Q, N)).astype(np.float32))


@pytest.mark.parametrize("B,nc,Q,H,P,N", [
    (1, 2, 16, 2, 8, 4), (2, 3, 32, 4, 16, 8), (1, 1, 64, 1, 32, 16),
    (1, 2, 13, 3, 8, 4)])
def test_ssd_intra_plain_matches_pallas(B, nc, Q, H, P, N):
    args = _ssd_inputs(np.random.default_rng(3), B, nc, Q, H, P, N)
    y, s = ssd_intra_ref(*(_t(a) for a in args))
    for yj, sj in (pallas_ssd(*(jnp.asarray(a) for a in args)),
                   jssd_ref(*(jnp.asarray(a) for a in args))):
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(sj), **TOL)
    n0 = ssd_ops.launches
    y2, _ = ssd_ops.ssd_intra(*(_t(a) for a in args))
    assert torch.equal(y2, y) and ssd_ops.launches == n0


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 12), np.float32)
    w = rng.standard_normal((12, 4), np.float32)
    st = rng.standard_normal((2, 3, 12), np.float32)
    for state in (None, st):
        yt, nt = ssm.causal_conv(_t(x), _t(w),
                                 None if state is None else _t(state))
        yj, nj = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  None if state is None
                                  else jnp.asarray(state))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6)
        assert np.array_equal(nt.numpy(), np.asarray(nj))


@pytest.mark.parametrize("L,chunk,budget,init", [
    (32, 16, 32 * 1024 * 1024, False),    # two chunks
    (32, 16, 2 * 16 * 16, True),          # head groups of 1, init state
    (26, 16, 32 * 1024 * 1024, True),     # Q = 13
])
def test_ssd_chunked_matches_jax(L, chunk, budget, init):
    rng = np.random.default_rng(5)
    B, H, P, N = 2, 4, 8, 4
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((B, L, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, P)).astype(np.float32) \
        if init else None
    yt, ft = ssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk,
                             init_state=None if s0 is None else _t(s0),
                             decay_budget=budget)
    yj, fj = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                              chunk, init_state=None if s0 is None
                              else jnp.asarray(s0), decay_budget=budget)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **TOL)
    # the decode step continues the scan from the final state
    y1, s1 = ssm.ssd_decode_step(ft, _t(x[:, :1]), _t(dt[:, :1]), _t(A),
                                 _t(Bm[:, :1]), _t(Cm[:, :1]))
    yj1, sj1 = jssm.ssd_decode_step(fj, *(jnp.asarray(a) for a in (
        x[:, :1], dt[:, :1], A, Bm[:, :1], Cm[:, :1])))
    np.testing.assert_allclose(y1.numpy(), np.asarray(yj1), **TOL)
    np.testing.assert_allclose(s1.numpy(), np.asarray(sj1), **TOL)


def test_mamba2_forward_prefill_decode_match_jax(weights):
    tree, model = weights
    lp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"]["mixer"])
    tp = model.blocks.layer(0)["mixer"]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, CFG.d_model)).astype(np.float32)
    yj, cj = jssm.mamba2_forward(lp, jnp.asarray(x), JCFG, mode="prefill")
    yt, ct = ssm.mamba2_forward(tp, _t(x), CFG, mode="prefill")
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for k in cj:
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), **TOL)
    x1 = rng.standard_normal((2, 1, CFG.d_model)).astype(np.float32)
    yj, cj = jssm.mamba2_forward(lp, jnp.asarray(x1), JCFG, mode="decode",
                                 cache=cj)
    cache = {k: v.clone() for k, v in ct.items()}
    yt, _ = ssm.mamba2_forward(tp, _t(x1), CFG, mode="decode", cache=cache)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for k in cj:                                # written in place
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(cj[k]),
                                   **TOL)
    # rows: only slot 1's states move
    cache = {k: v.clone() for k, v in ct.items()}
    ssm.mamba2_forward(tp, _t(x1), CFG, mode="decode", cache=cache,
                       rows=torch.tensor([1]))
    for k in cj:
        assert torch.equal(cache[k][0], ct[k][0])
        np.testing.assert_allclose(cache[k][1].numpy(),
                                   np.asarray(cj[k])[1], **TOL)


def test_zamba_prefill_decode_match_jax(weights):
    tree, model = weights
    P = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, CFG.vocab_size, (2, 16)).astype(np.int32)
    lj, _, cj = japi.forward(P, {"tokens": jnp.asarray(toks)}, JCFG,
                             mode="prefill", remat="none")
    lt, _, ct = api.forward(model, {"tokens": _t(toks)}, CFG, mode="prefill")
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(ct["mamba"]["ssm"].numpy(),
                               np.asarray(cj["mamba"]["ssm"]), **TOL)
    assert int(ct["len"]) == int(cj["len"]) == 16

    cj = japi.grow_caches(JCFG, cj, 32)
    ct = api.grow_caches(CFG, ct, 32)
    cj["len"] = jnp.asarray(np.array([16, 16], np.int32))
    ct["len"] = torch.tensor([16, 16], dtype=torch.int32)
    for _ in range(2):
        nt = rng.integers(0, CFG.vocab_size, (2, 1)).astype(np.int32)
        lj, _, cj = japi.forward(P, {"tokens": jnp.asarray(nt)}, JCFG,
                                 mode="decode", caches=cj, remat="none")
        lt, _, ct = api.forward(model, {"tokens": _t(nt)}, CFG,
                                mode="decode", caches=ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for part in ("mamba", "tail"):
        for k in cj[part]:
            np.testing.assert_allclose(ct[part][k].numpy(),
                                       np.asarray(cj[part][k]), **TOL)
    np.testing.assert_allclose(ct["kv"]["k"].numpy(),
                               np.asarray(cj["kv"]["k"]), **TOL)
    assert np.array_equal(ct["len"].numpy(), np.asarray(cj["len"]))


def test_zamba_tree_caches_and_deferred_paths(weights):
    tree, model = weights
    flat = dict(bridge._leaves(tree))
    back = dict(bridge._leaves(bridge.to_numpy(model)))
    assert back.keys() == flat.keys()
    for name, arr in back.items():
        assert np.array_equal(arr, flat[name]), name
    m = api.build_params(CFG, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.bfloat16)
    mixer = m.blocks.mixer
    for name, fill in (("A_log", 0.0), ("D", 1.0), ("dt_bias", 0.0)):
        leaf = mixer[name]
        assert leaf.dtype == torch.float32
        assert torch.equal(leaf, torch.full_like(leaf, fill))
    assert mixer.conv_x.dtype == torch.bfloat16
    W = CFG.ssm.d_conv
    assert abs(float(mixer.conv_x.float().std()) - W ** -0.5) < 0.03
    caches = api.init_caches(CFG, 3, 32, device="cpu")
    n_groups, g, tail = zamba.plan(CFG)
    assert (n_groups, g, tail) == (1, 3, 1)
    assert zamba.plan(get_config(ARCH)) == (13, 6, 3)
    assert tuple(caches["kv"]["k"].shape) == (1, 3, 32, 4, 32)
    assert tuple(caches["mamba"]["ssm"].shape) == (3, 3, 8, 16, 32)
    assert caches["mamba"]["ssm"].dtype == torch.float32
    assert not api.supports_chunked_prefill(CFG)
    with pytest.raises(NotImplementedError):
        api.forward(model, {"tokens": torch.zeros(1, 4, dtype=torch.int32)},
                    CFG, mode="chunk", caches=caches)
    # long_context: a ring of min(max_len, ZAMBA_LONG_WINDOW) slots
    assert api.ZAMBA_LONG_WINDOW == japi.ZAMBA_LONG_WINDOW == 4096
    ring = api.init_caches(CFG, 1, 16, device="cpu", long_context=True)
    assert tuple(ring["kv"]["k"].shape) == (1, 1, 16, 4, 32)


def test_long_context_matches_jax_through_ring_wrap(weights, monkeypatch):
    """zamba2's long-context cell (the shared attention windowed to
    ``ZAMBA_LONG_WINDOW``, patched to 8 in both packages), fp32: the
    caches of ``init_caches(long_context=True)`` have the JAX shapes; a
    prefill of exactly 8 tokens fills the 8-slot ring, and 12 decode
    steps wrap it (each writes at len % 8); every step's logits and a
    windowed 20-token prefill's are within 1e-5 of JAX's, relative to
    their largest entry.  Each decode step also equals that prefill's
    logits at its position (TOL): the ring holds the window's keys."""
    W = 8
    monkeypatch.setattr(japi, "ZAMBA_LONG_WINDOW", W)
    monkeypatch.setattr(api, "ZAMBA_LONG_WINDOW", W)
    tree, model = weights
    P = jax.tree.map(jnp.asarray, tree)
    for max_len in (6, 64):
        cj = japi.init_caches(JCFG, 2, max_len, long_context=True)
        ct = api.init_caches(CFG, 2, max_len, device="cpu",
                             long_context=True)
        assert ({n: tuple(np.shape(v)) for n, v in bridge._leaves(ct)}
                == {n: tuple(np.shape(v)) for n, v in bridge._leaves(cj)})
        assert ct["kv"]["k"].shape[2] == min(max_len, W)

    def close(got, want):
        got, want = got.numpy(), np.asarray(want)
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-5, err

    toks = np.random.default_rng(7).integers(
        0, CFG.vocab_size, (1, 20)).astype(np.int32)
    fj, _, _ = japi.forward(P, {"tokens": jnp.asarray(toks)}, JCFG,
                            mode="prefill", remat="none", long_context=True)
    ft, _, _ = api.forward(model, {"tokens": _t(toks)}, CFG,
                           mode="prefill", long_context=True)
    close(ft, fj)
    lj, _, cj = japi.forward(P, {"tokens": jnp.asarray(toks[:, :W])}, JCFG,
                             mode="prefill", remat="none", long_context=True)
    lt, _, ct = api.forward(model, {"tokens": _t(toks[:, :W])}, CFG,
                            mode="prefill", long_context=True)
    close(lt, lj)
    assert ct["kv"]["k"].shape[2] == cj["kv"]["k"].shape[2] == W
    decode = jax.jit(lambda p, b, c: japi.forward(
        p, b, JCFG, mode="decode", caches=c, remat="none",
        long_context=True))
    for i in range(W, 20):
        nt = toks[:, i:i + 1]
        lj, _, cj = decode(P, {"tokens": jnp.asarray(nt)}, cj)
        lt, _, ct = api.forward(model, {"tokens": _t(nt)}, CFG,
                                mode="decode", caches=ct, long_context=True)
        close(lt, lj)
        np.testing.assert_allclose(lt[0, -1].numpy(), ft[0, i].numpy(),
                                   **TOL)
    np.testing.assert_allclose(ct["kv"]["k"].numpy(),
                               np.asarray(cj["kv"]["k"]), **TOL)
    assert int(ct["len"]) == int(cj["len"]) == 20
