"""The port's MoE family against the JAX package on the same inputs:
capacity, the plain capacity-buffer gather and the plain dispatch (sort,
capacity cut and gather, against the JAX sort dispatch; bit-exact),
``moe_forward
(y and aux, with and without capacity drops), the two-stage
DeepSeek-MoE and single-stage OLMoE decoders in the prefill, decode and
chunk modes, and the parameter tree (reduced configs, fp32)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels.moe_dispatch.ref import moe_gather_ref as jgather  # noqa: E402,E501
from repro.models import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops as dispatch_ops  # noqa: E402
from repro_torch.kernels.moe_dispatch.ref import (  # noqa: E402
    moe_dispatch_ref, moe_gather_ref)
from repro_torch.models import api, moe  # noqa: E402

ARCHS = ("olmoe-1b-7b", "deepseek-moe-16b")
TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(arch, layers=2):
    return (jax_reduced_config(arch).replace(num_layers=layers,
                                             dtype="float32"),
            reduced_config(arch).replace(num_layers=layers, dtype="float32"))


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    jcfg, cfg = _cfgs(request.param)
    tree = jax.tree.map(np.asarray,
                        japi.build_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, tree, bridge.from_numpy(tree, cfg, device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_capacity_matches_jax():
    for arch in ARCHS:
        for T in (1, 2, 32, 64, 100, 128, 1000):
            assert (moe.moe_capacity(T, get_config(arch))
                    == jmoe.moe_capacity(T, get_config(arch)))
    cfg = get_config("deepseek-moe-16b")
    assert [moe.moe_capacity(T, cfg) for T in (2, 32, 64, 128)] \
        == [8, 8, 8, 16]


@pytest.mark.parametrize("T,d,E,C", [(32, 16, 2, 8), (64, 32, 4, 24),
                                     (128, 64, 8, 16), (2, 2048, 64, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_plain_bit_exact_with_reference(T, d, E, C, dtype):
    """Empty (-1), out-of-range (>= T) and duplicate slot indices."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((T, d), np.float32)
    st = np.full(E * C, -1, np.int32)
    nfill = min(E * C, T) // 2
    st[:nfill] = rng.integers(0, T, nfill)
    st[nfill:nfill + 3] = [T, T + 5, st[0]]
    st = rng.permutation(st)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = moe_gather_ref(xt, torch.from_numpy(st), E, C)
    want = jgather(jnp.asarray(x).astype(getattr(jnp, dtype)),
                   jnp.asarray(st), E, C)
    assert got.dtype == xt.dtype and tuple(got.shape) == (E, C, d)
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


def _jax_dispatch(eidx: np.ndarray, x, E: int, C: int):
    """The sort dispatch of ``repro.models.moe.moe_forward``, with the
    same jnp ops: (buf [E, C, d], dest [T*k] in sorted order, sort_idx,
    counts)."""
    T, k = eidx.shape
    flat_e = jnp.asarray(eidx).reshape(T * k)
    sort_idx = jnp.argsort(flat_e)                          # stable
    sorted_e = jnp.take(flat_e, sort_idx)
    counts = jnp.zeros(E, jnp.int32).at[flat_e].add(1)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(T * k, dtype=jnp.int32) - jnp.take(starts, sorted_e)
    dest = jnp.where(pos < C, sorted_e * C + pos, E * C)
    token_of = sort_idx // k
    buf = jnp.zeros((E * C + 1, x.shape[1]), x.dtype)
    buf = buf.at[dest].set(jnp.take(x, token_of, axis=0), mode="drop")
    return buf[:E * C].reshape(E, C, -1), dest, sort_idx, counts


@pytest.mark.parametrize("T", [1, 2, 33, 64])
@pytest.mark.parametrize("drops", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_plain_matches_jax_sort(T, drops, dtype):
    """Each token's k distinct experts, expert 0 among them at a random
    place; with `drops` the capacity is one average expert's load, so
    expert 0 overflows it (from T = 2), else every pair fits.  buf is
    bit-exact, dest_tk is JAX's dest un-sorted, counts are equal; the
    wrapper on CPU tensors runs the plain version and counts no launch."""
    E, k, d = 8, 3, 32
    rng = np.random.default_rng(T)
    eidx = np.stack([rng.permutation(np.r_[0, 1 + rng.permutation(E - 1)
                                           [:k - 1]]) for _ in range(T)])
    C = max(1, T * k // E) if drops else T
    x = rng.standard_normal((T, d), np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    buf, dest_tk, counts = moe_dispatch_ref(torch.from_numpy(eidx), xt, E,
                                            C)
    jbuf, jdest, jsort, jcounts = _jax_dispatch(
        eidx, jnp.asarray(x).astype(getattr(jnp, dtype)), E, C)
    want_tk = np.empty(T * k, np.int64)
    want_tk[np.asarray(jsort)] = np.asarray(jdest)
    assert buf.dtype == xt.dtype and tuple(buf.shape) == (E, C, d)
    assert np.array_equal(buf.float().numpy(),
                          np.asarray(jbuf.astype(jnp.float32)))
    assert dest_tk.dtype == counts.dtype == torch.int32
    assert np.array_equal(dest_tk.numpy(), want_tk)
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))
    assert bool((dest_tk == E * C).any()) == (drops and T >= 2)
    n0 = dispatch_ops.launches
    got = dispatch_ops.moe_dispatch(torch.from_numpy(eidx), xt, E, C)
    assert all(torch.equal(a, b) for a, b in zip(got, (buf, dest_tk,
                                                        counts)))
    assert dispatch_ops.launches == n0          # CPU: the plain version


@pytest.mark.parametrize("drops", [False, True])
def test_moe_forward_matches_jax(family, drops):
    """y and aux against ``repro.models.moe.moe_forward``; with `drops`,
    every token is the same row, so all route to the same top-k experts
    and most pairs overflow the capacity."""
    jcfg, cfg, tree, model = family
    lp = jax.tree.map(lambda a: a[-1], tree["stage1"]["moe"])
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, cfg.d_model), np.float32)
    if drops:
        x[:] = x[0, 0]
        cap = moe.moe_capacity(32, cfg)
        assert 32 > cap                          # one expert gets all 32
    yj, auxj = jmoe.moe_forward(jax.tree.map(jnp.asarray, lp),
                                jnp.asarray(x), jcfg)
    stage = model["stage1"]
    yt, auxt = moe.moe_forward(stage.layer(stage.n - 1)["moe"], _t(x), cfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)


def test_decoder_prefill_decode_chunk_match_jax(family):
    jcfg, cfg, tree, model = family
    P = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    lj, aj, cj = japi.forward(P, {"tokens": jnp.asarray(toks)}, jcfg,
                              mode="prefill", remat="none")
    lt, at, ct = api.forward(model, {"tokens": _t(toks)}, cfg,
                             mode="prefill")
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
    assert set(ct) == set(cj)

    cj = japi.grow_caches(jcfg, cj, 32)
    ct = api.grow_caches(cfg, ct, 32)
    lens = np.array([16, 11], np.int32)
    cj["len"], ct["len"] = jnp.asarray(lens), _t(lens)
    nt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    lj, _, cj = japi.forward(P, {"tokens": jnp.asarray(nt)}, jcfg,
                             mode="decode", caches=cj, remat="none")
    lt, _, ct = api.forward(model, {"tokens": _t(nt)}, cfg, mode="decode",
                            caches=ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)

    ch = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    lj, aj, cj = japi.forward(P, {"tokens": jnp.asarray(ch)}, jcfg,
                              mode="chunk", caches=cj, remat="none")
    lt, at, ct = api.forward(model, {"tokens": _t(ch)}, cfg, mode="chunk",
                             caches=ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
    for stage in ct:
        if stage != "len":
            np.testing.assert_allclose(ct[stage]["v"].numpy(),
                                       np.asarray(cj[stage]["v"]), **TOL)


def test_rows_keep_other_slots_and_their_outputs(family):
    """A chunk step restricted to one slot leaves the other slot's cache
    bit-identical, yet computes that slot's logits as if its keys were
    written (the JAX engine's lanes all compute)."""
    _, cfg, _, model = family
    caches = api.init_caches(cfg, 2, 32, device="cpu")
    caches["len"] = torch.tensor([0, 8], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(0))
    before = {s: {k: v.clone() for k, v in caches[s].items()}
              for s in caches if s != "len"}
    full = {s: {k: v.clone() for k, v in caches[s].items()}
            for s in caches if s != "len"}
    full["len"] = caches["len"].clone()
    want, _, _ = api.forward(model, {"tokens": toks}, cfg, mode="chunk",
                             caches=full)
    got, _, _ = api.forward(model, {"tokens": toks}, cfg, mode="chunk",
                            caches=caches, rows=torch.tensor([0]))
    assert torch.equal(got, want)
    for s, leaves in before.items():
        for k, v in leaves.items():
            assert torch.equal(caches[s][k][:, 1], v[:, 1])
            assert torch.equal(caches[s][k][:, 0], full[s][k][:, 0])


def test_bridge_round_trip_and_init_table(family):
    _, cfg, tree, model = family
    flat = dict(bridge._leaves(tree))
    back = dict(bridge._leaves(bridge.to_numpy(model)))
    assert back.keys() == flat.keys()
    for name, arr in back.items():
        assert np.array_equal(arr, flat[name]), name
    m = api.build_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.bfloat16)
    stage = m["stage1"]
    assert stage.moe.router.dtype == torch.float32
    assert stage.moe.w_gate.dtype == torch.bfloat16
    assert abs(float(stage.moe.router.std()) - cfg.d_model ** -0.5) < 0.01
    assert abs(float(stage.moe.w_down.float().std())
               - cfg.moe.d_ff ** -0.5) < 0.02
    if cfg.moe.first_k_dense:
        assert tuple(m.stage0.mlp.w_gate.shape) == (
            cfg.moe.first_k_dense, cfg.d_model, cfg.moe.dense_d_ff)
        assert "shared" in stage.moe
