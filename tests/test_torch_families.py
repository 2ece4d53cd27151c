"""Every architecture of the registry in the port against the JAX
package on the same weights and inputs (fp32, reduced configs): train,
prefill and three greedy decode steps through ``api.forward``; the
mLSTM's chunked form against its sequential cell; whisper's decode
after a prefill; the VLM backbone with its patch embeddings; the
bridge's round trips of the xlstm, audio and vlm trees; and stages with
no layers (deepseek-moe-16b at one layer, zamba2-7b at one and two),
forward, round trip and checkpoints across packages."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.configs.base import MoEConfig  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import (ARCH_IDS, ShapeConfig,  # noqa: E402
                                 get_config, reduced_config)
from repro_torch.models import api, common, xlstm  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
B, S, STEPS = 2, 12, 3
# layers of each reduced arch: 2, but xlstm needs 8 (its pattern puts
# the sLSTM at index 7)
LAYERS = {arch: 8 if arch == "xlstm-125m" else 2 for arch in ARCH_IDS}


def _t(a):
    return torch.from_numpy(np.array(a))


def _configs(arch, layers):
    return (jax_reduced_config(arch).replace(num_layers=layers,
                                             dtype="float32"),
            reduced_config(arch).replace(num_layers=layers,
                                         dtype="float32"))


def _weights(arch, layers):
    jcfg, cfg = _configs(arch, layers)
    tree = jax.tree.map(np.asarray,
                        japi.build_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, tree, bridge.from_numpy(tree, cfg, device="cpu")


def _batch(cfg, seed=0):
    """tokens [B,S] (+ the stub frontend's embeddings), from numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    elif cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)
    return batch


def _close_trees(got, want, what):
    flat_w = dict(bridge._leaves(jax.tree.map(np.asarray, want)))
    flat_g = dict(bridge._leaves(got))
    assert flat_g.keys() == flat_w.keys(), what
    for name, w in flat_w.items():
        g = flat_g[name]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape or name.endswith("len"), (what, name)
        np.testing.assert_allclose(g, w, err_msg=f"{what} {name}", **TOL)


def test_registry_equals_jax():
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        jc, c = jax_reduced_config(arch), reduced_config(arch)
        for name in ("family", "num_layers", "d_model", "num_heads",
                     "num_kv_heads", "d_ff", "vocab_size",
                     "resolved_head_dim", "qkv_bias", "sliding_window",
                     "rope_theta", "norm_eps", "tie_embeddings",
                     "attn_every", "xlstm_pattern", "encoder_layers",
                     "encoder_ctx", "num_patch_tokens", "dtype"):
            assert getattr(c, name) == getattr(jc, name), (arch, name)
        full = get_config(arch)
        assert bridge.model_class(full) is bridge.model_class(c)
    assert common.padded_vocab(256_000) == jcommon.padded_vocab(256_000)
    assert common.padded_vocab(152_064) == jcommon.padded_vocab(152_064)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_train_prefill_decode_match_jax(arch):
    """Train logits, prefill logits and caches, then three greedy decode
    steps (the JAX fp32 argmax fed to both) into caches grown to
    S + STEPS."""
    jcfg, cfg, tree, model = _weights(arch, LAYERS[arch])
    batch = _batch(cfg)
    tbatch = {k: _t(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for mode in ("train", "prefill"):
        want, _, jc = japi.forward(tree, jbatch, jcfg, mode=mode)
        got, _, tc = api.forward(model, tbatch, cfg, mode=mode)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   err_msg=f"{arch} {mode}", **TOL)
    if cfg.family in ("audio", "xlstm", "vlm"):
        _close_trees(tc, jc, f"{arch} prefill caches")
    ctx = want.shape[1]
    jc = japi.grow_caches(jcfg, jc, ctx + STEPS)
    tc = api.grow_caches(cfg, tc, ctx + STEPS)
    tok = np.asarray(jnp.argmax(want[:, -1], axis=-1)).astype(np.int32)
    for step in range(STEPS):
        want, _, jc = japi.forward(tree, {"tokens": jnp.asarray(tok[:, None])},
                                   jcfg, mode="decode", caches=jc)
        got, _, tc = api.forward(model, {"tokens": _t(tok[:, None])}, cfg,
                                 mode="decode", caches=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"{arch} decode {step}", **TOL)
        tok = np.asarray(jnp.argmax(want[:, -1], axis=-1)).astype(np.int32)
    if cfg.family != "xlstm":
        assert np.array_equal(np.broadcast_to(tc["len"].numpy(), (B,)),
                              np.broadcast_to(np.asarray(jc["len"]), (B,)))


@pytest.mark.parametrize("S_", [37, 64, 130])
def test_mlstm_chunked_matches_sequential_cell(S_):
    """The chunked mLSTM against the sequential cell, from a nonzero
    state: one chunk (64), two of 65 (130), 37 of 1 (a prime S).  The
    cell is the JAX cell's twin (the decode steps of
    test_forward_train_prefill_decode_match_jax hold it to JAX)."""
    rng = np.random.default_rng(S_)
    Bn, H, Pd = 2, 2, 16
    q, k, v = (rng.standard_normal((Bn, S_, H, Pd)).astype(np.float32)
               for _ in range(3))
    i_pre = rng.standard_normal((Bn, S_, H)).astype(np.float32)
    f_pre = (rng.standard_normal((Bn, S_, H)) + 2).astype(np.float32)
    C0 = rng.standard_normal((Bn, H, Pd, Pd)).astype(np.float32) * 0.1
    n0 = rng.standard_normal((Bn, H, Pd)).astype(np.float32) * 0.1
    m0 = rng.standard_normal((Bn, H)).astype(np.float32)
    args = [_t(a) for a in (q, k, v, i_pre, f_pre)]
    h, (C, n, m) = xlstm._mlstm_chunked(*args, (_t(C0), _t(n0), _t(m0)))
    carry, hs = (_t(C0), _t(n0), _t(m0)), []
    for t in range(S_):
        carry, ht = xlstm._mlstm_cell(carry, *(a[:, t] for a in args))
        hs.append(ht)
    np.testing.assert_allclose(h.numpy(), torch.stack(hs, 1).numpy(), **TOL)
    for a, b in zip((C, n, m), carry):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_sinusoids_match_jax():
    pos = np.array([0, 3, 1499], np.int32)
    np.testing.assert_allclose(
        common.sinusoidal_positions(40, 64).numpy(),
        np.asarray(jcommon.sinusoidal_positions(40, 64)), **TOL)
    np.testing.assert_allclose(
        common.sinusoid_at(_t(pos), 384).numpy(),
        np.asarray(jwhisper._sinusoid_at(jnp.asarray(pos), 384)), **TOL)


def test_whisper_decode_after_prefill_and_cache_layout():
    """Prefill 12 tokens, decode one: the self-attention cache grows,
    the cross K/V stay the encoder's, and the decode logits equal the
    last row of a 13-token prefill."""
    jcfg, cfg, tree, model = _weights("whisper-tiny", 2)
    batch = {k: _t(v) for k, v in _batch(cfg, seed=3).items()}
    full, _, _ = api.forward(model, batch, cfg, mode="prefill")
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    _, _, caches = api.forward(model, short, cfg, mode="prefill")
    caches = api.grow_caches(cfg, caches, S + 4)
    L, Ctx = cfg.num_layers, cfg.encoder_ctx
    assert tuple(caches["k"].shape) == (L, B, S + 4, 4, 32)
    assert tuple(caches["xk"].shape) == (L, B, Ctx, 4, 32)
    xk = caches["xk"].clone()
    step, _, caches = api.forward(model, {"tokens": batch["tokens"][:, -1:]},
                                  cfg, mode="decode", caches=caches)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               **TOL)
    assert torch.equal(caches["xk"], xk)
    assert caches["len"].tolist() == [S, S]
    empty = api.init_caches(cfg, 3, 16, device="cpu")
    want = jax.eval_shape(lambda: japi.init_caches(jcfg, 3, 16))
    for name in ("k", "v", "xk", "xv"):
        assert tuple(empty[name].shape) == want[name].shape, name


def test_internvl_patches_and_input_specs():
    """The VLM backbone prepends the patches: its logits cover P + St
    positions, decode positions count the patches, and the port's
    input specs and synthesized batch have the JAX shapes."""
    jcfg, cfg, tree, model = _weights("internvl2-76b", 2)
    batch = _batch(cfg, seed=5)
    P = cfg.num_patch_tokens
    got, _, caches = api.forward(model, {k: _t(v) for k, v in batch.items()},
                                 cfg, mode="prefill")
    assert got.shape[1] == P + S and int(caches["len"]) == P + S
    # patches change every text position's logits
    other = dict(batch, patch_embeds=batch["patch_embeds"] + 1)
    moved, _, _ = api.forward(model, {k: _t(v) for k, v in other.items()},
                              cfg, mode="prefill")
    assert not np.allclose(moved[:, P:].numpy(), got[:, P:].numpy())
    for kind, seq in (("train", 64), ("prefill", 64), ("decode", 64)):
        for arch in ("internvl2-76b", "whisper-tiny", "xlstm-125m"):
            c = reduced_config(arch)
            spec = api.input_specs(c, ShapeConfig("s", seq, 2, kind))
            jspec = japi.input_specs(jax_reduced_config(arch),
                                     JShapeConfig("s", seq, 2, kind))
            assert spec.keys() == jspec.keys()
            for name, s in spec.items():
                assert s.shape == jspec[name].shape, (arch, kind, name)
                assert (str(s.dtype).replace("torch.", "")
                        == str(jspec[name].dtype)), (arch, kind, name)
            b = api.synthesize_batch(c, ShapeConfig("s", seq, 2, kind),
                                     torch.Generator().manual_seed(0),
                                     device="cpu")
            assert {k: (tuple(v.shape), v.dtype) for k, v in b.items()} \
                == {k: (s.shape, s.dtype) for k, s in spec.items()}
            assert int(b["tokens"].max()) < c.vocab_size


@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-tiny",
                                  "internvl2-76b", "qwen2.5-32b"])
def test_bridge_round_trip_and_init(arch):
    """from_numpy / to_numpy give back the JAX tree exactly; the port's
    own init fills every leaf by its spec (gates fp32 in bf16)."""
    _, cfg, tree, model = _weights(arch, LAYERS[arch])
    back = dict(bridge._leaves(bridge.to_numpy(model)))
    flat = dict(bridge._leaves(tree))
    assert back.keys() == flat.keys()
    for name, a in flat.items():
        assert np.array_equal(back[name], a), name
    m = api.build_params(cfg.replace(dtype="bfloat16"),
                         torch.Generator().manual_seed(0), device="cpu")
    assert m.embed.dtype == torch.bfloat16
    assert abs(float(m.embed.float().std()) - 0.02) < 2e-3
    if arch == "xlstm-125m":
        cell = m.layer_00.cell
        assert cell.b_f.dtype == torch.float32
        assert torch.equal(cell.b_f, torch.full_like(cell.b_f, 3.0))
        s = m.layer_07.cell
        assert torch.equal(s.b_f, torch.ones_like(s.b_f))
        assert torch.equal(s.b_i, torch.zeros_like(s.b_i))
        assert abs(float(s.r_i.std()) - 64 ** -0.5) < 0.01
    if arch == "qwen2.5-32b":
        assert torch.equal(m.stage1.attn.bq, torch.zeros_like(
            m.stage1.attn.bq))


@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-tiny",
                                  "internvl2-76b"])
def test_engine_refuses_families_it_cannot_serve(arch):
    """The JAX engine serves none of these families; the port's engine
    says so when it is built, and api.forward refuses per-slot writes
    for the two whose caches have no slot layout of the engine's."""
    cfg = reduced_config(arch).replace(num_layers=LAYERS[arch],
                                       dtype="float32")
    model = api.build_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="api.forward"):
        Engine(cfg, model, max_len=64)
    if cfg.family != "vlm":
        with pytest.raises(NotImplementedError, match="rows"):
            api.forward(model, {"tokens": torch.zeros((1, 1),
                                                      dtype=torch.long)},
                        cfg, mode="decode",
                        caches=api.init_caches(cfg, 1, 8, device="cpu"),
                        rows=torch.tensor([0]))


ZERO_LAYER = [("deepseek-moe-16b", 1), ("zamba2-7b", 1), ("zamba2-7b", 2)]


@pytest.mark.parametrize("arch,layers", ZERO_LAYER)
def test_stage_with_no_layers_matches_jax(arch, layers, tmp_path):
    """A stage of no layers (deepseek's stage1 beside first_k_dense = 1,
    zamba2's blocks below attn_every = 3): [0, ...] leaves through the
    bridge, init_params, prefill and decode against JAX, and a JAX
    checkpoint of the tree restoring into the port's model.  The JAX
    decode of deepseek's empty stage raises (its scan indexes the empty
    stack), so that decode is held to the same weights as a one-layer
    dense decoder."""
    jcfg, cfg, tree, model = _weights(arch, layers)
    jcfg0 = jcfg
    stage = model.stage1 if arch.startswith("deepseek") else model.blocks
    assert stage.n == 0 and stage.layers() == []
    back = dict(bridge._leaves(bridge.to_numpy(model)))
    for name, a in bridge._leaves(tree):
        assert back[name].shape == a.shape and np.array_equal(back[name], a)
    batch = _batch(cfg, seed=7)
    want, _, jc = japi.forward(tree, {"tokens": jnp.asarray(batch["tokens"])},
                               jcfg, mode="prefill")
    got, _, tc = api.forward(model, {"tokens": _t(batch["tokens"])}, cfg,
                             mode="prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close_trees(tc, jc, f"{arch} {layers} prefill caches")
    if arch.startswith("deepseek"):
        # the JAX decode scan cannot index an empty stack; its oracle is
        # the same model as a one-layer dense decoder (stage0 renamed)
        jcfg = jcfg.replace(family="dense", moe=MoEConfig(),
                            d_ff=jcfg.moe.dense_d_ff)
        tree = {k: v for k, v in tree.items() if k != "stage0"}
        tree["stage1"] = _weights(arch, layers)[2]["stage0"]
        want, _, jc = japi.forward(
            tree, {"tokens": jnp.asarray(batch["tokens"])}, jcfg,
            mode="prefill")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jc = japi.grow_caches(jcfg, jc, S + 1)
    tc = api.grow_caches(cfg, tc, S + 1)
    tok = np.asarray(jnp.argmax(want[:, -1], axis=-1)).astype(np.int32)
    want, _, _ = japi.forward(tree, {"tokens": jnp.asarray(tok[:, None])},
                              jcfg, mode="decode", caches=jc)
    got, _, _ = api.forward(model, {"tokens": _t(tok[:, None])}, cfg,
                            mode="decode", caches=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    own = api.build_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    logits, _, caches = api.forward(own, {"tokens": _t(batch["tokens"])},
                                    cfg, mode="prefill")
    assert bool(torch.isfinite(logits).all())
    empty = api.init_caches(cfg, B, 16, device="cpu")
    assert all(t.shape[0] == 0 for t in (
        empty["stage1"] if arch.startswith("deepseek") else empty["kv"]
    ).values())
    other = japi.build_params(jax.random.PRNGKey(1), jcfg0)
    jstore.save(str(tmp_path), 1, {"params": other})
    restored, _ = store.restore(str(tmp_path), 1, {"params": own})
    moved = dict(bridge._leaves(bridge.to_numpy(restored["params"])))
    for name, a in bridge._leaves(jax.tree.map(np.asarray, other)):
        assert np.array_equal(moved[name], a), name
