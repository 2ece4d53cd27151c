"""The int8 KV-cache decode path against the JAX package on the CPU:
``quantize_kv`` against ``_quantize_kv`` (bit for bit), the plain
``decode_attention_q8_ref`` against ``decode_attention_q8`` (G 1 / 2 / 5,
D 32 / 80 / 96, a ring, a window that is not a ring, per-slot lens) and
its quantized probabilities through an identity V payload, decode
through ``api.forward`` on int8 caches for reduced fp32 phi3, danube
(its window-16 ring wraps), qwen, olmoe and internvl through ``bridge``
weights, the families that ignore ``kv_quant``, the error paths (no
chunked prefill into an int8 cache; a CUDA call that cannot build or
launch raises and never falls back), and the kernel's plan at every
shape the card runs.  Inputs come from numpy seeds.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_q8 import ops as q8_ops  # noqa: E402
from repro_torch.kernels.decode_q8.ref import (  # noqa: E402
    decode_attention_q8_ref)
from repro_torch.models import api, attention  # noqa: E402
from repro_torch.models.kv_quant import (  # noqa: E402
    dequantize_kv, quantize_kv)

# ref vs JAX: both fp32 on the CPU with the same int32 scores, so they
# differ only by the exponentials and the softmax sum's order: measured
# max |got - want| <= 2.0e-7 of max |want| over CASES, with no pq entry
# apart (test_pq_matches_jax_through_identity_v).  A flip of one pq
# step would move an output by ps·|v| (~1e-2 of max |want| here), so
# 1e-6 holds the two to the same quantized probabilities.
REF_TOL = 1e-6
CASES = [  # B, Smax, KV, G, D, lens, window
    (2, 40, 4, 1, 32, [40, 40], None),
    (2, 40, 2, 2, 80, [17, 40], None),
    (2, 40, 2, 5, 32, [3, 33], None),
    (2, 24, 2, 2, 96, 24, None),                # a scalar length
    (2, 16, 2, 4, 80, [20, 30], 16),            # a ring past its wrap
    (2, 40, 2, 4, 80, [20, 30], 8),             # a window, not a ring
    (3, 64, 2, 5, 32, [1, 37, 64], None),       # per-slot lens
]


def _cache(rng, B, Smax, KV, D):
    """A random int8 cache, quantized from N(0, 1) by the port (its
    bits equal the JAX package's: test_quantize_kv_matches_jax), as
    torch tensors and jax arrays."""
    k, v = (torch.from_numpy(rng.standard_normal((B, Smax, KV, D))
                             .astype(np.float32)) for _ in range(2))
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    cache = dict(k=kq, v=vq, k_scale=ks, v_scale=vs)
    return cache, {n: jnp.asarray(t.numpy()) for n, t in cache.items()}


@pytest.mark.parametrize("mag", [1.0, 1e-2, 1e-3, 1e-5, 1e-9, 0.0])
def test_quantize_kv_matches_jax(mag):
    """int8 payload and fp16 scale bit for bit, down to scales that are
    fp16 subnormals (1e-3, 1e-5) or flush to 0 (1e-9), and rows of
    zeros; and the dequantized values."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 1, 4, 80)) * mag).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 0, 1, 5] = 127.5 * mag       # a tie at the largest step
    qj, sj = jattn._quantize_kv(jnp.asarray(x))
    qt, st = quantize_kv(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float16
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy().view(np.uint16),
                          np.asarray(sj).view(np.uint16))
    assert np.array_equal(dequantize_kv(qt, st).numpy(),
                          np.asarray(jattn._dequantize_kv(qj, sj)))


@pytest.mark.parametrize("B,Smax,KV,G,D,lens,window", CASES)
def test_decode_q8_ref_matches_jax(B, Smax, KV, G, D, lens, window):
    rng = np.random.default_rng(Smax * G + D)
    cache, jc = _cache(rng, B, Smax, KV, D)
    q = rng.standard_normal((B, 1, KV * G, D)).astype(np.float32)
    want = np.asarray(jattn.decode_attention_q8(
        jnp.asarray(q), jc, jnp.asarray(np.array(lens, np.int32)),
        window=window))
    got = decode_attention_q8_ref(torch.from_numpy(q), cache,
                                  torch.tensor(lens), window=window)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= REF_TOL, err
    # bf16 q: the same rows quantized from the rounded values
    qb = torch.from_numpy(q).bfloat16()
    want_b = jattn.decode_attention_q8(
        jnp.asarray(q).astype(jnp.bfloat16), jc,
        jnp.asarray(np.array(lens, np.int32)), window=window)
    got_b = decode_attention_q8_ref(qb, cache, torch.tensor(lens),
                                    window=window)
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(got_b.float().numpy(),
                               np.asarray(want_b.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("B,Smax,KV,G,D,lens,window", [
    (2, 64, 2, 5, 80, [64, 50], None), (2, 32, 4, 1, 32, [32, 20], None),
    (2, 16, 2, 4, 80, [20, 30], 16), (2, 64, 2, 4, 96, [40, 60], 8)])
def test_pq_matches_jax_through_identity_v(B, Smax, KV, G, D, lens, window):
    """The JAX function's quantized probabilities, read off its output:
    with v[s, d] = 1 where d == s (Smax <= D) and random v scales, out[d]
    = pq[d]·ps.  They equal the plain version's: no pq entry apart
    (the flip count behind REF_TOL)."""
    rng = np.random.default_rng(D + Smax)
    cache, jc = _cache(rng, B, Smax, KV, D)
    eye = torch.zeros((B, Smax, KV, D), dtype=torch.int8)
    eye[:, torch.arange(Smax), :, torch.arange(Smax)] = 1
    cache["v"], jc["v"] = eye, jnp.asarray(eye.numpy())
    q = rng.standard_normal((B, 1, KV * G, D)).astype(np.float32)
    out = np.asarray(jattn.decode_attention_q8(
        jnp.asarray(q), jc, jnp.asarray(np.array(lens, np.int32)),
        window=window)).reshape(B, KV, G, D)[..., :Smax]
    ps = np.abs(out).max(axis=-1, keepdims=True) / 127.0
    pq_jax = np.rint(out / ps).astype(np.int8)
    _, _, pq, _ = decode_attention_q8_ref(torch.from_numpy(q), cache,
                                          torch.tensor(lens), window=window,
                                          debug=True)
    assert int((pq.numpy() != pq_jax).sum()) == 0


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(3)
    cache, _ = _cache(rng, 2, 16, 2, 32)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 32))
                         .astype(np.float32))
    n = q8_ops.launches
    assert torch.equal(q8_ops.decode_attention_q8(q, cache, 9),
                       decode_attention_q8_ref(q, cache, 9))
    assert q8_ops.launches == n


def _cuda_call(q, cache):
    return q8_ops.decode_attention_q8_cuda(q, cache, 4, window=None)


def test_cuda_wrapper_raises_and_never_falls_back(monkeypatch):
    """Unsupported shapes raise by name; CPU tensors are refused; a meta
    call takes the plain version for its shapes; a call that cannot build
    or launch raises (the checks patched past, as on a card), and no
    launch is counted."""
    rng = np.random.default_rng(5)
    cache, _ = _cache(rng, 1, 8, 2, 32)
    q = torch.zeros((1, 1, 4, 32))
    with pytest.raises(ValueError, match="CUDA"):
        _cuda_call(q, cache)
    bad, _ = _cache(rng, 1, 8, 2, 64)
    with pytest.raises(ValueError, match="head_dim"):
        _cuda_call(torch.zeros((1, 1, 4, 64)), bad)
    with pytest.raises(ValueError, match="query heads"):
        _cuda_call(torch.zeros((1, 1, 32, 32)), cache)
    with pytest.raises(TypeError, match="int8"):
        _cuda_call(q, dict(cache, k=cache["k"].float()))
    # a meta tensor (the dry run) takes the plain version for its shapes
    # and launches nothing; every other device goes to the kernel
    meta = {n: t.to("meta") for n, t in cache.items()}
    n = q8_ops.launches
    out = q8_ops.decode_attention_q8(q.to("meta"), meta, 4)
    assert out.device.type == "meta" and out.shape == q.shape
    assert q8_ops.launches == n

    monkeypatch.setattr(q8_ops, "_check_device", lambda *ts: None)

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "_fns", {})
    monkeypatch.setattr(build, "load", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda_call(q, cache)

    class Lib:
        decode_attention_q8 = staticmethod(lambda *a: 700)
    monkeypatch.setattr(build, "load", lambda name: Lib)
    monkeypatch.setattr(q8_ops, "_launch", lambda fn, dev, *a: fn(*a))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _cuda_call(q, cache)
    assert q8_ops.launches == n


# ---------------------------------------------------------------------------
# the kernel's plan (ops.plan): every shape the card runs
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card_shapes():
    """(B, Smax, KV, G, D) of every gpu case of test_torch_kernels.py, of
    chip_smoke.py's kv_q8 checks, its paths and its timing."""
    cases = _module("_q8_card_cases", ROOT / "tests" / "test_torch_kernels.py")
    smoke = _module("_q8_chip_smoke", ROOT / "chip_smoke.py")
    shapes = {tuple(c[:5]) for c in cases.Q8_CASES}
    shapes |= {tuple(c[:5]) for c in smoke.Q8_CHECKS.values()}
    shapes.add(tuple(smoke.Q8_TIMING))
    for arch, _ in smoke.Q8_MODELS:
        cfg = get_config(arch)
        shapes.add((1, smoke.Q8_PROMPT + smoke.Q8_NEW, cfg.num_kv_heads,
                    cfg.num_heads // cfg.num_kv_heads,
                    cfg.resolved_head_dim))
    return sorted(shapes)


SCRATCH_SHAPE = (1, 131072, 2, 8, 128)
ON_CHIP_SHAPES = [s for s in _card_shapes() if s != SCRATCH_SHAPE]


def _check_plan(pl, B, Smax, KV, G, D):
    assert 1 <= pl.cluster <= q8_ops.MAX_CLUSTER
    assert pl.cluster * pl.block_positions >= Smax
    assert (pl.cluster - 1) * pl.block_positions < Smax
    assert pl.smem_bytes == q8_ops.smem_bytes(pl.on_chip, pl.block_positions,
                                              G, D)
    assert pl.smem_bytes <= 232_448
    per_sm = q8_ops.SMEM_SM // (pl.smem_bytes + q8_ops.SMEM_RESERVED)
    assert per_sm >= pl.blocks_per_sm


@pytest.mark.parametrize("B,Smax,KV,G,D", ON_CHIP_SHAPES)
def test_plan_keeps_the_scores_on_chip(B, Smax, KV, G, D):
    """Every shape the card tests, checks, serves and times: the on-chip
    form (no scratch), a legal cluster, shared memory within a block's."""
    pl = q8_ops.plan(B, Smax, KV, G, D)
    assert pl.on_chip and pl.scratch_bytes == 0
    _check_plan(pl, B, Smax, KV, G, D)


def test_plan_of_the_timing_shape_fits_two_blocks_an_sm():
    smoke = _module("_q8_chip_smoke", ROOT / "chip_smoke.py")
    pl = q8_ops.plan(*smoke.Q8_TIMING)
    assert (pl.on_chip, pl.cluster, pl.blocks_per_sm) == (True, 8, 2)
    assert 2 * (pl.smem_bytes + q8_ops.SMEM_RESERVED) <= q8_ops.SMEM_SM


@pytest.mark.parametrize("shape", [SCRATCH_SHAPE, (1, q8_ops.MAX_SMAX, 1, 8,
                                                   128)])
def test_plan_takes_the_scratch_form_where_scores_do_not_fit(shape):
    pl = q8_ops.plan(*shape)
    B, Smax, KV, G, D = shape
    assert not pl.on_chip and pl.scratch_bytes == 4 * B * KV * G * Smax
    _check_plan(pl, B, Smax, KV, G, D)


def _stage_shapes():
    """(B, Sl, KV, G, D) of the split form's blocks the card runs:
    chip_smoke.py's kv_q8 checks, its timing shape in 1, 4 and 16
    blocks, every head dim the kernel takes at G 1..8, and head counts
    that fill no whole group of stage 0's items."""
    smoke = _module("_q8_chip_smoke", ROOT / "chip_smoke.py")
    shapes = {tuple(c[:5]) for c in smoke.Q8_CHECKS.values()}
    B, S, KV, G, D = smoke.Q8_TIMING
    shapes |= {(B, S // n, KV, G, D) for n in (1, 4, 16)}
    shapes |= {(2, 300, 4, g, d) for d in q8_ops.HEAD_DIMS
               for g in range(1, q8_ops.MAX_GROUP + 1)}
    shapes |= {(2, 300, kv, 2, d) for kv in (1, 2, 3, 5, 12, 32)
               for d in (32, 96)}
    return sorted(shapes)


@pytest.mark.parametrize("B,Sl,KV,G,D", _stage_shapes())
def test_stage_plan_covers_every_position_once(B, Sl, KV, G, D):
    """The ring kernels' plan: stage 0's items whole k m-tiles, stage
    3's whole v groups, each stage's blocks (at most one an item, as
    many as the occupancy allows) taking every position of every (b,
    kv) once, stage 0's block a contiguous run of items, stage 3's
    block one kv head; shared memory within a block's and, at the
    plan's occupancy, an SM's."""
    pl = q8_ops.stage_plan(B, Sl, KV, G, D)
    most = pl.blocks_per_sm * q8_ops.SMS
    for stage, rp in ((0, pl.scores), (3, pl.pq)):
        assert rp.heads * rp.tile == q8_ops.ring_tile(D)
        assert rp.tile % (16 if stage == 0 else 32) == 0
        assert (rp.tiles - 1) * rp.tile < Sl <= rp.tiles * rp.tile
        assert rp.items == B * -(-KV // rp.heads) * rp.tiles
        assert 0 < rp.grid <= min(rp.items, most)
        runs = [q8_ops.stage_items(pl, stage, i) for i in range(rp.grid)]
        assert all(len(r) > 0 for r in runs)
        seen = np.zeros((B, KV, rp.tiles * rp.tile), dtype=np.int64)
        for r in runs:
            for b, kv, t in r:
                seen[b, kv:kv + rp.heads, t * rp.tile:(t + 1) * rp.tile] += 1
        assert (seen == 1).all()        # the last tile's tail too
        assert rp.smem == q8_ops.ring_smem(stage, G, D) \
            <= q8_ops.MAX_SMEM_BLOCK
    assert pl.scores.heads == min(8, 1 << (KV.bit_length() - 1))
    assert pl.scores.grid == min(pl.scores.items, most)
    flat = [it for i in range(pl.scores.grid)
            for it in q8_ops.stage_items(pl, 0, i)]
    assert flat == sorted(flat)          # contiguous runs, in order
    assert pl.pq.grid % KV == 0
    assert min(pl.pq.items, most) - KV < pl.pq.grid
    assert all(len({kv for _, kv, _ in q8_ops.stage_items(pl, 3, i)}) == 1
               for i in range(pl.pq.grid))
    assert pl.blocks_per_sm * (max(pl.scores.smem, pl.pq.smem)
                               + q8_ops.SMEM_RESERVED) <= q8_ops.SMEM_SM
    assert pl.blocks_per_sm == 2     # every shape here fits two an SM


def test_stage_plan_refuses_shapes_the_kernels_do_not_take():
    for shape in [(1, 64, 2, 2, 64), (1, 64, 1, 9, 32), (1, 0, 1, 1, 32)]:
        with pytest.raises(ValueError, match="no plan"):
            q8_ops.stage_plan(*shape)


def test_plan_and_wrapper_refuse_caches_past_max_smax():
    with pytest.raises(ValueError, match="cache positions"):
        q8_ops.plan(1, q8_ops.MAX_SMAX + 1, 1, 1, 32)
    rng = np.random.default_rng(7)
    cache, _ = _cache(rng, 1, q8_ops.MAX_SMAX + 1, 1, 32)
    with pytest.raises(ValueError, match="cache positions"):
        _cuda_call(torch.zeros((1, 1, 1, 32)), cache)


# ---------------------------------------------------------------------------
# the decode path through api.forward
# ---------------------------------------------------------------------------

B, MAX_LEN, STEPS = 2, 40, 24
DECODE_ARCHS = ["phi3-mini-3.8b", "h2o-danube-1.8b", "qwen2.5-32b",
                "olmoe-1b-7b", "internvl2-76b"]
# The two packages' fp32 projections and exponentials differ by
# rounding, so a quantized value can land one step apart: a new k or v
# entry, its fp16 scale, or a quantized probability inside the
# attention.  Measured over 24 steps, 2 layers, 2 slots: phi3, danube
# and olmoe keep every cache entry and scale equal, their logits within
# 7.3e-7 of max |logit| but at one step each (1.4e-3 phi3 step 19, 4.1e-4
# danube step 2: a probability one step apart, gone the next step);
# qwen and internvl (the same reduced shapes) part by one k/v entry at
# step 13 and then drift, 9 int8 entries and 2 fp16 scales apart by
# step 24, logits within 2.3e-3.  A quantized value one step apart
# moves the logits by ~1e-3 of max |logit| at these sizes.
LOGIT_TOL = 5e-3
MAX_FLIPS = 16


def _weights(arch):
    jcfg = jax_reduced_config(arch).replace(num_layers=2, dtype="float32")
    cfg = reduced_config(arch).replace(num_layers=2, dtype="float32")
    tree = jax.tree.map(np.asarray,
                        japi.build_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, tree, bridge.from_numpy(tree, cfg, device="cpu")


def _leaves(tree, prefix=""):
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _leaves(leaf, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", leaf


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_int8_decode_matches_jax(arch):
    """From empty int8 caches, 24 decode steps of numpy tokens: every
    step's logits, and then every int8 cache entry and fp16 scale, in
    both packages (danube's ring of 16 slots wraps at step 16)."""
    jcfg, cfg, tree, model = _weights(arch)
    jc = japi.init_caches(jcfg, B, MAX_LEN, kv_quant=True)
    tc = api.init_caches(cfg, B, MAX_LEN, device="cpu", kv_quant=True)
    want_leaves = dict(_leaves(jc))
    for name, leaf in _leaves(tc):
        w = np.asarray(want_leaves[name])
        assert leaf.numpy().dtype == w.dtype, name
        assert tuple(leaf.shape) == w.shape or name == "len", name
    if cfg.sliding_window:
        assert tc["stage1"]["k"].shape[2] == cfg.sliding_window < STEPS
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    decode = jax.jit(functools.partial(japi.forward, cfg=jcfg,
                                       mode="decode"))
    for step, tok in enumerate(toks):
        want, _, jc = decode(tree, {"tokens": jnp.asarray(tok)}, caches=jc)
        got, _, tc = api.forward(model, {"tokens": torch.from_numpy(tok)},
                                 cfg, mode="decode", caches=tc)
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= LOGIT_TOL, (step, err)
    flips = 0
    want_leaves = dict(_leaves(jax.tree.map(np.asarray, jc)))
    for name, leaf in _leaves(tc):
        got, w = leaf.numpy(), want_leaves[name]
        if name == "len":
            assert (got == STEPS).all() and (np.asarray(w) == STEPS).all()
        elif got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1, name
            flips += int((diff != 0).sum())
        else:
            apart = got.view(np.uint16) != w.view(np.uint16)
            np.testing.assert_allclose(got[apart], w[apart], rtol=2e-3)
            flips += int(apart.sum())
    assert flips <= MAX_FLIPS, flips


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-125m", "whisper-tiny"])
def test_families_that_ignore_kv_quant(arch):
    """hybrid, xlstm and audio caches are the same with and without the
    flag, in both packages."""
    cfg = reduced_config(arch).replace(num_layers=2, dtype="float32")
    if arch == "xlstm-125m":
        cfg = cfg.replace(num_layers=8)
    jcfg = jax_reduced_config(arch).replace(num_layers=cfg.num_layers,
                                            dtype="float32")
    plain = dict(_leaves(api.init_caches(cfg, B, MAX_LEN, device="cpu")))
    quant = dict(_leaves(api.init_caches(cfg, B, MAX_LEN, device="cpu",
                                         kv_quant=True)))
    jquant = dict(_leaves(japi.init_caches(jcfg, B, MAX_LEN,
                                           kv_quant=True)))
    assert plain.keys() == quant.keys() == jquant.keys()
    for name, leaf in plain.items():
        assert torch.equal(leaf, quant[name]), name
        assert quant[name].dtype != torch.int8, name
        assert tuple(leaf.shape) == np.shape(jquant[name]), name


def test_chunk_mode_on_an_int8_cache_raises():
    """Chunked prefill refuses an int8 cache before writing to it, in
    the attention block and through ``api.forward``."""
    _, cfg, _, model = _weights("phi3-mini-3.8b")
    caches = api.init_caches(cfg, B, MAX_LEN, device="cpu", kv_quant=True)
    before = {n: t.clone() for n, t in _leaves(caches)}
    toks = torch.zeros((B, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int8"):
        api.forward(model, {"tokens": toks}, cfg, mode="chunk",
                    caches=caches)
    one = attention.init_kv_cache(cfg, B, MAX_LEN, dtype=torch.float32,
                                  device=torch.device("cpu"), quantized=True)
    lp = model.stage1.layers()[0]["attn"]
    x = torch.zeros((B, 4, cfg.d_model))
    with pytest.raises(ValueError, match="int8"):
        attention.attn_forward(lp, x, torch.zeros((B, 4), dtype=torch.long),
                               cfg=cfg, mode="chunk", cache=one)
    for name, leaf in _leaves(caches):
        assert torch.equal(leaf, before[name]), name
