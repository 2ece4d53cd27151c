"""The port's training path against the JAX trainer on the CPU: the
plain backward versions of the two training kernels (flash attention's
FA-2 backward, RMSNorm's in both forms) against ``jax.vjp``; one train
step of reduced fp32 h2o-danube-1.8b against
``repro.training.loop.make_train_step`` (loss, ce, grad norm, lr, every
grad leaf, the updated params; remat none, full and dots, and
microbatch 2); grad-spike skipping, int8 compression, the fleet step
with a masked pod and the synthetic data stream; the crash-and-resume
loop against a fault-free run, bit for bit; checkpoints across the
two packages; and the train CLI, with its preemption flush and its
one-rank ``--mesh`` (the same losses as the plain run).

Tolerances (fp32 on both sides, sums in other orders): the plain
backwards 1e-5; the train step's loss, ce, grad norm and lr 1e-5
relative, each grad leaf 1e-5 of its largest entry, the updated params
2e-5 absolute (one step moves a weight by at most lr = 1.5e-4, and
where a grad is near 0 Adam's g / (|g| + eps) amplifies its rounding).
"""
import os
import signal
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.distributed import compression as jcompression  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.training import loop as jtl  # noqa: E402
from repro_torch import bridge, faults, obs  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import (ShapeConfig, TrainConfig,  # noqa: E402
                                 reduced_config)
from repro_torch.data.pipeline import Loader, SyntheticLM  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_bwd_ref, flash_fwd_ref)
from repro_torch.kernels.moe_dispatch import ops as dispatch_ops  # noqa: E402
from repro_torch.kernels.moe_dispatch.ref import (  # noqa: E402
    moe_dispatch_bwd_ref)
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import (  # noqa: E402
    add_rmsnorm_bwd_ref, rmsnorm_bwd_ref)
from repro_torch.kernels.ssm_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssd_intra_bwd_ref  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.training import loop as tl  # noqa: E402
from repro_torch.training.resilient import train_with_recovery  # noqa: E402

ARCH = "h2o-danube-1.8b"
JCFG = jax_reduced_config(ARCH).replace(num_layers=2, dtype="float32")
CFG = reduced_config(ARCH).replace(num_layers=2, dtype="float32")
SEQ, BATCH = 32, 4           # S 32 > window 16: the window binds


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# plain backward versions against jax.vjp
# ---------------------------------------------------------------------------

FLASH_BWD_CASES = [  # (B, S, H, KV, D, window)
    (2, 32, 4, 2, 16, None), (1, 40, 4, 1, 32, 7), (2, 24, 8, 2, 16, 24),
    (1, 48, 2, 2, 16, 5),
    (1, 13, 8, 1, 16, None),   # S below one chunk, KV 1
    (1, 40, 4, 2, 16, 16)]     # a window of exactly one chunk


@pytest.mark.parametrize("B,S,H,KV,D,window", FLASH_BWD_CASES)
def test_flash_plain_bwd_matches_jax_vjp(B, S, H, KV, D, window):
    """flash_fwd_ref / flash_bwd_ref (ragged chunks of 16) against the
    JAX package's custom-VJP flash (chunks of 8): causal, windowed,
    GQA; fp32 at 1e-5."""
    rng = np.random.default_rng(S + D)
    q, k, v = (rng.standard_normal(s, np.float32)
               for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    do = rng.standard_normal((B, S, H, D), np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention_jnp(
        a, b, c, causal=True, window=window, q_chunk=8, k_chunk=8),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got_out, lse = flash_fwd_ref(_t(q), _t(k), _t(v), window=window,
                                 chunk=16)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out),
                               atol=1e-5, rtol=1e-5)
    got = flash_bwd_ref(_t(q), _t(k), _t(v), got_out, lse, _t(do),
                        window=window, chunk=16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("R,d", [(6, 128), (33, 256)])
def test_rmsnorm_plain_bwd_matches_jax_vjp(R, d):
    """Both forms against jax.vjp of ``common.rmsnorm`` and of the add
    before it, fp32 at 1e-5; the fused form also with no gradient on
    its sum (ds None) and none on its norm (dy None)."""
    rng = np.random.default_rng(d)
    x, h, dy, ds = (rng.standard_normal((R, d), np.float32)
                    for _ in range(4))
    sc = rng.standard_normal(d, np.float32)
    _, vjp = jax.vjp(jcommon.rmsnorm, jnp.asarray(x), jnp.asarray(sc))
    want = vjp(jnp.asarray(dy))
    got = rmsnorm_bwd_ref(_t(x), _t(sc), _t(dy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)

    def add_norm(a, b, s):
        t = a + b
        return t, jcommon.rmsnorm(t, s)

    _, vjp = jax.vjp(add_norm, jnp.asarray(x), jnp.asarray(h),
                     jnp.asarray(sc))
    s = _t(x) + _t(h)
    zeros = np.zeros_like(x)
    for d_s, d_y in ((ds, dy), (None, dy), (ds, None)):
        wx, wh, wsc = vjp((jnp.asarray(zeros if d_s is None else d_s),
                           jnp.asarray(zeros if d_y is None else d_y)))
        dh, dsc = add_rmsnorm_bwd_ref(s, None if d_s is None else _t(d_s),
                                      None if d_y is None else _t(d_y),
                                      _t(sc))
        for w in (wx, wh):
            np.testing.assert_allclose(dh.numpy(), np.asarray(w),
                                       atol=1e-5, rtol=1e-5)
        if d_y is None:
            assert dsc is None and not np.asarray(wsc).any()
        else:
            np.testing.assert_allclose(dsc.numpy(), np.asarray(wsc),
                                       atol=1e-5, rtol=1e-5)


def test_kernel_wrappers_carry_grad_fn_and_match_plain_backwards():
    """Under grad every wrapper returns outputs that carry a grad_fn (on
    the CPU plain autograd through the plain forwards, whose gradients
    equal the backward kernels' plain versions: flash, RMSNorm, the MoE
    dispatch bit for bit, SSD); without grad they return plain
    tensors."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 20, 4, 16, generator=g, requires_grad=True)
    k = torch.randn(1, 20, 2, 16, generator=g, requires_grad=True)
    v = torch.randn(1, 20, 2, 16, generator=g, requires_grad=True)
    out = fa_ops.flash_attention(q, k, v, causal=True, window=6)
    x = torch.randn(3, 64, generator=g, requires_grad=True)
    h = torch.randn(3, 64, generator=g)
    w = torch.randn(64, generator=g, requires_grad=True)
    y = rms_ops.rmsnorm(x, w)
    s2, y2 = rms_ops.add_rmsnorm(x, h, w)
    assert all(t.grad_fn is not None for t in (out, y, s2, y2))
    do = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, (q, k, v), do)
    o, lse = flash_fwd_ref(q, k, v, causal=True, window=6)
    want = flash_bwd_ref(q, k, v, o, lse, do, causal=True, window=6)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    dy = torch.randn(y.shape, generator=g)
    got = torch.autograd.grad(y, (x, w), dy)
    for a, b in zip(got, rmsnorm_bwd_ref(x, w, dy)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        assert fa_ops.flash_attention(q, k, v).grad_fn is None
        assert rms_ops.rmsnorm(x, w).grad_fn is None
    xt = torch.randn(6, 16, generator=g, requires_grad=True)
    eidx = torch.stack([torch.randperm(8, generator=g)[:3]
                        for _ in range(6)])
    buf, dest_tk, counts = dispatch_ops.moe_dispatch(eidx, xt, 8, 2)
    assert buf.grad_fn is not None and not dest_tk.requires_grad \
        and not counts.requires_grad and bool((dest_tk == 16).any())
    dbuf = torch.randn(buf.shape, generator=g)
    got, = torch.autograd.grad(buf, xt, dbuf)
    assert torch.equal(got, moe_dispatch_bwd_ref(dbuf, dest_tk, 6, 3))
    cum = torch.cumsum(-torch.rand(1, 2, 9, 3, generator=g), 2)
    ins = [cum, torch.randn(1, 2, 9, 3, 8, generator=g),
           torch.randn(1, 2, 9, 4, generator=g),
           torch.randn(1, 2, 9, 4, generator=g)]
    ins = [t.requires_grad_() for t in ins]
    y_s = ssd_ops.ssd_intra(*ins)
    assert all(t.grad_fn is not None for t in y_s)
    dy_ds = [torch.randn(t.shape, generator=g) for t in y_s]
    got = torch.autograd.grad(y_s, ins, dy_ds)
    for a, b in zip(got, ssd_intra_bwd_ref(*ins, *dy_ds)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        assert dispatch_ops.moe_dispatch(eidx, xt, 8, 2)[0].grad_fn is None
        assert ssd_ops.ssd_intra(*ins)[0].grad_fn is None


# ---------------------------------------------------------------------------
# the train step against the JAX trainer
# ---------------------------------------------------------------------------

def _batch_np(cfg, step=0, seq=SEQ, batch=BATCH, seed=0):
    return JSyntheticLM(cfg, JShapeConfig("t", seq, batch, "train"),
                        seed=seed).batch(step)


def _pair_states(jtc, tc, jcfg=JCFG, cfg=CFG):
    """The JAX train state and the port's, holding the same weights."""
    js = jtl.init_train_state(jax.random.PRNGKey(0), jcfg, jtc)
    model = bridge.from_numpy(jax.tree.map(np.asarray, js.params), cfg,
                              device="cpu")
    return js, tl.init_train_state(cfg, tc, params=model)


def _assert_params_close(jparams, model, atol):
    for name, a in bridge._leaves(jax.tree.map(np.asarray, jparams)):
        np.testing.assert_allclose(_np(model.get_parameter(name)),
                                   np.asarray(a, np.float32), atol=atol,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("remat,microbatch", [
    ("none", None), ("full", None), ("full", 2), ("dots", None)])
def test_train_step_matches_jax(remat, microbatch):
    kw = dict(remat=remat, microbatch=microbatch, warmup_steps=2,
              total_steps=10)
    js, st = _pair_states(JTrainConfig(**kw), TrainConfig(**kw))
    b = _batch_np(JCFG)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(v) for k, v in b.items()}
    jgrads, jm = jtl._make_accumulate(JCFG, JTrainConfig(**kw), 1)(
        js.params, jb)
    grads, m = tl._make_accumulate(CFG, TrainConfig(**kw))(st.params, tb)
    for key in ("loss", "ce"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
    for name, a in bridge._leaves(jax.tree.map(np.asarray, jgrads)):
        scale = float(np.abs(a).max())
        assert np.abs(grads[name].numpy() - a).max() <= 1e-5 * scale, name
    js2, jm2 = jax.jit(jtl.make_train_step(JCFG, JTrainConfig(**kw)))(js, jb)
    st2, m2 = tl.make_train_step(CFG, TrainConfig(**kw))(st, tb)
    for key in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m2[key]), float(jm2[key]),
                                   rtol=1e-5, err_msg=key)
    assert int(st2.opt.step) == int(js2.opt.step) == 1
    _assert_params_close(js2.params, st2.params, atol=2e-5)


def test_grad_skip_keeps_state_bit_identical():
    """Every step is a spike: the port's state stays bit for bit, as the
    JAX trainer's does, and both report the skip."""
    kw = dict(total_steps=4, warmup_steps=1, grad_clip=0.0,
              grad_skip_threshold=1e-6)
    js, st = _pair_states(JTrainConfig(**kw), TrainConfig(**kw))
    before = {n: p.detach().clone() for n, p in
              st.params.named_parameters()}
    master = {n: t.clone() for n, t in st.opt.master.items()}
    b = _batch_np(JCFG)
    _, jm = jax.jit(jtl.make_train_step(JCFG, JTrainConfig(**kw)))(
        js, {k: jnp.asarray(v) for k, v in b.items()})
    st2, m = tl.make_train_step(CFG, TrainConfig(**kw))(
        st, {k: _t(v) for k, v in b.items()})
    assert int(m["grad_skipped"]) == int(jm["grad_skipped"]) == 1
    assert int(st2.opt.step) == 0
    for n, p in st2.params.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
        assert torch.equal(st2.opt.master[n], master[n])
        assert not st2.opt.m[n].any() and not st2.opt.v[n].any()


def test_int8_compression_matches_jax():
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((8, 16), np.float32) * 3,
         "b": rng.standard_normal(5, np.float32) * 1e-3}
    e = {k: rng.standard_normal(v.shape, np.float32) * 1e-2
         for k, v in g.items()}
    jg, je = jcompression.int8_compress_decompress(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in e.items()})
    tg, te = compression.int8_compress_decompress(
        {k: _t(v) for k, v in g.items()}, {k: _t(v) for k, v in e.items()})
    for k in g:
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))
    # one compressed train step: the error-feedback tree and the params
    kw = dict(grad_compression="int8", warmup_steps=2, total_steps=10,
              remat="none")
    js, st = _pair_states(JTrainConfig(**kw), TrainConfig(**kw))
    b = _batch_np(JCFG)
    js2, _ = jax.jit(jtl.make_train_step(JCFG, JTrainConfig(**kw)))(
        js, {k: jnp.asarray(v) for k, v in b.items()})
    st2, _ = tl.make_train_step(CFG, TrainConfig(**kw))(
        st, {k: _t(v) for k, v in b.items()})
    _assert_params_close(js2.params, st2.params, atol=2e-5)
    # the residual g - deq(quant(g)) carries the grads' own rounding
    # differences at full size, and where those move g / scale across a
    # rounding boundary it differs by one quantum (2 max |err|): allow
    # that in under 1% of the entries, 1e-3 of max |err| elsewhere
    for name, a in bridge._leaves(jax.tree.map(np.asarray, js2.err)):
        half = float(np.abs(a).max()) + 1e-30
        diff = np.abs(st2.err[name].numpy() - a)
        assert diff.max() <= 2.01 * half, name
        assert np.mean(diff > 1e-3 * half) < 0.01, name


def test_fleet_step_masks_a_pod_like_jax():
    """Pod 1 feeds garbage and is masked out: the port's update equals
    its own clean-batch update bit for bit and the JAX fleet step's."""
    kw = dict(total_steps=4, warmup_steps=1, remat="none")
    b = _batch_np(JCFG)
    pod = {k: v.reshape((2, BATCH // 2) + v.shape[1:]) for k, v in b.items()}
    garbage = {"tokens": pod["tokens"].copy(), "labels": pod["labels"].copy()}
    garbage["tokens"][1] = 0
    garbage["labels"][1] = 1
    mask = np.asarray([1.0, 0.0], np.float32)
    js, _ = _pair_states(JTrainConfig(**kw), TrainConfig(**kw))
    js2, jm = jax.jit(jtl.make_fleet_train_step(JCFG, JTrainConfig(**kw),
                                                n_pods=2))(
        js, {k: jnp.asarray(v) for k, v in pod.items()}, jnp.asarray(mask))
    outs = []
    for data in (pod, garbage):
        _, st = _pair_states(JTrainConfig(**kw), TrainConfig(**kw))
        step = tl.make_fleet_train_step(CFG, TrainConfig(**kw), n_pods=2)
        st2, m = step(st, {k: _t(v) for k, v in data.items()}, mask)
        assert int(m["pods_healthy"]) == int(jm["pods_healthy"]) == 1
        outs.append(st2.params)
    for (n, a), (_, b2) in zip(outs[0].named_parameters(),
                               outs[1].named_parameters()):
        assert torch.equal(a, b2), n
    _assert_params_close(js2.params, outs[0], atol=2e-5)


def test_synthetic_batches_equal_jax_and_loader_places_them():
    shape, jshape = (ShapeConfig("t", 24, 3, "train"),
                     JShapeConfig("t", 24, 3, "train"))
    src = SyntheticLM(CFG, shape, seed=5)
    jsrc = JSyntheticLM(JCFG, jshape, seed=5)
    loader = Loader(src, device="cpu", start_step=2)
    for t in (2, 3, 7):
        want = jsrc.batch(t)
        got = src.batch(t)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    for t in (2, 3):
        got = next(loader)
        for k, v in jsrc.batch(t).items():
            assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), v)
    assert loader.state_dict() == {"step": 4, "seed": 5}


def test_loss_decreases_tiny_model():
    """As tests/test_system.py asks of the JAX trainer: 30 steps on one
    fixed batch bring the loss below 0.7x its first value."""
    cfg = reduced_config(ARCH).replace(num_layers=2)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=30,
                     remat="none")
    st = tl.init_train_state(cfg, tc, device="cpu")
    step = tl.make_train_step(cfg, tc)
    batch = {k: _t(v) for k, v in _batch_np(cfg, seq=32, batch=2).items()}
    first = None
    for _ in range(30):
        st, m = step(st, batch)
        first = float(m["loss"]) if first is None else first
    assert float(m["loss"]) < first * 0.7


# ---------------------------------------------------------------------------
# crash and resume, checkpoints across packages, the CLI
# ---------------------------------------------------------------------------

RCFG = reduced_config(ARCH).replace(num_layers=1)
RSHAPE = ShapeConfig("chaos", seq_len=16, global_batch=4, kind="train")


def _train_setup(tc):
    state = tl.init_train_state(RCFG, tc, device="cpu")
    loader = Loader(SyntheticLM(RCFG, RSHAPE, seed=tc.seed), device="cpu")
    return state, tl.make_train_step(RCFG, tc), loader


def test_train_auto_resume_matches_fault_free(tmp_path):
    """Crashes at step polls 2 and 5 (the second after a checkpoint was
    corrupted on disk) recover from verified checkpoints; the final
    params equal the fault-free run's bit for bit, as
    tests/test_faults.py asks of the JAX trainer."""
    tc = TrainConfig(total_steps=8, warmup_steps=1, learning_rate=1e-3)
    state, step_fn, loader = _train_setup(tc)
    ref, _ = train_with_recovery(state, step_fn, loader, total_steps=8)

    state, step_fn, loader = _train_setup(tc)
    inj = faults.FaultInjector(faults.FaultPlan([
        faults.Fault("train.step", 2, "exception"),
        faults.Fault("ckpt.save", 1, "corrupt", 3.0),
        faults.Fault("train.step", 5, "exception")]))
    mgr = CheckpointManager(str(tmp_path), keep=3, injector=inj)
    got, restarts = train_with_recovery(
        state, step_fn, loader, total_steps=8, manager=mgr,
        checkpoint_every=2, injector=inj, max_restarts=4,
        backoff_base_s=0.0, registry=obs.Registry())
    assert restarts == 2 and inj.remaining() == 0
    assert int(got.opt.step) == int(ref.opt.step) == 8
    for (n, a), (_, b) in zip(ref.params.named_parameters(),
                              got.params.named_parameters()):
        assert torch.equal(a, b), n
    for tree in ("master", "m", "v"):
        for n, a in getattr(ref.opt, tree).items():
            assert torch.equal(a, getattr(got.opt, tree)[n]), (tree, n)


def test_train_resume_under_seeded_plan_matches_fault_free(tmp_path):
    """``faults.training_plan(2)``: step crashes at polls 4, 6 and 9 and
    corrupt checkpoints at saves 3 and 7, every step checkpointed; the
    params and the optimizer state equal the fault-free run's bit for
    bit (chip_smoke.py runs the same on the card)."""
    tc = TrainConfig(total_steps=10, warmup_steps=1, learning_rate=1e-3)
    state, step_fn, loader = _train_setup(tc)
    ref, _ = train_with_recovery(state, step_fn, loader, total_steps=10)
    state, step_fn, loader = _train_setup(tc)
    inj = faults.FaultInjector(faults.training_plan(2, horizon=10))
    mgr = CheckpointManager(str(tmp_path), keep=3, injector=inj)
    got, restarts = train_with_recovery(
        state, step_fn, loader, total_steps=10, manager=mgr,
        checkpoint_every=1, injector=inj, max_restarts=4,
        backoff_base_s=0.0)
    assert restarts == 3 and inj.remaining() == 0
    for (n, a), (_, b) in zip(ref.params.named_parameters(),
                              got.params.named_parameters()):
        assert torch.equal(a, b), n
    for n, a in ref.opt.v.items():
        assert torch.equal(a, got.opt.v[n]), n


def _jax_state_after_one_step():
    """A bf16 JAX train state of reduced danube after one step (non-zero
    moments, step 1)."""
    jcfg = jax_reduced_config(ARCH).replace(num_layers=1)
    jtc = JTrainConfig(warmup_steps=1, total_steps=4, remat="none")
    js = jtl.init_train_state(jax.random.PRNGKey(1), jcfg, jtc)
    b = _batch_np(jcfg, seq=16, batch=2)
    js, _ = jax.jit(jtl.make_train_step(jcfg, jtc))(
        js, {k: jnp.asarray(v) for k, v in b.items()})
    return js


def _assert_state_equal(js, st):
    assert int(js.opt.step) == int(st.opt.step)
    pairs = [(js.params, {n: p for n, p in st.params.named_parameters()})]
    pairs += [(getattr(js.opt, t), getattr(st.opt, t))
              for t in ("master", "m", "v")]
    for jtree, ttree in pairs:
        leaves = dict(bridge._leaves(jax.tree.map(np.asarray, jtree)))
        assert set(leaves) == set(ttree)
        for name, a in leaves.items():
            t = ttree[name].detach()
            assert str(a.dtype) == str(t.dtype).replace("torch.", ""), name
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(a, np.float32),
                                          err_msg=name)


def test_checkpoints_restore_across_packages(tmp_path):
    """A JAX TrainState saved by ``repro.checkpoint.store`` restores into
    the port's TrainState leaf for leaf (bf16 params bit-exact), and the
    port's save restores into the JAX state."""
    js = _jax_state_after_one_step()
    jstore.save(str(tmp_path / "jax"), 1, js, {"data_step": 1})
    cfg = RCFG
    st = tl.init_train_state(cfg, TrainConfig(), device="cpu")
    got, meta = store.restore(str(tmp_path / "jax"), 1, st)
    assert meta == {"data_step": 1}
    _assert_state_equal(js, got)
    assert got.params is st.params            # written in place

    store.save(str(tmp_path / "torch"), 1, got, {"data_step": 1})
    assert store.verify(str(tmp_path / "torch" / "step_00000001"))
    blank = jtl.init_train_state(
        jax.random.PRNGKey(7), jax_reduced_config(ARCH).replace(
            num_layers=1), JTrainConfig())
    back, meta = jstore.restore(str(tmp_path / "torch"), 1, blank)
    assert meta == {"data_step": 1}
    _assert_state_equal(back, got)


def test_checkpoint_restore_checks_before_writing(tmp_path):
    """A corrupt newest checkpoint is skipped and leaves the state
    untouched until a verified one restores."""
    st = tl.init_train_state(RCFG, TrainConfig(), device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, st)
    with torch.no_grad():
        st.params.embed.add_(1.0)
    mgr.async_save(2, st)
    mgr.wait()
    path = os.path.join(str(tmp_path), "step_00000002", "arrays.npz")
    faults.corrupt_checkpoint(os.path.dirname(path), seed=0)
    assert mgr.latest_valid_step() == 1
    with pytest.raises((store.CheckpointCorrupt, zipfile.BadZipFile)):
        store.restore(str(tmp_path), 2, st)
    embed = st.params.embed.detach().clone()
    with torch.no_grad():
        st.params.embed.sub_(1.0)
    assert not torch.equal(st.params.embed, embed)
    step, got, _ = mgr.restore_latest(st)
    assert step == 1 and torch.equal(got.params.embed + 1.0, embed)


def test_train_cli_on_cpu(capsys, tmp_path):
    history = []
    assert train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "3", "--seq", "32", "--batch", "4",
                           "--microbatch", "2", "--log-every", "1",
                           "--ckpt", str(tmp_path)], history=history) == 0
    out = capsys.readouterr().out
    assert "[done]" in out and out.count("loss ") == 3
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in history)
    assert store.list_steps(str(tmp_path)) == [3]
    # --mesh in one process: a world of one gloo rank, the same bits
    meshed = []
    assert train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "3", "--seq", "32", "--batch", "4",
                           "--microbatch", "2", "--log-every", "1",
                           "--mesh"], history=meshed) == 0
    out = capsys.readouterr().out
    assert "mesh {'data': 1, 'model': 1} (gloo) rank 0" in out
    assert [(h["loss"], h["ce"], h["grad_norm"]) for h in meshed] == \
        [(h["loss"], h["ce"], h["grad_norm"]) for h in history]
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-tiny"])
def test_train_cli_families_on_cpu(capsys, arch):
    """The train CLI on the xlstm family and the audio family (whose
    batches carry the loader's stub frames): finite losses and grad
    norms, one history record a step.  Their parity with the JAX
    trainer is ``test_torch_train_families``."""
    history = []
    assert train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--steps", "2", "--seq", "16", "--batch", "2",
                           "--log-every", "1"], history=history) == 0
    out = capsys.readouterr().out
    assert f"[train] {arch} (reduced)" in out and "[done]" in out
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               and h["grad_norm"] > 0 for h in history)


def test_train_cli_chaos_on_cpu(capsys, tmp_path):
    assert train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "10", "--seq", "16", "--batch", "2",
                           "--ckpt", str(tmp_path), "--ckpt-every", "1",
                           "--chaos-seed", "2", "--log-every", "5",
                           "--max-restarts", "4"]) == 0
    out = capsys.readouterr().out
    assert "[chaos] restarts=3 faults_remaining=0" in out


class _SigtermAt(list):
    """A history list that sends this process SIGTERM once the record of
    step `at` is appended."""

    def __init__(self, at: int):
        super().__init__()
        self.at = at

    def append(self, rec):
        super().append(rec)
        if rec["step"] == self.at:
            os.kill(os.getpid(), signal.SIGTERM)


def _arrays(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def test_train_cli_preemption_flush_resumes_exactly(tmp_path):
    """SIGTERM after step 2 of 4 flushes the whole state as of step 2
    (opt.step included) and exits 143; resuming from that checkpoint
    ends on the same step-4 checkpoint, bit for bit, as a run that was
    never stopped.  A SIGTERM inside ``held()`` (a step) is flushed
    when the block ends, not in the middle."""
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
            "4", "--seq", "32", "--batch", "4", "--log-every", "1",
            "--ckpt-every", "100"]
    stopped, whole = str(tmp_path / "stopped"), str(tmp_path / "whole")
    old = signal.getsignal(signal.SIGTERM)
    try:
        with pytest.raises(SystemExit) as e:
            train_cli.main(argv + ["--ckpt", stopped],
                           history=_SigtermAt(2))
        assert e.value.code == 143
        assert store.list_steps(stopped) == [2]
        cfg = reduced_config(ARCH)
        like = tl.init_train_state(cfg, TrainConfig(), device="cpu")
        _, meta = store.restore(stopped, 2, like)
        assert meta == {"preempted": True} and int(like.opt.step) == 2
        assert train_cli.main(argv + ["--ckpt", stopped]) == 0
        assert train_cli.main(argv + ["--ckpt", whole]) == 0
        got = _arrays(os.path.join(stopped, "step_00000004"))
        want = _arrays(os.path.join(whole, "step_00000004"))
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k], want[k]), k

        mgr = CheckpointManager(str(tmp_path / "held"))
        mgr.install_preemption_flush(lambda: (7, {"x": torch.ones(2)}))
        with pytest.raises(SystemExit):
            with mgr.held():
                os.kill(os.getpid(), signal.SIGTERM)
                flushed_inside = store.list_steps(mgr.dir)
        assert flushed_inside == [] and store.list_steps(mgr.dir) == [7]
    finally:
        signal.signal(signal.SIGTERM, old)
