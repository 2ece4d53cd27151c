"""The port's roofline layer (``repro_torch.roofline``) against
hand-counted programs and the JAX package's ``repro.roofline``.

``op_cost`` walks eager code: a loop of products counts each trip, a
sampled loop (``op_cost.repeats``) counts one trip scaled and equals the
unrolled loop, a c10d all-reduce costs the ring model over its group, a
chain of fp32 products counts the FLOPs JAX's ``hlo_cost`` reads off
the compiled HLO (within 1%), and ``analysis.analyze`` on ``V5E`` gives
JAX's terms.  Each kernel wrapper declares its cost (PERF.md's bound
formulas), and the plain version run inside the declared region adds
nothing.  The meta branches of the kernel wrappers and of
``bridge.init_params`` give the CPU call's output shapes and dtypes.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")

from repro_torch.roofline import analysis, op_cost  # noqa: E402
from repro_torch.roofline.hw import H100, V5E  # noqa: E402


def _walk(fn, *args, **kw):
    return op_cost.walk(fn, *args, **kw)[0]


def _randn(*shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(dtype))


# ---------------------------------------------------------------------------
# hand-counted programs (the mirror of tests/test_roofline.py)
# ---------------------------------------------------------------------------

def test_loop_matmul_flops_exact():
    x, w = _randn(256, 512), _randn(512, 512, seed=1)

    def f(x, w):
        for _ in range(8):
            x = x @ w
        return x
    c = _walk(f, x, w)
    assert c.flops == 2 * 256 * 512 * 512 * 8
    assert c.product_flops == c.flops
    assert c.op_counts == {"mm": 8}


def test_nested_loop_multiplier():
    x, w = _randn(64, 128), _randn(128, 128, seed=1)

    def g(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x
    assert _walk(g, x, w).flops == 2 * 64 * 128 * 128 * 12


@pytest.mark.parametrize("n", [6, 1])
def test_unrolled_equals_sampled_loop(n):
    """A loop run through ``repeats`` under ``sample_loops`` runs once,
    its counts scaled by its length: equal to the whole loop."""
    x, w = _randn(128, 256), _randn(256, 256, seed=1)
    runs = []

    def f(x, w):
        for _ in op_cost.repeats(n):
            runs.append(1)
            y = torch.tanh(x @ w)
        return y
    a = _walk(f, x, w, sample_loops=True)
    assert len(runs) == 1
    b = _walk(f, x, w)
    assert len(runs) == 1 + n
    assert (a.flops, a.bytes, a.op_counts) == (b.flops, b.bytes,
                                                b.op_counts)
    assert a.flops == n * (2 * 128 * 256 * 256 + 128 * 256)


def test_loop_weight_bytes_scale_with_trips():
    """The weight re-read inside the loop is charged per iteration."""
    x, w = _randn(8, 4096), _randn(4096, 4096, seed=1)

    def f(x, w):
        for _ in range(8):
            x = x @ w
        return x
    c = _walk(f, x, w)
    w_bytes = 4096 * 4096 * 4
    assert c.bytes == 8 * (w_bytes + 2 * 8 * 4096 * 4)
    assert c.bytes > 8 * w_bytes


def test_views_are_free_and_broadcasts_count_once():
    x, b = _randn(64, 32), _randn(32, seed=1)
    c = _walk(lambda x, b: (x.t().reshape(32, 64).t() + b), x, b)
    assert c.op_counts == {"add": 1}
    assert c.flops == 64 * 32
    assert c.bytes == 4 * (64 * 32 + 32 + 64 * 32)


def test_gather_and_scatter_charge_what_they_touch():
    table = _randn(1000, 64)
    idx = torch.arange(16)
    c = _walk(lambda t, i: t[i], table, idx)
    assert c.bytes == 2 * 16 * 64 * 4 + 16 * 8 and c.flops == 0
    upd = _randn(16, 64, seed=1)
    c = _walk(lambda t, i, u: t.index_put_((i,), u), table.clone(), idx, upd)
    assert c.bytes == 2 * 16 * 64 * 4 + 16 * 8


def test_collective_ring_model_matches_jax_parser():
    """f32[16,128] all-reduce over groups of 16: 2*s*15/16 on the wire,
    as JAX's ``parse_collectives`` and ``analyze_hlo`` read it off the
    HLO line of tests/test_roofline.py."""
    pytest.importorskip("jax")
    from repro.roofline import hlo_cost
    from repro.roofline.analysis import parse_collectives
    hlo = """
ENTRY %main (p: f32[16,128]) -> f32[16,128] {
  %p = f32[16,128]{1,0} parameter(0)
  ROOT %ar = f32[16,128]{1,0} all-reduce(%p), """ \
        """replica_groups=[16,16]<=[256], to_apply=%add
}
"""
    s = 16 * 128 * 4
    expect = 2 * s * 15 / 16
    assert analysis.ring_wire_bytes("all-reduce", s, s, 16) == expect
    c = op_cost.StepCost()
    c.add_collective("all-reduce", s, s, 16)
    assert c.wire_bytes == expect
    assert c.coll_op_counts == {"all-reduce": 1.0}
    assert abs(parse_collectives(hlo, 256).wire_bytes - expect) < 1.0
    assert abs(hlo_cost.analyze_hlo(hlo, 256).wire_bytes - expect) < 1.0


@pytest.mark.parametrize("kind,n,want", [
    ("all-gather", 4, 3 / 4 * 400), ("reduce-scatter", 4, 3 / 4 * 100),
    ("all-to-all", 8, 7 / 8 * 100), ("collective-permute", 2, 100),
    ("all-reduce", 1, 0.0)])
def test_ring_models(kind, n, want):
    assert analysis.ring_wire_bytes(kind, 100, 400, n) == want


def test_fp32_matmul_chain_matches_hlo_cost():
    """The same chain of fp32 products counts the same FLOPs (1%) in
    the eager walk and in JAX's HLO walk of the compiled program."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.roofline import hlo_cost
    shapes = [(128, 256), (256, 512), (512, 64), (64, 384)]
    arrs = [np.random.default_rng(i).standard_normal(s).astype(np.float32)
            for i, s in enumerate(shapes)]

    def chain(x, *ws):
        for w in ws:
            x = x @ w
        return x
    compiled = jax.jit(chain).lower(*[jnp.asarray(a) for a in arrs]) \
        .compile()
    want = hlo_cost.analyze_hlo(compiled.as_text(), 1).flops
    got = _walk(chain, *[torch.from_numpy(a) for a in arrs]).flops
    assert abs(got - want) / want < 0.01


def test_analyze_matches_jax_on_v5e():
    """Terms, dominant, useful fraction and MFU bound equal JAX's
    ``analyze(..., trip_aware=False)`` for the same per-device FLOPs,
    bytes and collective (the port's cost is the whole step: the
    per-device figures times the chips)."""
    pytest.importorskip("jax")
    from repro.roofline import analysis as jax_analysis
    from repro.roofline.hw import V5E as JAX_V5E
    hlo = ("  ROOT %ar = f32[16,128]{1,0} all-reduce(%p), "
           "replica_groups=[16,16]<=[256], to_apply=%add\n")
    n = 256
    for flops, nbytes, mf in ((3.1e14, 2.2e11, 4.0e16),
                              (1.0e12, 9.0e12, 2.0e14),
                              (1.0e6, 1.0e3, 1.0e8)):
        j = jax_analysis.analyze({"flops": flops, "bytes accessed": nbytes},
                                 hlo, n_chips=n, model_flops=mf,
                                 chip=JAX_V5E, trip_aware=False)
        cost = op_cost.StepCost(flops=flops * n, bytes=nbytes * n)
        s = 16 * 128 * 4
        cost.add_collective("all-reduce", s, 0.0, 16)
        t = analysis.analyze(cost, n_chips=n, model_flops=mf, chip=V5E)
        for k in ("compute_s", "memory_s", "collective_s", "dominant",
                  "useful_fraction", "mfu_bound", "wire_bytes",
                  "hlo_flops_global", "flops_per_device",
                  "bytes_per_device", "total_s"):
            assert getattr(t, k) == pytest.approx(getattr(j, k),
                                                  rel=1e-12), k
        assert t.op_counts == j.op_counts


def test_h100_constants_and_link_rate():
    assert (H100.peak_bf16_flops, H100.hbm_bw, H100.hbm_bytes) == (
        989e12, 3.35e12, 80e9)
    assert H100.link_bw(8) == 450e9 and H100.link_bw(9) == 50e9
    assert V5E.link_bw(512) == V5E.ici_link_bw


# ---------------------------------------------------------------------------
# the collectives of a real train step (2 ranks over gloo)
# ---------------------------------------------------------------------------

RANK_SCRIPT = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, {src!r})
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import TrainConfig, reduced_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import api
    from repro_torch.roofline import op_cost
    from repro_torch.training import loop
    mesh_mod.init_world("cpu")
    mesh = mesh_mod.make_test_mesh(2, 1)
    cfg = reduced_config("phi3-mini-3.8b").replace(num_layers=1,
                                                   dtype="float32")
    tc = TrainConfig(microbatch=None, remat="none")
    state = loop.init_train_state(cfg, tc, device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {{k: torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                               dtype=torch.int32)
              for k in ("tokens", "labels")}}
    step = loop.make_train_step(cfg, tc)
    with shd.axis_rules(mesh, shd.train_rules(mesh)):
        cost, _ = op_cost.walk(step, state, batch)
    sizes = [p.numel() * 4 for p in state.params.parameters()]
    if torch.distributed.get_rank() == 0:
        print(json.dumps({{"counts": cost.coll_op_counts,
                           "wire": cost.wire_bytes, "sizes": sizes,
                           "grad_all_reduces": loop.grad_all_reduces}}))
    torch.distributed.destroy_process_group()
""")


def test_train_step_all_reduces_each_grad_leaf_over_gloo():
    """A data-parallel step on 2 ranks: op_cost sees one c10d all-reduce
    a gradient leaf and one of the loss metrics, each 2*s*(n-1)/n on
    the wire with s the leaf's fp32 bytes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = RANK_SCRIPT.format(src=SRC)
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        env.pop("PYTHONPATH", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    n_leaves = len(res["sizes"])
    assert res["counts"] == {"all-reduce": n_leaves + 1}
    assert res["grad_all_reduces"] == n_leaves + 1
    want = sum(2 * s * 1 / 2 for s in res["sizes"] + [12])
    assert res["wire"] == pytest.approx(want, rel=1e-12)


# ---------------------------------------------------------------------------
# the kernels' declared costs and their meta branches
# ---------------------------------------------------------------------------

def _kernel_calls():
    """{name: factory(device) -> (call, inputs, (flops, bytes))}: the
    entry on its inputs and its declared cost at that shape."""
    from repro_torch.kernels.decode_q8.ops import decode_attention_q8
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.moe_dispatch.ops import moe_dispatch
    from repro_torch.kernels.rmsnorm.ops import add_rmsnorm, rmsnorm
    from repro_torch.kernels.ssm_scan.ops import ssd_intra

    def rms(dev):
        ins = [_randn(6, 64).to(dev), _randn(64, seed=1).to(dev)]
        return rmsnorm, ins, (4 * 6 * 64, 4 * (2 * 6 * 64 + 64))

    def add_rms(dev):
        ins = [_randn(6, 64).to(dev), _randn(6, 64, seed=2).to(dev),
               _randn(64, seed=1).to(dev)]
        return add_rmsnorm, ins, (5 * 6 * 64, 4 * (4 * 6 * 64 + 64))

    def flash(dev):
        B, S, H, KV, D = 1, 10, 4, 2, 16
        ins = [_randn(B, S, H, D).to(dev), _randn(B, S, KV, D, seed=1)
               .to(dev), _randn(B, S, KV, D, seed=2).to(dev)]
        pairs = sum(min(i + 1, 3) for i in range(S))      # window 3
        return (lambda q, k, v: flash_attention(q, k, v, causal=True,
                                                window=3), ins,
                (4 * D * pairs * H * B,
                 4 * 2 * (B * S * H * D + B * S * KV * D)))

    def dispatch(dev):
        T, k, d, E, C = 12, 2, 16, 4, 8
        eidx = torch.from_numpy(np.random.default_rng(0).integers(
            0, E, (T, k))).to(dev)
        return (lambda x: moe_dispatch(eidx, x, E, C), [_randn(T, d).to(dev)],
                (0.0, 8 * T * k + 4 * T * d + 4 * E * C * d + 4 * T * k
                 + 4 * E))

    def ssd(dev):
        B, nc, Q, H, P, N = 1, 2, 8, 3, 4, 4
        ins = [_randn(B, nc, Q, H, seed=0) * 0.1,
               _randn(B, nc, Q, H, P, seed=1), _randn(B, nc, Q, N, seed=2),
               _randn(B, nc, Q, N, seed=3)]
        pairs = Q * (Q + 1) // 2
        flops = B * nc * (pairs * 2 * N + H * pairs * (2 + 2 * P)
                          + H * Q * (N + 2 * N * P))
        nbytes = 4 * B * nc * (Q * H + 2 * Q * H * P + 2 * Q * N
                               + H * N * P)
        return ssd_intra, [a.to(dev) for a in ins], (flops, nbytes)

    def q8(dev):
        B, S, KV, G, D = 2, 12, 2, 2, 32
        rng = np.random.default_rng(0)
        cache = {n: torch.from_numpy(rng.integers(-127, 128, (B, S, KV, D))
                                     .astype(np.int8)).to(dev)
                 for n in ("k", "v")}
        cache.update({n: torch.from_numpy(
            rng.uniform(1e-3, 1e-2, (B, S, KV)).astype(np.float16)).to(dev)
            for n in ("k_scale", "v_scale")})
        return (lambda q: decode_attention_q8(q, cache, 7),
                [_randn(B, 1, KV * G, D).to(dev)],
                (4.0 * D * S * KV * G * B,
                 2 * B * S * KV * D + 2 * 2 * B * S * KV
                 + 2 * 4 * B * KV * G * D))

    return {"rmsnorm": rms, "add_rmsnorm": add_rms, "flash_attention": flash,
            "moe_dispatch": dispatch, "ssd_intra": ssd,
            "decode_attention_q8": q8}


KERNEL_NAMES = ("rmsnorm", "add_rmsnorm", "flash_attention", "moe_dispatch",
                "ssd_intra", "decode_attention_q8")


def _outs(out):
    return [out] if isinstance(out, torch.Tensor) else list(out)


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernel_declares_its_cost(name):
    """The walk adds the kernel's formula once and counts none of the
    plain version's ops run inside its region."""
    call, ins, (flops, nbytes) = _kernel_calls()[name]("cpu")
    c = _walk(call, *ins)
    assert c.declared == {name: {"calls": 1.0, "flops": flops,
                                 "bytes": nbytes}}
    assert (c.flops, c.bytes, c.op_counts) == (flops, nbytes, {})


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernel_meta_branch_gives_cpu_shapes(name):
    call, ins, _ = _kernel_calls()[name]("cpu")
    cpu = _outs(call(*ins))
    call, ins, _ = _kernel_calls()[name]("meta")
    meta = _outs(call(*ins))
    assert len(cpu) == len(meta)
    for a, b in zip(cpu, meta):
        assert b.device.type == "meta"
        assert (tuple(a.shape), a.dtype) == (tuple(b.shape), b.dtype)


@pytest.mark.parametrize("name", ["rmsnorm", "add_rmsnorm", "flash_attention",
                                  "moe_dispatch", "ssd_intra"])
def test_backward_walk_on_meta_matches_cpu(name):
    """Under grad a walk builds the kernel's ``autograd.Function`` on
    every device (the plain versions inside on the CPU, shapes only on
    meta): the CPU and meta walks of a forward and backward count
    alike, each backward declared once."""
    costs = []
    for dev in ("cpu", "meta"):
        call, ins, _ = _kernel_calls()[name](dev)
        for t in ins:
            t.requires_grad_(True)
        with op_cost.OpCost() as oc:
            outs = _outs(call(*ins))       # add_rmsnorm: its norm's output
            out = outs[1] if name == "add_rmsnorm" else outs[0]
            out.float().sum().backward()
        costs.append(oc.cost)
    a, b = costs
    assert (a.flops, a.bytes, a.declared, a.op_counts) == \
        (b.flops, b.bytes, b.declared, b.op_counts)
    assert a.declared[f"{name}_bwd"]["calls"] == 1


def test_flash_backward_declares_its_cost_and_matches_plain_autograd():
    """Under grad a walk runs ``_Flash`` with the plain forward and
    backward on the CPU: the backward declares 10·D a pair and head,
    and the gradients equal plain autograd's (fp32, summed in another
    order: 1e-5)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    B, S, H, KV, D = 1, 12, 4, 2, 16
    q, k, v = (_randn(B, S, h, D, seed=i).requires_grad_(True)
               for i, h in enumerate((H, KV, KV)))

    def f():
        return flash_attention(q, k, v, causal=True).square().sum()
    with op_cost.OpCost() as oc:
        f().backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    f().backward()
    pairs = S * (S + 1) // 2
    d = oc.cost.declared["flash_attention_bwd"]
    assert d["calls"] == 1 and d["flops"] == 10 * D * pairs * H * B
    assert oc.cost.declared["flash_attention"]["bytes"] == \
        4 * 2 * (B * S * H * D + B * S * KV * D) + 4 * B * H * S
    for g, t in zip(grads, (q, k, v)):
        torch.testing.assert_close(g, t.grad, rtol=1e-5, atol=1e-5)


def test_init_params_on_meta_builds_without_a_generator():
    from repro_torch import bridge
    from repro_torch.configs import reduced_config
    from repro_torch.models import api
    cfg = reduced_config("olmoe-1b-7b")
    meta = bridge.init_params(cfg, None, device="meta")
    cpu = api.build_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    a = {n: (tuple(p.shape), p.dtype) for n, p in cpu.named_parameters()}
    b = {n: (tuple(p.shape), p.dtype) for n, p in meta.named_parameters()}
    assert a == b
    assert all(p.device.type == "meta" for p in meta.parameters())
    assert api.build_params(cfg, device="meta").device.type == "meta"
