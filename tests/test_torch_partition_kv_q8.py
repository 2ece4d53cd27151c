"""The partitioned int8 decode (DTensor: int8 caches and their fp16
scales sharded over ``kv_seq``, the int8 kernel's split form exchanging
its row statistics between the ranks) against the JAX package under the
same mesh and rules, on the CPU.

One run of 8 gloo ranks as a (data 2, model 4) mesh, each forked from
one launcher that imported torch once (``OMP_NUM_THREADS=1``), beside
one JAX process with 8 forced host devices on an Auto (data 2, model 4)
mesh.  Every input comes from a numpy seed and reaches each process
through one pickle.  For reduced fp32 phi3-mini-3.8b (dense),
olmoe-1b-7b (MoE) and internvl2-76b (vlm), 2 layers each, the ranks
build the decode cell (``build_decode_cell(..., kv_quant=True)``) on the
mesh, load the JAX package's weights and int8 caches of random payload
and scales with per-slot lengths (4 slots of 40 positions, 10 a model
rank; slot 0's length ends before the second shard's start, so the last
shard of slots 0 to 2 is wholly masked), and run 3 decode steps through
the cell's step; the JAX process runs the same step, jitted with the
cell's shardings, on the same inputs.  The launcher then walks the phi3
cell on ``meta`` under ``fake_world((2, 4))``, recording the shape of
every collective.

Tolerances: the logits within ``LOGIT_TOL`` of max |logit| as
``tests/test_torch_kv_q8.py`` holds the int8 decode to the JAX one (a
quantized value one step apart moves them by ~1e-3), the next tokens
equal, the int8 cache entries at most one step apart and the fp16
scales within an ulp at no more than ``MAX_FLIPS`` entries.  The plain
split form in blocks against the whole plain version: 1e-6 of max
|output| (only the fp32 sum of exponentials is reassociated), pq at
most one step apart.  Placements, bytes and collectives are exact.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
DATA, MODEL = 2, 4
ARCHS = ("phi3-mini-3.8b", "olmoe-1b-7b", "internvl2-76b")
B, SMAX, STEPS = 4, 40, 3
LENS = (3, 14, 27, 36)      # before the first step; slot 0 stays in shard 0
LOGIT_TOL = 5e-3            # tests/test_torch_kv_q8.py
MAX_FLIPS = 4
TIMEOUT = 240


def _cfg(arch):
    from repro_torch.configs import reduced_config
    return reduced_config(arch).replace(num_layers=2, dtype="float32")


def _shape():
    from repro_torch.configs import ShapeConfig
    return ShapeConfig("decode_q8", SMAX, B, "decode")


def _cell(arch, mesh, device):
    from repro_torch.launch import cells
    return cells.build_decode_cell(arch, _shape(), mesh, kv_quant=True,
                                   cfg=_cfg(arch), device=device)


# ---------------------------------------------------------------------------
# the torch ranks (forked from the launcher: ``python -c`` imports this)
# ---------------------------------------------------------------------------

def _specs(placements, mesh):
    """Placements -> {tensor dim: mesh axes}."""
    from torch.distributed.tensor import Shard
    out = {}
    for axis, pl in zip(mesh.mesh_dim_names, placements):
        if isinstance(pl, Shard):
            out.setdefault(pl.dim, []).append(axis)
    return {d: tuple(a) for d, a in out.items()}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _decode(arch, inp, mesh):
    """STEPS decode steps of `arch`'s partitioned int8 cell: each step's
    logits (through a spy on ``api.forward``) and next tokens, the caches
    after them (whole), their placements, the kernel launches."""
    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.decode_q8 import ops as q8_ops
    from repro_torch.models import api
    cfg = _cfg(arch)
    cell = _cell(arch, mesh, "cpu")
    a = inp[arch]
    params = bridge.from_numpy(a["params"], cfg, device="cpu", mesh=mesh,
                               rules=cell.rules)
    plain = {k: {n: torch.from_numpy(t) for n, t in v.items()}
             if isinstance(v, dict) else torch.from_numpy(v)
             for k, v in a["caches"].items()}
    caches = shd.place(plain, api.cache_axes_of(plain), mesh, cell.rules)
    logits, tokens = [], []
    forward = api.forward

    def spy(*args, **kw):
        out = forward(*args, **kw)
        logits.append(out[0].full_tensor().numpy())
        return out
    api.forward = spy
    try:
        with torch.no_grad(), shd.axis_rules(mesh, cell.rules):
            for tok in a["tokens"]:
                nxt, caches = cell.fn(params, caches, torch.from_numpy(tok))
                tokens.append(nxt.full_tensor().numpy())
    finally:
        api.forward = forward
    want = shd.tree_shardings_checked(api.cache_axes_of(caches), caches,
                                      mesh, cell.rules)
    flat_want = dict(_flat(want))
    return {"partitioned": cell.partitioned, "desc": cell.static_desc,
            "logits": logits, "tokens": tokens,
            "caches": {n: (t.full_tensor() if hasattr(t, "full_tensor")
                           else t).numpy() for n, t in _flat(caches)},
            "placements": {n: (tuple(t.placements) == flat_want[n],
                               _specs(t.placements, mesh))
                           for n, t in _flat(caches)
                           if hasattr(t, "placements")},
            "launches": (q8_ops.launches, dict(q8_ops.stage_launches))}


def _collective_shapes(cell):
    """{(functional collective, its input's shape, dtype): count} of one
    step of `cell`."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = {}

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "_c10d_functional" \
                    and "wait" not in func.__name__:
                t = args[0]
                key = (func.__name__.split(".")[0], tuple(t.shape),
                       str(t.dtype))
                seen[key] = seen.get(key, 0) + 1
            return func(*args, **(kwargs or {}))
    with Shapes():
        cell.run()
    return seen


def _rank_main(rank, tmp):
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg.store",
                            rank=rank, world_size=DATA * MODEL)
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        mesh = mesh_mod.make_test_mesh(DATA, MODEL)
        out = {arch: _decode(arch, inp, mesh) for arch in ARCHS}
        with open(os.path.join(tmp, f"rank_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _launch_all(tmp):
    """Every rank forked from this process (one thread, so a fork copies
    no thread's state); then, with no world left, the phi3 cell walked
    on meta under a fake world of (2, 4)."""
    import multiprocessing as mp

    from repro_torch.launch import mesh as mesh_mod
    threads = len(os.listdir("/proc/self/task"))
    assert threads == 1, f"{threads} threads: a fork is not safe"
    ctx = mp.get_context("fork")
    procs = [ctx.Process(target=_rank_main, args=(r, tmp))
             for r in range(DATA * MODEL)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    print("exit codes", codes, flush=True)
    if any(codes):
        sys.exit(1)
    with mesh_mod.fake_world((DATA, MODEL), ("data", "model"),
                             device_type="cpu") as mesh:
        cell = _cell(ARCHS[0], mesh, "meta")
        cost, _ = cell.walk()
        fake = {"shapes": _collective_shapes(cell),
                "declared": {k: v["calls"] for k, v in cost.declared.items()},
                "partitioned": cell.partitioned}
    with open(os.path.join(tmp, "launcher.pkl"), "wb") as f:
        pickle.dump({"fake": fake}, f)


# ---------------------------------------------------------------------------
# the JAX side (one subprocess, 8 host devices)
# ---------------------------------------------------------------------------

JAX_SCRIPT = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs import ShapeConfig, reduced_config
    from repro.distributed import sharding as shd
    from repro.models import api
    tmp = sys.argv[1]
    inp = pickle.load(open(tmp + "/inputs.pkl", "rb"))
    mesh = jax.make_mesh((%(data)d, %(model)d), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    shape = ShapeConfig("decode_q8", %(smax)d, %(b)d, "decode")
    rules = shd.serve_rules(mesh)
    out = {}
    with mesh, shd.axis_rules(mesh, rules):
        for arch in %(archs)r:
            cfg = reduced_config(arch).replace(num_layers=2,
                                               dtype="float32")
            a = inp[arch]
            tree = jax.tree.map(jnp.asarray, a["params"])
            caches = jax.tree.map(jnp.asarray, a["caches"])
            ps = shd.tree_shardings_checked(api.param_specs(cfg), tree,
                                            mesh, rules)
            cs = shd.tree_shardings_checked(
                api.cache_logical_axes(cfg, shape, kv_quant=True), caches,
                mesh, rules)
            ts = NamedSharding(mesh, P(rules["batch"]))

            def step(p, c, t):    # build_decode_cell's serve_step
                lg, _, nc = api.forward(p, {"tokens": t}, cfg,
                                        mode="decode", caches=c,
                                        remat="none")
                nxt = jnp.argmax(lg[:, -1, :cfg.vocab_size], axis=-1)
                return lg, nxt.astype(jnp.int32)[:, None], nc
            fn = jax.jit(step, in_shardings=(ps, cs, ts),
                         out_shardings=(None, None, cs))
            tree, caches = jax.device_put(tree, ps), jax.device_put(caches,
                                                                    cs)
            logits, tokens = [], []
            for tok in a["tokens"]:
                lg, nxt, caches = fn(tree, caches, jnp.asarray(tok))
                logits.append(np.asarray(lg))
                tokens.append(np.asarray(nxt))
            out[arch] = {"logits": logits, "tokens": tokens,
                         "caches": jax.tree.map(np.asarray, caches)}
    pickle.dump(out, open(tmp + "/jax.pkl", "wb"))
""") % {"data": DATA, "model": MODEL, "smax": SMAX, "b": B,
        "archs": ARCHS}


def _inputs():
    """For each arch, the JAX package's weights (seed 0), int8 caches of
    random payload with fp16 scales (as ``quantize_kv`` of N(0, 1) gives
    them) and per-slot lengths LENS, and the decode tokens."""
    import jax

    from repro.configs import reduced_config as jax_reduced
    from repro.models import api as japi
    rng = np.random.default_rng(0)
    out = {}
    for arch in ARCHS:
        jcfg = jax_reduced(arch).replace(num_layers=2, dtype="float32")
        params = jax.tree.map(np.array, japi.build_params(
            jax.random.PRNGKey(0), jcfg))
        caches = jax.tree.map(np.array, japi.init_caches(
            jcfg, B, SMAX, kv_quant=True))
        for stage in caches.values():
            if not isinstance(stage, dict):
                continue
            for name, t in stage.items():
                if t.dtype == np.int8:
                    stage[name] = rng.integers(-127, 128, t.shape
                                               ).astype(np.int8)
                else:
                    stage[name] = rng.uniform(0.01, 0.03, t.shape
                                              ).astype(np.float16)
        caches["len"] = np.array(LENS, dtype=np.int32)
        out[arch] = {"params": params, "caches": caches,
                     "tokens": [rng.integers(0, jcfg.vocab_size, (B, 1)
                                             ).astype(np.int32)
                                for _ in range(STEPS)]}
    return out


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               **extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = str(tmp_path_factory.mktemp("partition_kv_q8"))
    inp = _inputs()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    launch = f"import sys; sys.path[:0] = [{TESTS!r}, {SRC!r}]; " \
        f"import test_torch_partition_kv_q8 as t; t._launch_all({tmp!r})"
    jax_env = _env(XLA_FLAGS="--xla_force_host_platform_device_count="
                   f"{DATA * MODEL}")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", *args], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, args, env in (("jax", [JAX_SCRIPT, tmp], jax_env),
                                ("torch", [launch], _env()))}
    logs = {}
    try:
        for name, p in procs.items():
            logs[name], _ = p.communicate(timeout=TIMEOUT + 60)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = {n: logs.get(n, "")[-5000:] for n, p in procs.items()
           if p.returncode != 0}
    assert not bad, bad

    def load(name):
        with open(os.path.join(tmp, name + ".pkl"), "rb") as f:
            return pickle.load(f)
    return {"jax": load("jax"), "launcher": load("launcher"),
            "ranks": [load(f"rank_{r}") for r in range(DATA * MODEL)]}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_partitioned_int8_decode_matches_jax_mesh_step(runs, arch):
    """3 decode steps of the int8 cell on (data 2, model 4): every
    rank's logits within LOGIT_TOL of max |logit| of the JAX step's
    under the same mesh and rules, finite (a wholly masked shard adds
    zeros, never NaN), the same next tokens; the caches' int8 entries
    and fp16 scales equal but for MAX_FLIPS entries one step or an ulp
    apart."""
    want = runs["jax"][arch]
    want_caches = dict(_flat(want["caches"]))
    for r in runs["ranks"]:
        got = r[arch]
        assert got["partitioned"] and got["desc"] == "decode kv-int8"
        assert len(got["logits"]) == len(want["logits"]) == STEPS
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            assert np.isfinite(g).all(), i
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= LOGIT_TOL, (i, err)
            np.testing.assert_array_equal(got["tokens"][i], want["tokens"][i])
        flips = 0
        for name, g in got["caches"].items():
            w = np.asarray(want_caches[name])
            if name == "len":
                np.testing.assert_array_equal(g, np.add(LENS, STEPS))
            elif g.dtype == np.int8:
                diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert diff.max() <= 1, name
                flips += int((diff != 0).sum())
            else:
                apart = g.view(np.uint16) != w.view(np.uint16)
                np.testing.assert_allclose(g[apart], w[apart], rtol=2e-3)
                flips += int(apart.sum())
        assert flips <= MAX_FLIPS, flips


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_caches_stay_placed_and_launch_no_kernel_on_the_cpu(runs, arch):
    """After the steps every cache leaf keeps the cache rules'
    placements: payload and scales with their batch over ``data`` and
    their sequence over ``model``; the CPU ranks ran the plain stages,
    so no kernel launch is counted."""
    for r in runs["ranks"]:
        pl = r[arch]["placements"]
        assert pl and all(ok for ok, _ in pl.values()), pl
        for name in ("k", "v", "k_scale", "v_scale"):
            assert pl[f"stage1.{name}"][1] == {1: ("data",), 2: ("model",)}
        assert r[arch]["launches"] == (0, {n: 0 for n in (
            "decode_q8_scores", "decode_q8_exp", "decode_q8_pv",
            "decode_q8_pq")})


def test_split_exchanges_row_statistics_not_scores(runs):
    """The fake-world walk of the phi3 int8 cell: each layer's split
    decode all-reduces three fp32 row statistics [rows a rank, KV, G]
    (the max, the sum of exponentials, the max |pv|) and one int32
    [rows a rank, KV, G, D] of P·V sums over ``model``; nothing of the
    cache's length is gathered, and the walk declares the four stages
    once a layer."""
    from repro_torch.models.attention import attn_dims
    cfg = _cfg(ARCHS[0])
    hq, kv, hd = attn_dims(cfg)
    rows, L = B // DATA, cfg.num_layers
    fake = runs["launcher"]["fake"]
    assert fake["partitioned"]
    shapes = fake["shapes"]
    stat = ("all_reduce", (rows, kv, hq // kv), "torch.float32")
    sums = ("all_reduce", (rows, kv, hq // kv, hd), "torch.int32")
    assert shapes.get(stat) == 3 * L and shapes.get(sums) == L, shapes
    local = SMAX // MODEL
    gathered = {k: n for k, n in shapes.items()
                if k[0] == "all_gather_into_tensor"
                and any(d in (local, SMAX) for d in k[1][1:])}
    assert not gathered, gathered
    for name in ("decode_q8_scores", "decode_q8_exp", "decode_q8_pv",
                 "decode_q8_pq"):
        assert fake["declared"][name] == L
    assert "decode_attention_q8" not in fake["declared"]


# ---------------------------------------------------------------------------
# in one process: the split form's blocks, and the production walk
# ---------------------------------------------------------------------------

BLOCK_CASES = [  # B, Smax, KV, G, D, lens, window
    (3, 64, 2, 5, 32, [1, 37, 64], None),      # slot 0: one block's
    (2, 48, 2, 2, 80, [20, 48], None),
    (2, 32, 2, 4, 96, [40, 50], 32),           # a ring past its wrap
    (2, 64, 2, 4, 32, [20, 60], 8),            # a window, not a ring
]


@pytest.mark.parametrize("case", BLOCK_CASES)
@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_plain_split_form_in_blocks_matches_the_whole(case, blocks):
    """The split form over 1, 2 and 4 position blocks on one process
    (``ops.decode_attention_q8_blocks`` on CPU tensors: the plain
    stages, the exchange a reduction over the blocks) against the whole
    plain version: within 1e-6 of max |output|, pq at most one step
    apart at no more than one entry in a thousand, finite where a
    block is wholly masked."""
    from repro_torch.kernels.decode_q8 import ops, ref
    from repro_torch.models.kv_quant import quantize_kv
    Bc, Smax, KV, G, D, lens, window = case
    rng = np.random.default_rng(3)
    k, v = (torch.from_numpy(rng.standard_normal((Bc, Smax, KV, D))
                             .astype(np.float32)) for _ in range(2))
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    cache = dict(k=kq, v=vq, k_scale=ks, v_scale=vs)
    q = torch.from_numpy(rng.standard_normal((Bc, 1, KV * G, D))
                         .astype(np.float32))
    lens = torch.tensor(lens)
    want, _, pq_want, _ = ref.decode_attention_q8_ref(
        q, cache, lens, window=window, debug=True)
    n = Smax // blocks
    parts = [({name: t[:, i * n:(i + 1) * n].contiguous()
               for name, t in cache.items()}, i * n) for i in range(blocks)]
    got, pq = ops.decode_attention_q8_blocks(q, parts, lens, window=window,
                                             smax=Smax, debug=True)
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-6, err
    apart = (pq.int() - pq_want.int()).abs()
    assert int(apart.max()) <= 1
    assert int((apart != 0).sum()) <= apart.numel() // 1000


def test_split_form_refuses_blocks_outside_the_cache_and_past_max_smax():
    """The guard on exact int32 sums takes the whole cache's `smax`, and
    a block must lie inside it."""
    from repro_torch.kernels.decode_q8 import ops
    cache = {"k": torch.zeros((1, 8, 1, 32), dtype=torch.int8),
             "v": torch.zeros((1, 8, 1, 32), dtype=torch.int8),
             "k_scale": torch.zeros((1, 8, 1), dtype=torch.float16),
             "v_scale": torch.zeros((1, 8, 1), dtype=torch.float16)}
    q = torch.zeros((1, 1, 1, 32))
    with pytest.raises(ValueError, match="cache positions"):
        ops.decode_attention_q8_blocks(q, [(cache, 0)], 1,
                                       smax=ops.MAX_SMAX + 1)
    with pytest.raises(ValueError, match="outside"):
        ops.decode_attention_q8_blocks(q, [(cache, 4)], 1, smax=8)


def test_a_shard_without_its_group_raises():
    """Without `group` the cache is the whole one: a `start` or `smax`
    naming a shard of a longer cache raises (it would be masked as if
    it began at position 0), and the whole cache's own values pass."""
    from repro_torch.kernels.decode_q8 import ops
    cache = {"k": torch.ones((1, 8, 1, 32), dtype=torch.int8),
             "v": torch.ones((1, 8, 1, 32), dtype=torch.int8),
             "k_scale": torch.ones((1, 8, 1), dtype=torch.float16),
             "v_scale": torch.ones((1, 8, 1), dtype=torch.float16)}
    q = torch.ones((1, 1, 1, 32))
    for kw in ({"start": 8, "smax": 16}, {"smax": 16}, {"start": 4}):
        with pytest.raises(ValueError, match="need the group"):
            ops.decode_attention_q8(q, cache, 3, **kw)
    want = ops.decode_attention_q8(q, cache, 3)
    assert torch.equal(ops.decode_attention_q8(q, cache, 3, start=0,
                                               smax=8), want)


def test_production_int8_decode_walks_partitioned():
    """phi3-mini-3.8b's ``decode_32k`` with int8 caches on a 16 x 16 fake
    world walks partitioned: every layer runs the split stages, and a
    device holds 1/256 of the caches (batch 128 over data, 32768
    positions over model): k and v 1,610,612,736 bytes each, k_scale
    and v_scale 33,554,432 each (32 layers, 32 kv heads, D 96)."""
    from repro_torch.launch import cells
    from repro_torch.launch import mesh as mesh_mod
    with mesh_mod.fake_world((16, 16), ("data", "model"),
                             device_type="cpu") as mesh:
        cell = cells.build_decode_cell("phi3-mini-3.8b", "decode_32k", mesh,
                                       kv_quant=True)
        cost, _ = cell.walk()
        caches, shard = cell.args[1], cell.in_shardings[1]
        per_dev = {n: cells.leaf_bytes_per_device(
            caches["stage1"][n], shard["stage1"][n], mesh)
            for n in ("k", "v", "k_scale", "v_scale")}
    assert cell.partitioned and cell.static_desc == "decode kv-int8"
    assert cost.declared["decode_q8_pq"]["calls"] == 32
    assert per_dev == {"k": 1_610_612_736, "v": 1_610_612_736,
                       "k_scale": 33_554_432, "v_scale": 33_554_432}
