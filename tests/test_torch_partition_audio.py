"""The partitioned audio step (DTensor: whisper-tiny's encoder and
decoder on the dense family's placed attention and MLP, FSDP over
``data``, tensor parallelism over ``model``, the cross attention on
local heads, a decode's self and cross attention context-parallel over
the caches' ``kv_seq``) against the JAX package under the same mesh and
rules, on the CPU.

One run of 8 gloo ranks as a (data 2, model 4) mesh, each forked from
one launcher that imported torch once (``OMP_NUM_THREADS=1``), beside
one JAX process with 8 forced host devices on an Auto (data 2, model 4)
mesh.  Every input comes from a numpy seed and reaches each process
through one pickle.  Reduced fp32 whisper-tiny (2 encoder and 2 decoder
layers, d 128, 4 heads: one a model rank) in two cases of its
``encoder_ctx``: 32 frames, which the 4-way model axis shards (the
cross caches' frames over ``model``, the cross decode context-parallel),
and 30, which stay whole, as whisper's 1500 frames do on a 16-way axis.
In each the ranks train 2 steps (2 microbatches) under the default
``train_rules``, then run a [2, 16] prefill and 3 decode steps under
``serve_rules``; the launcher then walks the decode cell on ``meta``
under ``fake_world((2, 4))``, recording the shape of every collective.

Tolerances as ``tests/test_torch_partition.py``: losses and grad norms
1e-5 relative, params 2e-5 absolute after 2 AdamW steps at lr 3e-5
(fp32 sums in other orders), logits 1e-4.  Placements and collectives
are exact.
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
ARCH = "whisper-tiny"
DATA, MODEL = 2, 4
CTXS = (32, 30)             # encoder frames: sharded over model, and whole
STEPS, B, S, MB = 2, 4, 16, 2
PB, PS, DECODE, GROW = 2, 16, 3, 20
LR = 3e-5
TOL = dict(atol=1e-4, rtol=1e-4)
TIMEOUT = 240


def _cfg(ctx):
    from repro_torch.configs import reduced_config
    return reduced_config(ARCH).replace(num_layers=2, dtype="float32",
                                        encoder_ctx=ctx)


def _tc():
    from repro_torch.configs import TrainConfig
    return TrainConfig(learning_rate=LR, total_steps=3, warmup_steps=1,
                       microbatch=MB)


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


def _batch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _train(ctx, inp, mesh):
    from repro_torch import bridge
    from repro_torch.launch import cells
    from repro_torch.distributed import sharding as shd
    from repro_torch.training import loop as tl
    cfg = _cfg(ctx)
    rules = cells.arch_train_rules(ARCH, mesh)
    params = bridge.from_numpy(inp["params"], cfg, device="cpu", mesh=mesh,
                               rules=rules)
    state = tl.place_state(tl.init_train_state(cfg, _tc(), params=params),
                           mesh, rules)
    step = tl.make_train_step(cfg, _tc())
    losses, norms = [], []
    with shd.axis_rules(mesh, rules):
        for b in inp["batches"]:
            state, met = step(state, _batch(b))
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
    return {"losses": losses, "grad_norms": norms,
            "rules": {k: rules[k] for k in ("act_embed", "seq", "kv_seq")},
            "params": bridge.to_numpy(state.params)}


def _serve(ctx, inp, mesh):
    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import api
    cfg = _cfg(ctx)
    rules = shd.serve_rules(mesh)
    params = bridge.from_numpy(inp["params"], cfg, device="cpu", mesh=mesh,
                               rules=rules)
    with torch.no_grad(), shd.axis_rules(mesh, rules):
        lg, _, caches = api.forward(params, _batch(inp["prompt"]), cfg,
                                    mode="prefill")
        logits = [lg.full_tensor().numpy()]
        prefill_pl = {n: _specs(caches[n].placements, mesh)
                      for n in ("k", "xk")}
        caches = api.grow_caches(cfg, caches, GROW)
        for tok in inp["decode_tokens"]:
            lg, _, caches = api.forward(
                params, {"tokens": torch.from_numpy(tok)}, cfg,
                mode="decode", caches=caches)
            logits.append(lg.full_tensor().numpy())
        want = shd.tree_shardings_checked(api.cache_axes_of(caches), caches,
                                          mesh, rules)
    return {"logits": logits, "prefill_placements": prefill_pl,
            "cache_placements": {
                n: (tuple(t.placements) == want[n], _specs(t.placements,
                                                           mesh))
                for n, t in caches.items() if hasattr(t, "placements")}}


def _decode_cell(ctx, mesh, device):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import cells
    return cells.build_decode_cell(ARCH, ShapeConfig("decode", GROW, B,
                                                     "decode"),
                                   mesh, cfg=_cfg(ctx), device=device)


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
        out = {ctx: {"train": _train(ctx, inp[ctx], mesh),
                     "serve": _serve(ctx, inp[ctx], mesh)} for ctx in CTXS}
        with open(os.path.join(tmp, f"rank_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _launch_all(tmp):
    """Every rank forked from this process (one thread, so a fork copies
    no thread's state); then, with no world left, each case's decode
    cell walked on meta under a fake world of (2, 4)."""
    import multiprocessing as mp

    from repro_torch.launch import mesh as mesh_mod
    threads = len(os.listdir("/proc/self/task"))
    assert threads == 1, f"{threads} threads: a fork is not safe"
    ctx_ = mp.get_context("fork")
    procs = [ctx_.Process(target=_rank_main, args=(r, tmp))
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
    fake = {}
    with mesh_mod.fake_world((DATA, MODEL), ("data", "model"),
                             device_type="cpu") as mesh:
        for ctx in CTXS:
            cell = _decode_cell(ctx, mesh, "meta")
            fake[ctx] = {"partitioned": cell.partitioned,
                         "shapes": _collective_shapes(cell)}
    with open(os.path.join(tmp, "launcher.pkl"), "wb") as f:
        pickle.dump({"fake": fake}, f)


# ---------------------------------------------------------------------------
# the JAX side (one subprocess, 8 host devices)
# ---------------------------------------------------------------------------

JAX_SCRIPT = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs import TrainConfig, reduced_config
    from repro.distributed import sharding as shd
    from repro.models import api
    from repro.training import loop as tl, optimizer as opt
    tmp = sys.argv[1]
    inp = pickle.load(open(tmp + "/inputs.pkl", "rb"))
    mesh = jax.make_mesh((%(data)d, %(model)d), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    tc = TrainConfig(learning_rate=%(lr)r, total_steps=3, warmup_steps=1,
                     microbatch=%(mb)d)
    out = {}
    for ctx in %(ctxs)r:
        a = inp[ctx]
        cfg = reduced_config(%(arch)r).replace(num_layers=2,
                                               dtype="float32",
                                               encoder_ctx=ctx)
        res = {}
        rules = shd.train_rules(mesh)
        with mesh, shd.axis_rules(mesh, rules):
            params = jax.tree.map(jnp.asarray, a["params"])
            st = tl.TrainState(params=params,
                               opt=opt.init_opt_state(params), err=None)
            ss = shd.tree_shardings_checked(tl.train_state_specs(cfg, tc),
                                            st, mesh, rules)
            bs = NamedSharding(mesh, P(rules["batch"]))
            step = jax.jit(tl.make_train_step(cfg, tc),
                           in_shardings=(ss, bs), out_shardings=(ss, None))
            st = jax.device_put(st, ss)
            losses, norms = [], []
            for b in a["batches"]:
                st, met = step(st, jax.device_put(
                    {k: jnp.asarray(v) for k, v in b.items()}, bs))
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
            res["train"] = {"losses": losses, "grad_norms": norms,
                            "params": jax.tree.map(np.asarray, st.params)}
        rules = shd.serve_rules(mesh)
        with mesh, shd.axis_rules(mesh, rules):
            tree = jax.device_put(
                jax.tree.map(jnp.asarray, a["params"]),
                shd.tree_shardings_checked(api.param_specs(cfg),
                                           a["params"], mesh, rules))
            prefill = jax.jit(lambda p, b: api.forward(p, b, cfg,
                                                       mode="prefill"))
            decode = jax.jit(lambda p, b, c: api.forward(
                p, b, cfg, mode="decode", caches=c))
            lg, _, c = prefill(tree, {k: jnp.asarray(v)
                                      for k, v in a["prompt"].items()})
            logits = [np.asarray(lg)]
            c = api.grow_caches(cfg, c, %(grow)d)
            for tok in a["decode_tokens"]:
                lg, _, c = decode(tree, {"tokens": jnp.asarray(tok)}, c)
                logits.append(np.asarray(lg))
        res["serve"] = {"logits": logits}
        out[ctx] = res
    pickle.dump(out, open(tmp + "/jax.pkl", "wb"))
""") % {"arch": ARCH, "lr": LR, "mb": MB, "grow": GROW, "data": DATA,
        "model": MODEL, "ctxs": CTXS}


def _inputs():
    """For each encoder_ctx: the JAX package's weights (seed 0), the
    train batches with their frames, the prompt and the decode
    tokens."""
    import jax

    from repro.configs import reduced_config as jax_reduced
    from repro.models import api as japi
    rng = np.random.default_rng(0)
    out = {}
    for ctx in CTXS:
        jcfg = jax_reduced(ARCH).replace(num_layers=2, dtype="float32",
                                         encoder_ctx=ctx)
        V, d = jcfg.vocab_size, jcfg.d_model

        def frames(n):
            return rng.standard_normal((n, ctx, d)).astype(np.float32)
        out[ctx] = {
            "params": jax.tree.map(np.array, japi.build_params(
                jax.random.PRNGKey(0), jcfg)),
            "batches": [{"tokens": rng.integers(0, V, (B, S)
                                                ).astype(np.int32),
                         "labels": rng.integers(0, V, (B, S)
                                                ).astype(np.int32),
                         "frames": frames(B)} for _ in range(STEPS)],
            "prompt": {"tokens": rng.integers(0, V, (PB, PS)
                                              ).astype(np.int32),
                       "frames": frames(PB)},
            "decode_tokens": [rng.integers(0, V, (PB, 1)).astype(np.int32)
                              for _ in range(DECODE)]}
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
    tmp = str(tmp_path_factory.mktemp("partition_audio"))
    inp = _inputs()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    launch = f"import sys; sys.path[:0] = [{TESTS!r}, {SRC!r}]; " \
        f"import test_torch_partition_audio as t; t._launch_all({tmp!r})"
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


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctx", CTXS)
def test_partitioned_whisper_train_steps_match_jax_mesh_step(runs, ctx):
    """2 steps on (data 2, model 4) under the default ``train_rules``
    (whisper has no per-arch knobs): the losses and grad norms within
    1e-5 of the JAX step under the same Auto mesh and rules, every param
    within 2e-5, on every rank."""
    want = runs["jax"][ctx]["train"]
    w = dict(_flat(want["params"]))
    for r in runs["ranks"]:
        got = r[ctx]["train"]
        assert got["rules"] == {"act_embed": None, "seq": None,
                                "kv_seq": "model"}
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                                   rtol=1e-5)
        g = dict(_flat(got["params"]))
        assert g.keys() == w.keys()
        for name in w:
            np.testing.assert_allclose(g[name], w[name], atol=2e-5, rtol=0,
                                       err_msg=name)


@pytest.mark.parametrize("ctx", CTXS)
def test_partitioned_whisper_prefill_and_decode_match_jax(runs, ctx):
    """A [2, 16] prefill and 3 decode steps under ``serve_rules``: every
    rank's logits within 1e-4 of the JAX ``api.forward`` under the same
    mesh; the caches placed by the cache rules, self attention's
    positions over ``model``, the cross caches' frames over ``model``
    where 32 frames divide it and whole where 30 do not."""
    want = runs["jax"][ctx]["serve"]["logits"]
    frames = {2: ("model",)} if ctx % MODEL == 0 else {}
    for r in runs["ranks"]:
        got = r[ctx]["serve"]
        assert len(got["logits"]) == len(want) == DECODE + 1
        for i, (g, w) in enumerate(zip(got["logits"], want)):
            np.testing.assert_allclose(g, w, err_msg=f"step {i}", **TOL)
        pl = got["cache_placements"]
        assert set(pl) == {"k", "v", "xk", "xv"}
        assert all(ok for ok, _ in pl.values()), pl
        assert pl["k"][1] == {1: ("data",), 2: ("model",)}
        for name in ("xk", "xv"):
            assert pl[name][1] == {1: ("data",), **frames}
        assert got["prefill_placements"] == {
            "k": {1: ("data",), 2: ("model",)},
            "xk": {1: ("data",), **frames}}


@pytest.mark.parametrize("ctx", CTXS)
def test_cross_decode_is_context_parallel_where_frames_are_sharded(runs,
                                                                   ctx):
    """The fake-world walk of the decode cell: each decoder layer's self
    attention all-reduces its row max and sum [rows a rank, KV, G] and
    its output [rows, KV, G, D] over ``model``; the cross attention does
    the same over sharded frames (ctx 32) and nothing over whole ones
    (ctx 30)."""
    from repro_torch.models.attention import attn_dims
    cfg = _cfg(ctx)
    hq, kv, hd = attn_dims(cfg)
    rows, L = B // DATA, cfg.num_layers
    fake = runs["launcher"]["fake"][ctx]
    assert fake["partitioned"]
    per_layer = 2 if ctx % MODEL == 0 else 1
    shapes = fake["shapes"]
    stat = ("all_reduce", (rows, kv, hq // kv), "torch.float32")
    outs = ("all_reduce", (rows, kv, hq // kv, hd), "torch.float32")
    assert shapes.get(stat) == 2 * per_layer * L, shapes
    assert shapes.get(outs) == per_layer * L, shapes


def test_whisper_dry_run_records_are_partitioned(tmp_path):
    """whisper-tiny's decode_32k on the 256-rank fake world: a
    partitioned record, one device's share; its 1500 frames stay whole
    on the 16-way model axis, so the cross caches shard only their
    batch."""
    from repro_torch.launch import cells, dryrun
    from repro_torch.launch import mesh as mesh_mod
    (rec,) = dryrun.run_target(ARCH, "decode_32k", ("single",),
                               str(tmp_path))
    assert rec["status"] == "ok" and rec["partitioned"] is True
    assert rec["roofline"]["per_device"] is True
    with mesh_mod.fake_world((16, 16), ("data", "model"),
                             device_type="cpu") as mesh:
        cell = cells.build_decode_cell(ARCH, "decode_32k", mesh)
        pl = cell.in_shardings[1]
        assert _specs(pl["xk"], mesh) == {1: ("data",)}
        assert _specs(pl["k"], mesh) == {1: ("data",), 2: ("model",)}
