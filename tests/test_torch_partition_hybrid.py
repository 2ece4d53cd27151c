"""The partitioned hybrid step (DTensor: zamba2's Mamba2 mixers on each
rank's SSM heads, ``act_shard``'s residual, FSDP over ``data``, the
shared attention block tensor-parallel over ``model``) against the JAX
package under the same mesh and rules, on the CPU.

One run of 8 gloo ranks as a (data 2, model 4) mesh, each forked from
one launcher that imported torch once (``OMP_NUM_THREADS=1``), beside
one JAX process with 8 forced host devices on an Auto (data 2, model 4)
mesh.  Every input comes from a numpy seed and reaches each process
through one pickle.  The ranks train reduced fp32 zamba2-7b (4 layers:
a group of 3 Mamba blocks and the shared block, then one tail block;
d_inner 256 in 8 heads, so 2 heads and 64 inner channels a rank) for 2
steps under the train cell's rules (``act_embed`` over ``model``), from
the JAX package's weights (``bridge.from_numpy(..., mesh=)``; A_log,
dt_bias, D and the gated norm's scale drawn from the seed, so that no
two heads are alike), take one whole-batch gradient, then run a [2, 32]
prefill and 3 decode steps under ``serve_rules``, and walk three cells
under ``op_cost`` and ``CommDebugMode``, and serve the long-context
cell (the window patched to 8) through its ring's wrap.  The launcher
then walks the same cells on ``meta`` under ``fake_world((2, 4))``,
recording the shape of every collective.

Tolerances as ``tests/test_torch_partition_moe.py``: losses and grad
norms 1e-5 relative, params 2e-5 absolute after 2 AdamW steps at lr
3e-5, each gradient 1e-5 of its largest |value|, logits 1e-4.
Placements and collectives are exact.
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
ARCH = "zamba2-7b"
DATA, MODEL = 2, 4
STEPS, B, S, MB = 2, 4, 64, 2          # a rank's block: 1 row x 64 tokens
PB, CTX, DECODE, GROW = 2, 32, 3, 36   # prefill [2, 32], 3 decode steps
WINDOW, LONG = 8, 20      # long context: an 8-slot ring, 12 steps past it
LR = 3e-5
TOL = dict(atol=1e-4, rtol=1e-4)
TIMEOUT = 240


def _cfg():
    from repro_torch.configs import reduced_config
    return reduced_config(ARCH).replace(dtype="float32")


def _tc():
    from repro_torch.configs import TrainConfig
    return TrainConfig(learning_rate=LR, total_steps=3, warmup_steps=1,
                       microbatch=MB)


def _cell_cases():
    """(name, shape kind, seq, batch, microbatch) of the walked cells."""
    return (("train", "train", 32, 4, 2), ("prefill", "prefill", 32, 2, None),
            ("decode", "decode", 16, 2, None))


def _cell(case, mesh, device):
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.launch import cells
    name, kind, seq, batch, mb = case
    kw = {}
    if kind == "train":
        kw["tc"] = TrainConfig(microbatch=mb, remat="full",
                               learning_rate=LR)
    return cells.build_cell(ARCH, ShapeConfig(name, seq, batch, kind), mesh,
                            cfg=_cfg(), device=device, **kw)


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


def _coll_kinds(counts):
    """CommDebugMode's {op: count} -> {collective kind: count}."""
    from repro_torch.roofline.op_cost import COLLECTIVES
    out = {}
    for op, n in counts.items():
        kind = COLLECTIVES[str(op).split(".")[-1]][0]
        out[kind] = out.get(kind, 0) + n
    return out


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


def _walks(mesh, device):
    """Each walked cell: op_cost's collectives (kind: count, wire bytes);
    on a real world also the counts CommDebugMode records over a whole
    step; on meta the shape of every collective of a step."""
    from torch.distributed.tensor.debug import CommDebugMode
    out = {}
    for case in _cell_cases():
        cell = _cell(case, mesh, device)
        rec = {"partitioned": cell.partitioned}
        if device == "meta":
            rec["shapes"] = _collective_shapes(cell)
        else:
            with CommDebugMode() as cdm:
                cell.run()
            rec["comm_debug"] = _coll_kinds(cdm.get_comm_counts())
        cost, _ = cell.walk()
        rec.update(counts=dict(cost.coll_op_counts),
                   wire=dict(cost.coll_op_bytes))
        out[case[0]] = rec
    return out


def _train(inp, mesh):
    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import cells
    from repro_torch.models import api
    from repro_torch.training import loop as tl
    from repro_torch.training import optimizer as opt_mod
    cfg = _cfg()
    rules = cells.arch_train_rules(ARCH, mesh)    # act_shard
    params = bridge.from_numpy(inp["params"], cfg, device="cpu", mesh=mesh,
                               rules=rules)
    state = tl.place_state(tl.init_train_state(cfg, _tc(), params=params),
                           mesh, rules)
    step = tl.make_train_step(cfg, _tc())
    losses, norms, layouts = [], [], []
    slices = opt_mod.slices

    def spy(*ts):
        # every tensor the accumulation and the update slice is placed,
        # all alike: no partial grad is read as a shard
        layouts.append(all(hasattr(t, "placements") for t in ts)
                       and len({tuple(t.placements) for t in ts}) == 1)
        return slices(*ts)
    opt_mod.slices = spy
    try:
        with shd.axis_rules(mesh, rules):
            for t in range(STEPS):
                batch = {k: torch.from_numpy(v)
                         for k, v in inp["batches"][t].items()}
                state, met = step(state, batch)
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
    finally:
        opt_mod.slices = slices
    want = shd.tree_shardings_checked(
        api.param_specs(cfg), dict(state.params.named_parameters()), mesh,
        rules)
    return {"grads": _grads(inp, mesh, rules),
            "rules": {k: rules[k] for k in ("act_embed", "ssm_inner",
                                            "state_heads")},
            "losses": losses, "grad_norms": norms, "layouts": layouts,
            "params": bridge.to_numpy(state.params),
            "placements": {n: (tuple(p.placements) == want[n],
                               _specs(p.placements, mesh))
                           for n, p in state.params.named_parameters()},
            "opt_placed": all(
                tuple(f[n].placements) == tuple(p.placements)
                for f in (state.opt.master, state.opt.m, state.opt.v)
                for n, p in state.params.named_parameters())}


def _grads(inp, mesh, rules):
    """The gradient of the loss on the first batch (the trainer's
    accumulation, no microbatches, remat none), every leaf gathered
    whole."""
    from repro_torch import bridge
    from repro_torch.configs import TrainConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.training import loop as tl
    params = bridge.from_numpy(inp["params"], _cfg(), device="cpu",
                               mesh=mesh, rules=rules)
    for p in params.parameters():
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in inp["batches"][0].items()}
    with shd.axis_rules(mesh, rules):
        acc = tl._make_accumulate(_cfg(), TrainConfig(remat="none"))
        return {n: g.full_tensor().numpy()
                for n, g in acc(params, batch)[0].items()}


def _serve(inp, mesh):
    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import api
    cfg = _cfg()
    rules = shd.serve_rules(mesh)
    params = bridge.from_numpy(inp["params"], cfg, device="cpu", mesh=mesh,
                               rules=rules)
    batch = {k: torch.from_numpy(v) for k, v in inp["prompt"].items()}
    with torch.no_grad(), shd.axis_rules(mesh, rules):
        lg, _, caches = api.forward(params, batch, cfg, mode="prefill")
        logits = [lg.full_tensor().numpy()]
        caches = api.grow_caches(cfg, caches, GROW)
        for tok in inp["decode_tokens"]:
            lg, _, caches = api.forward(
                params, {"tokens": torch.from_numpy(tok)}, cfg,
                mode="decode", caches=caches)
            logits.append(lg.full_tensor().numpy())
        want = shd.tree_shardings_checked(api.cache_axes_of(caches), caches,
                                          mesh, rules)
    placements = {}

    def walk(tree, pls, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, pls[k], prefix + k + ".")
            else:
                got = tuple(getattr(v, "placements", (shd.Replicate(),) * 2))
                placements[prefix + k] = (got == pls[k],
                                          _specs(got, mesh))
    walk(caches, want, "")
    return {"logits": logits, "cache_placements": placements}


def _long_context(inp, mesh):
    """zamba2's long-context serving with the window patched to WINDOW:
    a prefill of WINDOW tokens fills the ring (batch whole, the ring's
    slots over ``model``), then LONG - WINDOW decode steps wrap it."""
    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import api
    cfg = _cfg()
    api.ZAMBA_LONG_WINDOW = WINDOW
    rules = shd.serve_rules(mesh, shard_batch=False)
    params = bridge.from_numpy(inp["params"], cfg, device="cpu", mesh=mesh,
                               rules=rules)
    toks = inp["long_tokens"]
    with torch.no_grad(), shd.axis_rules(mesh, rules):
        lg, _, caches = api.forward(
            params, {"tokens": torch.from_numpy(toks[:, :WINDOW])}, cfg,
            mode="prefill", long_context=True)
        logits = [lg.full_tensor().numpy()]
        ring = _specs(caches["kv"]["k"].placements, mesh)
        for i in range(WINDOW, LONG):
            lg, _, caches = api.forward(
                params, {"tokens": torch.from_numpy(toks[:, i:i + 1])}, cfg,
                mode="decode", caches=caches, long_context=True)
            logits.append(lg.full_tensor().numpy())
    return {"logits": logits, "ring": ring,
            "slots": int(caches["kv"]["k"].shape[2])}


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
        out = {"train": _train(inp, mesh), "serve": _serve(inp, mesh),
               "long": _long_context(inp, mesh),
               "walks": _walks(mesh, "cpu")}
        with open(os.path.join(tmp, f"rank_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _launch_all(tmp):
    """Every rank forked from this process (one thread, so a fork copies
    no thread's state); then, with no world left, the same cells walked
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
        fake = _walks(mesh, "meta")
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
    cfg = reduced_config(%(arch)r).replace(dtype="float32")
    tc = TrainConfig(learning_rate=%(lr)r, total_steps=3, warmup_steps=1,
                     microbatch=%(mb)d)
    rules = shd.train_rules(mesh)
    rules["act_embed"] = "model"                      # act_shard
    out = {}
    with mesh, shd.axis_rules(mesh, rules):
        params = jax.tree.map(jnp.asarray, inp["params"])
        st = tl.TrainState(params=params, opt=opt.init_opt_state(params),
                           err=None)
        ss = shd.tree_shardings_checked(tl.train_state_specs(cfg, tc), st,
                                        mesh, rules)
        bs = NamedSharding(mesh, P(rules["batch"]))
        step = jax.jit(tl.make_train_step(cfg, tc), in_shardings=(ss, bs),
                       out_shardings=(ss, None))
        st = jax.device_put(st, ss)
        losses, norms = [], []
        for b in inp["batches"]:
            st, met = step(st, jax.device_put(
                {k: jnp.asarray(v) for k, v in b.items()}, bs))
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        out["train"] = {"losses": losses, "grad_norms": norms,
                        "params": jax.tree.map(np.asarray, st.params)}
        acc = tl._make_accumulate(cfg, TrainConfig(remat="none"), 1)
        p0 = jax.device_put(
            jax.tree.map(jnp.asarray, inp["params"]),
            shd.tree_shardings_checked(api.param_specs(cfg), inp["params"],
                                       mesh, rules))
        b0 = jax.device_put({k: jnp.asarray(v)
                             for k, v in inp["batches"][0].items()}, bs)
        out["grads"] = jax.tree.map(np.asarray, jax.jit(acc)(p0, b0)[0])
    rules = shd.serve_rules(mesh)
    with mesh, shd.axis_rules(mesh, rules):
        tree = jax.device_put(
            jax.tree.map(jnp.asarray, inp["params"]),
            shd.tree_shardings_checked(api.param_specs(cfg), inp["params"],
                                       mesh, rules))
        prefill = jax.jit(lambda p, b: api.forward(p, b, cfg,
                                                   mode="prefill"))
        decode = jax.jit(lambda p, b, c: api.forward(
            p, b, cfg, mode="decode", caches=c))
        lg, _, c = prefill(tree, {k: jnp.asarray(v)
                                  for k, v in inp["prompt"].items()})
        logits = [np.asarray(lg)]
        c = api.grow_caches(cfg, c, %(grow)d)
        for tok in inp["decode_tokens"]:
            lg, _, c = decode(tree, {"tokens": jnp.asarray(tok)}, c)
            logits.append(np.asarray(lg))
    out["serve"] = {"logits": logits}
    api.ZAMBA_LONG_WINDOW = %(window)d        # one device: GSPMD's answer
    tree = jax.tree.map(jnp.asarray, inp["params"])
    toks = inp["long_tokens"]
    lg, _, c = api.forward(tree, {"tokens": jnp.asarray(toks[:, :%(window)d])},
                           cfg, mode="prefill", long_context=True)
    logits = [np.asarray(lg)]
    decode = jax.jit(lambda p, b, c: api.forward(
        p, b, cfg, mode="decode", caches=c, long_context=True))
    for i in range(%(window)d, %(long)d):
        lg, _, c = decode(tree, {"tokens": jnp.asarray(toks[:, i:i + 1])}, c)
        logits.append(np.asarray(lg))
    out["long"] = {"logits": logits}
    pickle.dump(out, open(tmp + "/jax.pkl", "wb"))
""") % {"arch": ARCH, "lr": LR, "mb": MB, "grow": GROW, "data": DATA,
        "model": MODEL, "window": WINDOW, "long": LONG}


def _inputs():
    """The JAX package's weights (seed 0) with A_log, dt_bias, D and the
    gated norm's scale drawn from a numpy seed, the train batches, the
    prompt and the decode tokens."""
    import jax

    from repro.configs import reduced_config as jax_reduced
    from repro.models import api as japi
    rng = np.random.default_rng(0)
    jcfg = jax_reduced(ARCH).replace(dtype="float32")
    params = jax.tree.map(np.array, japi.build_params(jax.random.PRNGKey(0),
                                                      jcfg))
    for stack in ("blocks", "tail"):
        mix = params[stack]["mixer"]
        for name, lo, hi in (("A_log", -1.0, 1.0), ("dt_bias", -1.0, 1.0),
                             ("D", 0.5, 1.5), ("norm", 0.5, 1.5)):
            mix[name] = rng.uniform(lo, hi, mix[name].shape).astype(
                np.float32)
    V = jcfg.vocab_size
    return {"params": params,
            "batches": [{k: rng.integers(0, V, (B, S)).astype(np.int32)
                         for k in ("tokens", "labels")}
                        for _ in range(STEPS)],
            "prompt": {"tokens": rng.integers(0, V, (PB, CTX)
                                              ).astype(np.int32)},
            "decode_tokens": [rng.integers(0, V, (PB, 1)).astype(np.int32)
                              for _ in range(DECODE)],
            "long_tokens": rng.integers(0, V, (1, LONG)).astype(np.int32)}


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
    tmp = str(tmp_path_factory.mktemp("partition_hybrid"))
    inp = _inputs()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    launch = f"import sys; sys.path[:0] = [{TESTS!r}, {SRC!r}]; " \
        f"import test_torch_partition_hybrid as t; t._launch_all({tmp!r})"
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

def test_partitioned_hybrid_train_steps_match_jax_mesh_step(runs):
    """2 steps on (data 2, model 4) under ``act_shard``: the losses and
    the grad norms within 1e-5 of the JAX step under the same Auto mesh
    and rules, every param within 2e-5, the same on every rank; the
    grads reach the optimizer placed like their params."""
    want = runs["jax"]["train"]
    w = dict(_flat(want["params"]))
    for r in runs["ranks"]:
        got = r["train"]
        assert got["rules"] == {"act_embed": "model", "ssm_inner": "model",
                                "state_heads": "model"}
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                                   rtol=1e-5)
        assert got["layouts"] and all(got["layouts"])
        g = dict(_flat(got["params"]))
        assert g.keys() == w.keys()
        for name in w:
            np.testing.assert_allclose(g[name], w[name], atol=2e-5, rtol=0,
                                       err_msg=name)


def test_partitioned_hybrid_grads_match_jax_mesh_grads(runs):
    """One whole-batch gradient, every leaf gathered whole, within 1e-5
    of its largest |value| of the JAX mesh step's: a leaf used whole on
    a rank's heads (w_B, w_C, w_dt, conv_B, conv_C, A_log, D, dt_bias)
    whose gradient is one rank's share, or counted ``model`` times, is
    far outside."""
    want = dict(_flat(runs["jax"]["grads"]))
    for r in runs["ranks"]:
        got = dict(_flat(r["train"]["grads"]))
        assert got.keys() == want.keys()
        bad = {n: float(np.abs(got[n] - w).max() / np.abs(w).max())
               for n, w in want.items()
               if np.abs(got[n] - w).max() > 1e-5 * np.abs(w).max()}
        assert not bad, bad
        for n in ("blocks.mixer.A_log", "tail.mixer.dt_bias",
                  "blocks.mixer.conv_B"):
            assert np.abs(got[n]).max() > 0, n


def test_hybrid_placements_after_steps_are_the_rules(runs):
    """Every param keeps the rules' checked placements through the steps,
    and so do the optimizer's master, m and v: the mixers' inner
    channels over model and their d over data, B, C and dt whole over
    model, A_log, D and dt_bias whole."""
    for r in runs["ranks"]:
        got = r["train"]
        assert all(ok for ok, _ in got["placements"].values()), \
            {n: s for n, (ok, s) in got["placements"].items() if not ok}
        assert got["opt_placed"]
    specs = {n: s for n, (_, s) in
             runs["ranks"][0]["train"]["placements"].items()}
    mix = "blocks.mixer."
    assert specs[mix + "w_x"] == {1: ("data",), 2: ("model",)}
    assert specs[mix + "w_B"] == {1: ("data",)}
    assert specs[mix + "conv_x"] == {1: ("model",)}
    assert specs[mix + "norm"] == {1: ("model",)}
    assert specs[mix + "w_out"] == {1: ("model",), 2: ("data",)}
    assert specs["blocks.norm"] == {1: ("data",)}
    for name in ("A_log", "D", "dt_bias", "conv_B"):
        assert specs[mix + name] == {}


def test_partitioned_hybrid_prefill_and_decode_match_jax(runs):
    """A [2, 32] prefill and 3 decode steps under ``serve_rules``: every
    rank's logits within the families test's tolerance of the JAX
    ``api.forward`` under the same mesh; the caches after the decode
    steps placed exactly by the cache rules (SSM states over
    ``state_heads``, conv states over ``ssm_inner``, K/V over
    ``kv_seq``), written into their local shards."""
    want = runs["jax"]["serve"]["logits"]
    for r in runs["ranks"]:
        got = r["serve"]
        assert len(got["logits"]) == len(want) == DECODE + 1
        for i, (g, w) in enumerate(zip(got["logits"], want)):
            np.testing.assert_allclose(g, w, err_msg=f"step {i}", **TOL)
        pl = got["cache_placements"]
        assert all(ok for ok, _ in pl.values()), pl
    pl = runs["ranks"][0]["serve"]["cache_placements"]
    assert pl["mamba.ssm"][1] == {1: ("data",), 2: ("model",)}
    assert pl["mamba.conv_x"][1] == {1: ("data",), 3: ("model",)}
    assert pl["tail.conv_B"][1] == {1: ("data",), 3: ("model",)}
    assert pl["kv.k"][1] == {1: ("data",), 2: ("model",)}


def test_partitioned_long_context_ring_wraps_as_jax(runs):
    """zamba2's long-context serving (the window patched to 8 in both
    packages) under ``serve_rules(shard_batch=False)``: the 8-slot ring
    of the shared attention's caches split over ``model`` (2 slots a
    rank, batch whole), a prefill that fills it and 12 decode steps
    that wrap it twice, each write landing on the rank that holds its
    slot: every rank's logits within 1e-4 of the JAX long-context
    forward's."""
    want = runs["jax"]["long"]["logits"]
    for r in runs["ranks"]:
        got = r["long"]
        assert got["slots"] == WINDOW and got["ring"] == {2: ("model",)}
        assert len(got["logits"]) == len(want) == LONG - WINDOW + 1
        for i, (g, w) in enumerate(zip(got["logits"], want)):
            np.testing.assert_allclose(g, w, err_msg=f"step {i}", **TOL)


@pytest.mark.parametrize("case", [c[0] for c in _cell_cases()])
def test_fake_world_walk_charges_the_gloo_hybrid_collectives(runs, case):
    """The meta walk under ``fake_world((2, 4))`` charges the collectives
    the gloo ranks issue, by kind: the count CommDebugMode records on
    every rank and the wire bytes a device op_cost reads there."""
    fake = runs["launcher"]["fake"][case]
    assert fake["partitioned"]
    for r in runs["ranks"]:
        w = r["walks"][case]
        assert w["partitioned"]
        assert w["comm_debug"] == {k: int(v) for k, v in
                                   fake["counts"].items()}
        assert w["counts"] == fake["counts"]
        assert w["wire"] == fake["wire"]


@pytest.mark.parametrize("case", [c[0] for c in _cell_cases()])
def test_gated_norm_all_reduces_row_statistics_not_rows(runs, case):
    """Each Mamba block's gated norm (over d_inner, sharded over
    ``model``) all-reduces one fp32 statistic a row, [rows a rank, S],
    once a forward (train: again in the remat recompute of the group's
    blocks, and once in the backward); no collective gathers the gated
    rows [..., S, d_inner].  A train step's loss adds two all-reduces of
    that shape a microbatch (its row sums of exponentials and gold
    logits over the vocab shards)."""
    from repro_torch.models.zamba import plan
    _, kind, seq, batch, mb = [c for c in _cell_cases() if c[0] == case][0]
    cfg = _cfg()
    di = cfg.ssm.expand * cfg.d_model
    rows = (mb or batch) // DATA
    S_step = 1 if kind == "decode" else seq
    shapes = runs["launcher"]["fake"][case]["shapes"]
    n_stat = shapes.get(("all_reduce", (rows, S_step), "torch.float32"), 0)
    want = cfg.num_layers
    if kind == "train":
        n_groups, g, _ = plan(cfg)
        want = batch // mb * (2 * cfg.num_layers + n_groups * g + 2)
    assert n_stat == want, shapes
    gathered = {k: n for k, n in shapes.items()
                if k[0] == "all_gather_into_tensor" and len(k[1]) == 3
                and k[1][1:] in ((S_step, di), (S_step, di // MODEL))}
    assert not gathered, gathered


def test_ssm_state_heads_agree_with_ssm_inner():
    """Where the rules shard the mixers' inner channels over ``model``
    they shard the SSM state's heads too, on whole heads: zamba2-7b's
    112 heads (7168 channels) on 16 model ranks, reduced zamba2's 8
    (256) on 4."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.ssm import ssm_dims
    for cfg, model in ((get_config(ARCH), 16), (_cfg(), MODEL)):
        mesh = MeshShape(("data", "model"), (2, model))
        rules = shd.train_rules(mesh)
        di, H, Pd, N = ssm_dims(cfg)
        w = shd.checked_spec(("embed", "ssm_inner"), (cfg.d_model, di),
                             mesh, rules)
        state = shd.checked_spec(("batch", "state_heads", None, None),
                                 (2, H, N, Pd), mesh, rules)
        assert w[1] == state[1] == "model"
        assert (di // model) % Pd == 0 and H % model == 0


def test_hybrid_dry_run_long_context_record_is_partitioned(tmp_path):
    """The dry run's zamba2 ``long_500k`` cell on the 256-rank fake world:
    a partitioned record, one device's share, whose collectives hold the
    81 gated norms' all-reduces of row statistics."""
    from repro_torch.launch import dryrun
    (rec,) = dryrun.run_target(ARCH, "long_500k", ("single",), str(tmp_path))
    assert rec["status"] == "ok" and rec["partitioned"] is True
    assert rec["roofline"]["per_device"] is True
    assert rec["cost"]["declared"]["rmsnorm_row_fwd"]["calls"] == 81
    assert rec["per_device"]["collectives_by_kind"]["all-reduce"] >= 81


def test_heads_whole_where_d_inner_does_not_divide_model():
    """On a (2, 3) fake world reduced zamba2's d_inner (256) and its 8
    heads do not divide the model axis: the rules leave them whole, so
    every rank runs all heads and the gated norm takes the whole-row
    kernel; the train, prefill and decode cells still walk
    partitioned."""
    from repro_torch.launch import mesh as mesh_mod
    with mesh_mod.fake_world((2, 3), ("data", "model"),
                             device_type="cpu") as mesh:
        for case in _cell_cases():
            cell = _cell(case, mesh, "meta")
            cost, _ = cell.walk()
            assert cell.partitioned
            assert "rmsnorm_row_fwd" not in cost.declared
            assert cost.declared["rmsnorm"]["calls"] > 0
            if case[1] != "decode":
                assert cost.declared["ssd_intra"]["calls"] > 0


def test_gated_norm_counts_under_its_own_kernel_name():
    """With obs kernel timing on, a partitioned prefill counts each gated
    norm once under ``kernels.rmsnorm_split``: as many calls as the
    split norm's forward kernels the walk declared."""
    from repro_torch import obs
    from repro_torch.launch import mesh as mesh_mod
    key = "kernels.rmsnorm_split.launches"
    before = obs.metrics.snapshot().get(key, {}).get("value", 0)
    obs.enable_kernel_timing()
    try:
        with mesh_mod.fake_world((DATA, MODEL), ("data", "model"),
                                 device_type="cpu") as mesh:
            cost, _ = _cell(_cell_cases()[1], mesh, "meta").walk()
    finally:
        obs.disable_kernel_timing()
    got = obs.metrics.snapshot()[key]["value"] - before
    assert got == cost.declared["rmsnorm_row_fwd"]["calls"] > 0
