"""The partitioned xlstm step (DTensor: the mLSTM's projections, conv,
gate and ``w_out`` over ``model`` by ``ssm_inner``, both recurrences on
each rank's batch rows with all heads, FSDP over ``data``, the tied
head's logits over ``model``) against the JAX package under the same
mesh and rules, on the CPU.

One run of 8 gloo ranks as a (data 2, model 4) mesh, each forked from
one launcher that imported torch once (``OMP_NUM_THREADS=1``), beside
one JAX process with 8 forced host devices on an Auto (data 2, model 4)
mesh.  Every input comes from a numpy seed and reaches each process
through one pickle.  The ranks train reduced fp32 xlstm-125m (2 layers
of the pattern ("m", "s"): d 128 in 2 heads, so the mLSTM's d_inner 256
has heads of 128 and a rank's 64 inner channels cut a head) for 2 steps
at [4, 128] (two mLSTM chunks, microbatch 2) under the train rules,
from the JAX package's weights (the norms' scales and the sLSTM's cell
and output gates' biases drawn from the seed, so that no two channels
are alike), take
one whole-batch gradient, then run a [2, 64] prefill and 3 decode steps
under ``serve_rules``, and walk three cells under ``op_cost`` and
``CommDebugMode``.  While they run, the launcher walks the same cells
on ``meta`` under ``fake_world((2, 4))``, recording the shape of every
collective, walks the train and prefill cells again at 32 tokens and
all three on a (2, 3) fake world, and walks ``chip_smoke.py``'s three
xlstm check cells at full width on ``meta`` under ``fake_world((1,
1))`` (the train cell's, the longest walk, in a process of its own
started first).

Tolerances as ``tests/test_torch_partition_hybrid.py``: losses and grad
norms 1e-5 relative, params 2e-5 absolute after 2 AdamW steps at lr
3e-5, each gradient 1e-5 of its largest |value|, logits 1e-4.  The
input gates' biases are held to 1e-5 of the largest |value| of any
leaf, as ``tests/test_torch_train_families.py`` holds the sLSTM's: a
cell's output is the same for any shift of that bias (it scales the
memory and its normalizer alike) wherever the normalizer's clamp at 1
does not bind, so the gradient is rounding noise in either package.
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
ARCH = "xlstm-125m"
PATTERN, LAYERS = ("m", "s"), 2
DATA, MODEL = 2, 4
STEPS, B, S, MB = 2, 4, 128, 2         # a rank's block: 1 row x 128 tokens
PB, CTX, DECODE = 2, 64, 3             # prefill [2, 64], 3 decode steps
SHORT = 32                # the train and prefill cells again at this length
# chip_smoke.py's DRYRUN_CHECKS: name: (kind, seq, batch, microbatch)
CHECKS = {"xlstm_train": ("train", 320, 2, 1),
          "xlstm_prefill": ("prefill", 1024, 1, None),
          "xlstm_decode": ("decode", 4096, 16, None)}
LR = 3e-5
TOL = dict(atol=1e-4, rtol=1e-4)
TIMEOUT = 240


def _cfg():
    from repro_torch.configs import reduced_config
    return reduced_config(ARCH).replace(dtype="float32",
                                        xlstm_pattern=PATTERN,
                                        num_layers=LAYERS)


def _tc():
    from repro_torch.configs import TrainConfig
    return TrainConfig(learning_rate=LR, total_steps=3, warmup_steps=1,
                       microbatch=MB)


def _cell_cases():
    """(name, shape kind, seq, batch, microbatch) of the walked cells."""
    return (("train", "train", 64, 4, 2), ("prefill", "prefill", 64, 2, None),
            ("decode", "decode", 16, 2, None))


def _cell(case, mesh, device, cfg=None):
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.launch import cells
    name, kind, seq, batch, mb = case
    kw = {}
    if kind == "train":
        kw["tc"] = TrainConfig(microbatch=mb, remat="full",
                               learning_rate=LR)
    return cells.build_cell(ARCH, ShapeConfig(name, seq, batch, kind), mesh,
                            cfg=cfg or _cfg(), device=device, **kw)


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


def _walk_shapes(cell):
    """(op_cost's walk of `cell`, {(functional collective, its input's
    shape, dtype): count} of that walk)."""
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
        cost, _ = cell.walk()
    return cost, seen


def _walks(mesh, device):
    """Each walked cell: op_cost's collectives (kind: count, wire bytes)
    and the shape of every collective of the walk; on a real world also
    the counts CommDebugMode records over a whole step."""
    from torch.distributed.tensor.debug import CommDebugMode
    out = {}
    for case in _cell_cases():
        cell = _cell(case, mesh, device)
        rec = {"partitioned": cell.partitioned}
        if device != "meta":
            with CommDebugMode() as cdm:
                cell.run()
            rec["comm_debug"] = _coll_kinds(cdm.get_comm_counts())
        cost, rec["shapes"] = _walk_shapes(cell)
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
    rules = cells.arch_train_rules(ARCH, mesh)
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
                                            "mlp", "vocab")},
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
        vocab = _specs(lg.placements, mesh)
        for tok in inp["decode_tokens"]:
            lg, _, caches = api.forward(
                params, {"tokens": torch.from_numpy(tok)}, cfg,
                mode="decode", caches=caches)
            logits.append(lg.full_tensor().numpy())
        want = shd.tree_shardings_checked(api.cache_axes_of(caches), caches,
                                          mesh, rules)
    placements = {f"{layer}.{k}": (tuple(v.placements) == want[layer][k],
                                   _specs(v.placements, mesh))
                  for layer, tree in caches.items() for k, v in tree.items()}
    return {"logits": logits, "vocab": vocab,
            "cache_placements": placements,
            "conv_local": tuple(caches["layer_00"]["conv"].to_local().shape)}


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
               "walks": _walks(mesh, "cpu")}
        with open(os.path.join(tmp, f"rank_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _at_short_length(mesh):
    """The train and prefill cells walked on meta at SHORT tokens:
    {name: collective counts by kind}."""
    out = {}
    for case in _cell_cases()[:2]:
        cell = _cell(case[:2] + (SHORT,) + case[3:], mesh, "meta")
        out[case[0]] = dict(cell.walk()[0].coll_op_counts)
    return out


def _on_model_3(mesh):
    """The walked cells on a (2, 3) fake world, whose model axis does
    not divide d_inner: {name: form, w_x's specs, RMSNorm calls}."""
    out = {}
    for case in _cell_cases():
        cell = _cell(case, mesh, "meta")
        model = cell.args[0]
        params = dict((model.params if case[1] == "train"
                       else model).named_parameters())
        cost, _ = cell.walk()
        out[case[0]] = {
            "partitioned": cell.partitioned,
            "w_x": _specs(params["layer_00.cell.w_x"].placements, mesh),
            "rmsnorm_calls": cost.declared["rmsnorm"]["calls"]}
    return out


def _checks(tmp, names):
    """chip_smoke.py's xlstm check cells `names` at full width
    (xlstm-125m, 12 layers) walked on meta under a fake world of
    (1, 1), into ``checks_<name>.pkl``."""
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.launch import cells
    from repro_torch.launch import mesh as mesh_mod
    with mesh_mod.fake_world((1, 1), ("data", "model"),
                             device_type="cpu") as mesh:
        for name in names:
            kind, seq, batch, mb = CHECKS[name]
            kw = {"tc": TrainConfig(microbatch=mb, remat="full",
                                    learning_rate=LR)} \
                if kind == "train" else {}
            cell = cells.build_cell(ARCH, ShapeConfig(name, seq, batch, kind),
                                    mesh, device="meta", **kw)
            cost, outs = cell.walk()
            rec = {
                "partitioned": cell.partitioned,
                "layers": cell.cfg.num_layers, "d": cell.cfg.d_model,
                "flops": cost.flops, "bytes": cost.bytes,
                "product_flops": cost.product_flops,
                "declared": {k: v["calls"] for k, v in cost.declared.items()},
                "collectives": dict(cost.coll_op_counts),
                "state_bytes": cell.state_bytes_per_device(outs),
                "arg_bytes": cell.arg_bytes_per_device()}
            with open(os.path.join(tmp, f"checks_{name}.pkl"), "wb") as f:
                pickle.dump(rec, f)


def _launch_all(tmp):
    """Every rank forked from this process (one thread, so a fork copies
    no thread's state); then, while they run, the meta walks on fake
    worlds of (2, 4), (2, 3) and (1, 1) (this process holds no real
    world)."""
    import multiprocessing as mp

    from repro_torch.launch import mesh as mesh_mod
    threads = len(os.listdir("/proc/self/task"))
    assert threads == 1, f"{threads} threads: a fork is not safe"
    ctx = mp.get_context("fork")
    procs = [ctx.Process(target=_rank_main, args=(r, tmp))
             for r in range(DATA * MODEL)]
    for p in procs:
        p.start()
    try:
        with mesh_mod.fake_world((DATA, MODEL), ("data", "model"),
                                 device_type="cpu") as mesh:
            fake = {"walks": _walks(mesh, "meta"),
                    "short": _at_short_length(mesh)}
        with mesh_mod.fake_world((DATA, 3), ("data", "model"),
                                 device_type="cpu") as mesh:
            fake["model_3"] = _on_model_3(mesh)
        _checks(tmp, [n for n in CHECKS if n != "xlstm_train"])
    finally:
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
    with open(os.path.join(tmp, "launcher.pkl"), "wb") as f:
        pickle.dump(fake, f)


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
    cfg = reduced_config(%(arch)r).replace(
        dtype="float32", xlstm_pattern=%(pattern)r, num_layers=%(layers)d)
    tc = TrainConfig(learning_rate=%(lr)r, total_steps=3, warmup_steps=1,
                     microbatch=%(mb)d)
    rules = shd.train_rules(mesh)
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
        for tok in inp["decode_tokens"]:
            lg, _, c = decode(tree, {"tokens": jnp.asarray(tok)}, c)
            logits.append(np.asarray(lg))
    out["serve"] = {"logits": logits}
    pickle.dump(out, open(tmp + "/jax.pkl", "wb"))
""") % {"arch": ARCH, "lr": LR, "mb": MB, "data": DATA, "model": MODEL,
        "pattern": PATTERN, "layers": LAYERS}


def _inputs():
    """The JAX package's weights (seed 0) with every norm's scale and the
    sLSTM's cell and output gates' biases drawn from a numpy seed (the
    input and forget gates' biases keep their init), the train batches,
    the prompt and the decode tokens."""
    import jax

    from repro.configs import reduced_config as jax_reduced
    from repro.models import api as japi
    rng = np.random.default_rng(0)
    jcfg = jax_reduced(ARCH).replace(dtype="float32", xlstm_pattern=PATTERN,
                                     num_layers=LAYERS)
    params = jax.tree.map(np.array, japi.build_params(jax.random.PRNGKey(0),
                                                      jcfg))

    def draw(tree, name, lo, hi):
        tree[name] = rng.uniform(lo, hi, tree[name].shape).astype(np.float32)
    draw(params, "final_norm", 0.5, 1.5)
    for i in range(LAYERS):
        layer = params[f"layer_{i:02d}"]
        draw(layer, "norm", 0.5, 1.5)
        cell = layer["cell"]
        draw(cell, "norm", 0.5, 1.5)
        for g in ("b_z", "b_o"):
            if g in cell:
                draw(cell, g, -1.0, 1.0)
    V = jcfg.vocab_size
    return {"params": params,
            "batches": [{k: rng.integers(0, V, (B, S)).astype(np.int32)
                         for k in ("tokens", "labels")}
                        for _ in range(STEPS)],
            "prompt": {"tokens": rng.integers(0, V, (PB, CTX)
                                              ).astype(np.int32)},
            "decode_tokens": [rng.integers(0, V, (PB, 1)).astype(np.int32)
                              for _ in range(DECODE)]}


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               **extra)
    return env


def _start(name, args, env):
    return name, subprocess.Popen(
        [sys.executable, "-c", *args], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = str(tmp_path_factory.mktemp("partition_xlstm"))
    head = f"import sys; sys.path[:0] = [{TESTS!r}, {SRC!r}]; " \
        "import test_torch_partition_xlstm as t; "
    # the longest walk (the train check cell's fit) starts first
    procs = dict([_start("checks", [head + f"t._checks({tmp!r}, "
                                    "['xlstm_train'])"], _env())])
    inp = _inputs()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    jax_env = _env(XLA_FLAGS="--xla_force_host_platform_device_count="
                   f"{DATA * MODEL}")
    procs.update([_start("jax", [JAX_SCRIPT, tmp], jax_env),
                  _start("torch", [head + f"t._launch_all({tmp!r})"],
                         _env())])
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
            "checks": {n: load(f"checks_{n}") for n in CHECKS},
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

def test_partitioned_xlstm_train_steps_match_jax_mesh_step(runs):
    """2 steps on (data 2, model 4) under the train rules: the losses and
    the grad norms within 1e-5 of the JAX step under the same Auto mesh
    and rules, every param within 2e-5, the same on every rank; the
    grads reach the optimizer placed like their params."""
    want = runs["jax"]["train"]
    w = dict(_flat(want["params"]))
    for r in runs["ranks"]:
        got = r["train"]
        assert got["rules"] == {"act_embed": None, "ssm_inner": "model",
                                "mlp": "model", "vocab": "model"}
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                                   rtol=1e-5)
        assert got["layouts"] and all(got["layouts"])
        g = dict(_flat(got["params"]))
        assert g.keys() == w.keys()
        for name in w:
            np.testing.assert_allclose(g[name], w[name], atol=2e-5, rtol=0,
                                       err_msg=name)


def test_partitioned_xlstm_grads_match_jax_mesh_grads(runs):
    """One whole-batch gradient, every leaf gathered whole, within 1e-5
    of its largest |value| of the JAX mesh step's (the input gates'
    biases, whose gradients vanish, within 1e-5 of the largest of any
    leaf): a leaf used whole on a rank's rows (the sLSTM's recurrent
    weights, the norms' scales) whose gradient is one rank's share, or
    counted ``model`` times, is far outside."""
    want = dict(_flat(runs["jax"]["grads"]))
    largest = max(float(np.abs(w).max()) for w in want.values())
    vanishing = {f"layer_{i:02d}.cell.b_i" for i in range(LAYERS)}
    for r in runs["ranks"]:
        got = dict(_flat(r["train"]["grads"]))
        assert got.keys() == want.keys()
        bad = {}
        for n, w in want.items():
            scale = largest if n in vanishing else float(np.abs(w).max())
            err = float(np.abs(got[n] - w).max())
            if err > 1e-5 * scale:
                bad[n] = err / scale
        assert not bad, bad
        for n in ("layer_01.cell.r_f", "layer_00.cell.norm",
                  "layer_00.cell.conv", "layer_01.cell.w_out"):
            assert np.abs(got[n]).max() > 0, n


def test_xlstm_placements_after_steps_are_the_rules(runs):
    """Every param keeps the rules' checked placements through the steps,
    and so do the optimizer's master, m and v: the mLSTM's inner
    channels over model and its d over data, the sLSTM's gate weights
    over data only, its recurrent weights and the gate biases whole."""
    for r in runs["ranks"]:
        got = r["train"]
        assert all(ok for ok, _ in got["placements"].values()), \
            {n: s for n, (ok, s) in got["placements"].items() if not ok}
        assert got["opt_placed"]
    specs = {n: s for n, (_, s) in
             runs["ranks"][0]["train"]["placements"].items()}
    m, s = "layer_00.cell.", "layer_01.cell."
    assert specs[m + "w_x"] == {0: ("data",), 1: ("model",)}
    assert specs[m + "wq"] == {0: ("model",)}
    assert specs[m + "conv"] == {0: ("model",)}
    assert specs[m + "norm"] == {0: ("model",)}
    assert specs[m + "w_out"] == {0: ("model",), 1: ("data",)}
    assert specs[s + "w_i"] == {0: ("data",)}
    assert specs[s + "w_out"] == {0: ("data",), 1: ("model",)}
    assert specs["embed"] == {0: ("model",), 1: ("data",)}
    for name in (m + "b_i", m + "b_f", s + "r_i", s + "b_f"):
        assert specs[name] == {}, name


def test_partitioned_xlstm_prefill_and_decode_match_jax(runs):
    """A [2, 64] prefill and 3 decode steps under ``serve_rules``: every
    rank's logits (vocab over ``model``) within the families test's
    tolerance of the JAX ``api.forward`` under the same mesh; the caches
    after the decode steps placed exactly by the cache rules: the
    mLSTM's conv state over ``ssm_inner`` (a rank's 64 channels), its
    matrix memory and every sLSTM state over the batch axes only."""
    want = runs["jax"]["serve"]["logits"]
    for r in runs["ranks"]:
        got = r["serve"]
        assert got["vocab"] == {0: ("data",), 2: ("model",)}
        assert len(got["logits"]) == len(want) == DECODE + 1
        for i, (g, w) in enumerate(zip(got["logits"], want)):
            np.testing.assert_allclose(g, w, err_msg=f"step {i}", **TOL)
        pl = got["cache_placements"]
        assert all(ok for ok, _ in pl.values()), pl
    got = runs["ranks"][0]["serve"]
    pl = got["cache_placements"]
    assert pl["layer_00.conv"][1] == {0: ("data",), 2: ("model",)}
    assert got["conv_local"] == (1, 3, 2 * _cfg().d_model // MODEL)
    for name in ("layer_00.C", "layer_00.n", "layer_00.m", "layer_01.c",
                 "layer_01.n", "layer_01.m", "layer_01.h"):
        assert pl[name][1] == {0: ("data",)}, name


@pytest.mark.parametrize("case", [c[0] for c in _cell_cases()])
def test_fake_world_walk_charges_the_gloo_xlstm_collectives(runs, case):
    """The meta walk under ``fake_world((2, 4))`` issues the collectives
    the gloo ranks issue, shape for shape, and charges them by kind: the
    count CommDebugMode records on every rank and the wire bytes a
    device op_cost reads there."""
    fake = runs["launcher"]["walks"][case]
    assert fake["partitioned"] and fake["shapes"]
    for r in runs["ranks"]:
        w = r["walks"][case]
        assert w["partitioned"]
        assert w["shapes"] == fake["shapes"]
        assert w["comm_debug"] == {k: int(v) for k, v in
                                   fake["counts"].items()}
        assert w["counts"] == fake["counts"]
        assert w["wire"] == fake["wire"]


@pytest.mark.parametrize("case", [c[0] for c in _cell_cases()[:2]])
def test_no_collective_inside_the_recurrences(runs, case):
    """The train and prefill cells walked at 32 and 64 tokens issue the
    same collectives: none sits inside the sLSTM's loop over tokens or
    the mLSTM's over chunks, so the count is constant in the length
    (and ``Cell.walk``'s quadratic fit stays exact)."""
    fake = runs["launcher"]
    at_64 = fake["walks"][case]["counts"]
    assert at_64 and fake["short"][case] == at_64


@pytest.mark.parametrize("name", list(CHECKS))
def test_check_cells_walk_partitioned_at_full_width(runs, name):
    """``chip_smoke.py``'s xlstm check cells (xlstm-125m at 12 layers and
    d 768) build and walk partitioned on meta under ``fake_world((1,
    1))``: the train and prefill through the fit, the RMSNorm kernels
    declared (both forms, and their backwards in train), no collective
    on one rank, the state's bytes above the arguments'."""
    rec = runs["checks"][name]
    kind = CHECKS[name][0]
    assert rec["partitioned"] and (rec["layers"], rec["d"]) == (12, 768)
    assert rec["flops"] > 0 and rec["bytes"] > 0
    assert rec["product_flops"] > 0
    used = ["rmsnorm", "add_rmsnorm"] + (
        ["rmsnorm_bwd", "add_rmsnorm_bwd"] if kind == "train" else [])
    assert all(rec["declared"].get(k, 0) > 0 for k in used), rec["declared"]
    assert not rec["collectives"]
    assert rec["state_bytes"] >= rec["arg_bytes"] > 0


def test_inner_channels_whole_where_d_inner_does_not_divide_model(runs):
    """On a (2, 3) fake world reduced xlstm's d_inner (256) does not
    divide the model axis: the rules leave the mLSTM's inner channels
    whole (``w_x`` over ``data`` only), and the train, prefill and
    decode cells still walk partitioned, their norms on the kernel."""
    for case, rec in runs["launcher"]["model_3"].items():
        assert rec["partitioned"], case
        assert rec["w_x"] == {0: ("data",)}, case
        assert rec["rmsnorm_calls"] > 0, case
