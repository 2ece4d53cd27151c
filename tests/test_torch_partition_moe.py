"""The partitioned MoE step (DTensor: expert parallelism over ``model``
through the a2a dispatch, FSDP of the expert weights over ``data``,
``seq_shard``'s sequence-sharded residual) against the JAX package under
the same mesh and rules, on the CPU.

One run of 8 gloo ranks as a (data 2, model 4) mesh, each forked from
one launcher that imported torch once (``OMP_NUM_THREADS=1``), beside
one JAX process with 8 forced host devices on an Auto (data 2, model 4)
mesh: the local capacity of the a2a dispatch makes the mesh step's drops
differ from one device's, so the reference is the JAX step under the
same mesh and rules.  Every input comes from a numpy seed and reaches
each process through one pickle.  The ranks train reduced fp32
olmoe-1b-7b (MoE in both layers) and deepseek-moe-16b (a dense
``stage0``, an MoE ``stage1`` with shared experts) for 2 steps under the
train cells' rules (``seq_shard``), from the JAX package's weights
(``bridge.from_numpy(..., mesh=)``), then run a [2, 32] prefill (the a2a
path) and 3 decode steps (the global sort) under ``serve_rules``, and
walk three cells under ``op_cost`` and ``CommDebugMode``.  The launcher
then walks the same cells on ``meta`` under ``fake_world((2, 4))``.

The router is biased towards expert 0 (its column and a shift of every
embedding row share a direction), so every rank's local capacity
drops pairs, and the one-device step, whose capacity is global, gives
other losses.

Tolerances as ``tests/test_torch_partition.py``: losses and grad norms
1e-5 relative, params 2e-5 absolute after 2 AdamW steps at lr 3e-5,
logits 1e-4.  Placements and collectives are exact.
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
ARCHS = ("olmoe-1b-7b", "deepseek-moe-16b")
STEPS, B, S, MB = 2, 4, 64, 2          # a rank's block: 1 row x 16 tokens
PB, CTX, DECODE, GROW = 2, 32, 3, 36   # prefill [2, 32], 3 decode steps
LR = 3e-5
SHIFT, BIAS = 1.0, 0.5                 # the router's pull towards expert 0
TOL = dict(atol=1e-4, rtol=1e-4)
TIMEOUT = 240


def _cfg(arch):
    from repro_torch.configs import reduced_config
    return reduced_config(arch).replace(num_layers=2, dtype="float32")


def _tc():
    from repro_torch.configs import TrainConfig
    return TrainConfig(learning_rate=LR, total_steps=3, warmup_steps=1,
                       microbatch=MB)


def _cell_cases():
    """(name, arch, shape kind, seq, batch, microbatch) of the walked
    cells: the a2a path in train and prefill, the sort in decode."""
    return (("olmoe_train", "olmoe-1b-7b", "train", 32, 4, 2),
            ("deepseek_prefill", "deepseek-moe-16b", "prefill", 32, 2,
             None),
            ("olmoe_decode", "olmoe-1b-7b", "decode", 16, 2, None))


def _cell(case, mesh, device):
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.launch import cells
    name, arch, kind, seq, batch, mb = case
    kw = {}
    if kind == "train":
        kw["tc"] = TrainConfig(microbatch=mb, remat="full",
                               learning_rate=LR)
    return cells.build_cell(arch, ShapeConfig(name, seq, batch, kind), mesh,
                            cfg=_cfg(arch), device=device, **kw)


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


def _walks(mesh, device):
    """Each walked cell: op_cost's collectives (kind: count, wire bytes);
    on a real world also the counts CommDebugMode records over a whole
    step."""
    from torch.distributed.tensor.debug import CommDebugMode
    out = {}
    for case in _cell_cases():
        cell = _cell(case, mesh, device)
        rec = {"partitioned": cell.partitioned}
        if device != "meta":
            with CommDebugMode() as cdm:
                cell.run()
            rec["comm_debug"] = _coll_kinds(cdm.get_comm_counts())
        cost, _ = cell.walk()
        rec.update(counts=dict(cost.coll_op_counts),
                   wire=dict(cost.coll_op_bytes))
        out[case[0]] = rec
    return out


class _Spy:
    """Counts the MoE layer's forms and the pairs its dispatch drops."""

    def __init__(self):
        from repro_torch.models import moe, moe_a2a
        self.mods = {"a2a": moe_a2a, "sort": moe}
        self.real = {f: m.moe_dispatch for f, m in self.mods.items()}
        self.calls = {f: 0 for f in self.mods}
        self.drops = {f: 0 for f in self.mods}

    def __enter__(self):
        for form, mod in self.mods.items():
            mod.moe_dispatch = self._wrap(form)
        return self

    def _wrap(self, form):
        def spy(eidx, x, E, C):
            out = self.real[form](eidx, x, E, C)
            self.calls[form] += 1
            self.drops[form] += int((out[1] == E * C).sum())
            return out
        return spy

    def __exit__(self, *exc):
        for form, mod in self.mods.items():
            mod.moe_dispatch = self.real[form]

    def read(self):
        return {"calls": dict(self.calls), "drops": dict(self.drops)}


def _train(arch, inp, mesh):
    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import cells
    from repro_torch.models import api
    from repro_torch.training import loop as tl
    from repro_torch.training import optimizer as opt_mod
    cfg = _cfg(arch)
    rules = cells.arch_train_rules(arch, mesh)    # seq_shard
    params = bridge.from_numpy(inp["params"][arch], cfg, device="cpu",
                               mesh=mesh, rules=rules)
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
        with shd.axis_rules(mesh, rules), _Spy() as moe_spy:
            for t in range(STEPS):
                batch = {k: torch.from_numpy(v) for k, v in
                         inp["batches"][arch][t].items()}
                state, met = step(state, batch)
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
    finally:
        opt_mod.slices = slices
    want = shd.tree_shardings_checked(
        api.param_specs(cfg), dict(state.params.named_parameters()), mesh,
        rules)
    return {"grads": _grads(arch, inp, mesh, rules),
            "sort_grads": _grads(arch, inp, mesh,
                                 {**rules, "moe_dispatch": "sort"}),
        "rules": {k: rules[k] for k in ("seq", "act_embed", "experts")},
        "losses": losses, "grad_norms": norms, "layouts": layouts,
        "moe": moe_spy.read(), "params": bridge.to_numpy(state.params),
        "placements": {n: (tuple(p.placements) == want[n],
                           _specs(p.placements, mesh))
                       for n, p in state.params.named_parameters()},
        "opt_placed": all(
            tuple(t.placements) == tuple(p.placements)
            for f in (state.opt.master, state.opt.m, state.opt.v)
            for (n, p), t in zip(state.params.named_parameters(),
                                 f.values()))}


def _grads(arch, inp, mesh, rules):
    """The grads of ce + aux (the trainer's accumulation, no
    microbatches) and of aux alone on the first batch, from the JAX
    weights, gathered whole."""
    from repro_torch import bridge
    from repro_torch.configs import TrainConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import api
    from repro_torch.training import loop as tl
    cfg = _cfg(arch)
    params = bridge.from_numpy(inp["params"][arch], cfg, device="cpu",
                               mesh=mesh, rules=rules)
    for p in params.parameters():
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v)
             for k, v in inp["batches"][arch][0].items()}
    out = {}
    with shd.axis_rules(mesh, rules), _Spy() as moe_spy:
        acc = tl._make_accumulate(cfg, TrainConfig(remat="none"))
        out["loss"] = {n: g.full_tensor().numpy()
                       for n, g in acc(params, batch)[0].items()}
    out["moe"] = moe_spy.read()
    with shd.axis_rules(mesh, rules):
        placed = tl.place_batch(batch, mesh, rules)
        logits, aux, _ = api.forward(params, placed, cfg, mode="train",
                                     remat="none")
        # ce scaled by 0 gives every layer a gradient: DTensor's unbind
        # backward cannot stack a placed layer's with a missing one
        ce = tl.cross_entropy(logits, placed["labels"], cfg.vocab_size)
        (aux + 0.0 * ce).backward()
    out["aux"] = {n: p.grad.full_tensor().numpy()
                  for n, p in params.named_parameters()
                  if p.grad is not None}
    return out


def _serve(arch, inp, mesh):
    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import api
    cfg = _cfg(arch)
    rules = shd.serve_rules(mesh)
    params = bridge.from_numpy(inp["params"][arch], cfg, device="cpu",
                               mesh=mesh, rules=rules)
    batch = {k: torch.from_numpy(v) for k, v in inp["prompts"][arch].items()}
    logits, forms = [], []
    with torch.no_grad(), shd.axis_rules(mesh, rules):
        with _Spy() as moe_spy:
            lg, _, caches = api.forward(params, batch, cfg, mode="prefill")
        forms.append(moe_spy.read())
        logits.append(lg.full_tensor().numpy())
        caches = api.grow_caches(cfg, caches, GROW)
        with _Spy() as moe_spy:
            for tok in inp["decode_tokens"][arch]:
                lg, _, caches = api.forward(
                    params, {"tokens": torch.from_numpy(tok)}, cfg,
                    mode="decode", caches=caches)
                logits.append(lg.full_tensor().numpy())
        forms.append(moe_spy.read())
    return {"logits": logits, "forms": forms}


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
        out = {"coord": mesh.get_coordinate(),
               "train": {a: _train(a, inp, mesh) for a in ARCHS},
               "serve": {a: _serve(a, inp, mesh) for a in ARCHS},
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
    out = {"train": {}, "one_device": {}, "serve": {}}

    def train(cfg, tc, arch, rules):
        params = jax.tree.map(jnp.asarray, inp["params"][arch])
        st = tl.TrainState(params=params, opt=opt.init_opt_state(params),
                           err=None)
        step = tl.make_train_step(cfg, tc)
        if rules is None:
            step, put = jax.jit(step), lambda b: b
        else:
            ss = shd.tree_shardings_checked(tl.train_state_specs(cfg, tc),
                                            st, mesh, rules)
            bs = NamedSharding(mesh, P(rules["batch"]))
            st = jax.device_put(st, ss)
            step = jax.jit(step, in_shardings=(ss, bs),
                           out_shardings=(ss, None))
            put = lambda b: jax.device_put(b, bs)
        losses, norms = [], []
        for b in inp["batches"][arch]:
            st, met = step(st, put({k: jnp.asarray(v) for k, v in b.items()}))
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        return {"losses": losses, "grad_norms": norms,
                "params": jax.tree.map(np.asarray, st.params)}

    def grads(cfg, arch, rules):
        # fp32 grads of ce + aux and of aux alone on the first batch,
        # whole (no microbatches)
        params = jax.tree.map(jnp.asarray, inp["params"][arch])
        batch = {k: jnp.asarray(v) for k, v in inp["batches"][arch][0].items()}
        acc = tl._make_accumulate(cfg, TrainConfig(remat="none"), 1)
        aux = jax.grad(lambda p, b: api.forward(p, b, cfg, mode="train",
                                                remat="none")[1])
        if rules is not None:
            params = jax.device_put(params, shd.tree_shardings_checked(
                api.param_specs(cfg), params, mesh, rules))
            batch = jax.device_put(batch,
                                   NamedSharding(mesh, P(rules["batch"])))
        return {"loss": jax.jit(acc)(params, batch)[0],
                "aux": jax.jit(aux)(params, batch)}

    for arch in %(archs)r:
        cfg = reduced_config(arch).replace(num_layers=2, dtype="float32")
        tc = TrainConfig(learning_rate=%(lr)r, total_steps=3,
                         warmup_steps=1, microbatch=%(mb)d)
        rules = shd.train_rules(mesh)
        rules["seq"], rules["act_embed"] = "model", None  # seq_shard
        with mesh, shd.axis_rules(mesh, rules):
            out["train"][arch] = train(cfg, tc, arch, rules)
            out["train"][arch]["grads"] = jax.tree.map(
                np.asarray, grads(cfg, arch, rules))
        out["one_device"][arch] = train(cfg, tc, arch, None)
        out["one_device"][arch]["grads"] = jax.tree.map(
            np.asarray, grads(cfg, arch, None))
        rules = shd.serve_rules(mesh)
        with mesh, shd.axis_rules(mesh, rules):
            tree = jax.device_put(
                jax.tree.map(jnp.asarray, inp["params"][arch]),
                shd.tree_shardings_checked(api.param_specs(cfg),
                                           inp["params"][arch], mesh, rules))
            prefill = jax.jit(lambda p, b: api.forward(p, b, cfg,
                                                       mode="prefill"))
            decode = jax.jit(lambda p, b, c: api.forward(
                p, b, cfg, mode="decode", caches=c))
            batch = {k: jnp.asarray(v)
                     for k, v in inp["prompts"][arch].items()}
            lg, _, c = prefill(tree, batch)
            logits = [np.asarray(lg)]
            c = api.grow_caches(cfg, c, %(grow)d)
            for tok in inp["decode_tokens"][arch]:
                lg, _, c = decode(tree, {"tokens": jnp.asarray(tok)}, c)
                logits.append(np.asarray(lg))
        out["serve"][arch] = {"logits": logits}
    pickle.dump(out, open(tmp + "/jax.pkl", "wb"))
""") % {"archs": ARCHS, "lr": LR, "mb": MB, "grow": GROW, "data": DATA,
        "model": MODEL}


def _biased(tree, rng):
    """The JAX weights with the router pulled towards expert 0: every
    embedding row shifted along one direction u, which each MoE
    router's expert-0 column reads."""
    d = tree["embed"].shape[1]
    u = rng.standard_normal(d).astype(np.float32)
    u /= np.linalg.norm(u)
    tree["embed"] = tree["embed"] + SHIFT * float(
        np.sqrt(d) * tree["embed"].std()) * u
    for name, stage in tree.items():
        if isinstance(stage, dict) and "moe" in stage:
            stage["moe"]["router"][..., :, 0] += BIAS * np.sqrt(d) * u
    return tree


def _inputs():
    """The JAX package's weights (seed 0, biased), the train batches and
    the prompts from numpy seeds; the decode tokens are drawn from a
    seed (the same for both packages)."""
    import jax

    from repro.configs import reduced_config as jax_reduced
    from repro.models import api as japi
    rng = np.random.default_rng(0)
    params, batches, prompts, toks = {}, {}, {}, {}
    for arch in ARCHS:
        jcfg = jax_reduced(arch).replace(num_layers=2, dtype="float32")
        params[arch] = _biased(jax.tree.map(np.array, japi.build_params(
            jax.random.PRNGKey(0), jcfg)), rng)
        V = jcfg.vocab_size
        batches[arch] = [{k: rng.integers(0, V, (B, S)).astype(np.int32)
                          for k in ("tokens", "labels")}
                         for _ in range(STEPS)]
        prompts[arch] = {"tokens": rng.integers(0, V, (PB, CTX)
                                                ).astype(np.int32)}
        toks[arch] = [rng.integers(0, V, (PB, 1)).astype(np.int32)
                      for _ in range(DECODE)]
    return {"params": params, "batches": batches, "prompts": prompts,
            "decode_tokens": toks}


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               **extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("partition_moe"))
    inp = _inputs()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    launch = f"import sys; sys.path[:0] = [{TESTS!r}, {SRC!r}]; " \
        f"import test_torch_partition_moe as t; t._launch_all({tmp!r})"
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
    return {"inp": inp, "jax": load("jax"), "launcher": load("launcher"),
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

@pytest.mark.parametrize("arch", ARCHS)
def test_partitioned_moe_train_steps_match_jax_mesh_step(runs, arch):
    """2 steps on (data 2, model 4) under ``seq_shard``: the losses and
    the grad norms within 1e-5 of the JAX step under the same Auto mesh
    and rules, every param within 2e-5, the same on every rank.  The
    norm sees a gradient counted twice or world-size times (the aux
    loss's, the router's), which AdamW's update does not; the grads
    reach the optimizer placed like their params."""
    want = runs["jax"]["train"][arch]
    w = dict(_flat(want["params"]))
    for r in runs["ranks"]:
        got = r["train"][arch]
        assert got["rules"] == {"seq": "model", "act_embed": None,
                                "experts": "model"}
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                                   rtol=1e-5)
        assert got["layouts"] and all(got["layouts"])
        g = dict(_flat(got["params"]))
        assert g.keys() == w.keys()
        for name in w:
            np.testing.assert_allclose(g[name], w[name], atol=2e-5, rtol=0,
                                       err_msg=f"{arch} {name}")


def _close(got, want, rel):
    """Every leaf within `rel` of its largest |value|."""
    bad = {n: float(np.abs(got[n] - w).max() / np.abs(w).max())
           for n, w in want.items()
           if np.abs(got[n] - w).max() > rel * np.abs(w).max()}
    assert not bad, bad


@pytest.mark.parametrize("arch", ARCHS)
def test_partitioned_moe_grads_match_jax_mesh_grads(runs, arch):
    """One whole-batch gradient of ce + aux, and of the aux loss alone,
    every leaf gathered whole, within 1e-5 of its largest |value| of the
    JAX mesh step's: a gradient counted twice, world-size or ep times
    (the router's partial sums, the aux loss's reductions, the
    exchange's backward) is far outside."""
    want = runs["jax"]["train"][arch]["grads"]
    for r in runs["ranks"]:
        got = r["train"][arch]["grads"]
        _close(dict(_flat(got["loss"])), dict(_flat(want["loss"])), 1e-5)
        aux = dict(_flat(want["aux"]))
        assert set(got["aux"]) <= set(aux)
        _close(got["aux"], {n: aux[n] for n in got["aux"]}, 1e-5)
        assert np.abs(got["aux"]["stage1.moe.router"]).max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_partitioned_sort_dispatch_grads_match_one_device(runs, arch):
    """With the rules' ``moe_dispatch`` "sort" knob the placed layer runs
    the global sort on the same mesh (every rank routes every token,
    the expert GEMMs on its experts-over-model, slots-over-data shard,
    the experts' grads partial over data): its capacity is global, so
    its gradient of ce + aux is the one-device step's, every leaf
    within 1e-5 of its largest |value|."""
    want = dict(_flat(runs["jax"]["one_device"][arch]["grads"]["loss"]))
    for r in runs["ranks"]:
        got = r["train"][arch]["sort_grads"]
        assert got["moe"]["calls"]["a2a"] == 0 < got["moe"]["calls"]["sort"]
        _close(dict(_flat(got["loss"])), want, 1e-5)


def test_jax_mesh_aux_gradient_is_the_one_device_gradient(runs):
    """The reference's own aux gradient: JAX sums the aux loss's terms by
    ``psum`` inside a ``shard_map`` with ``check_vma=False``, whose
    transpose could count the loss once a device.  deepseek's one MoE
    layer reads no capacity-dependent input (its ``stage0`` is dense),
    so its aux gradient must be the one-device one: it is, within 1e-5,
    and the port mirrors it (above)."""
    arch = "deepseek-moe-16b"
    mesh = dict(_flat(runs["jax"]["train"][arch]["grads"]["aux"]))
    one = dict(_flat(runs["jax"]["one_device"][arch]["grads"]["aux"]))
    _close({n: mesh[n] for n in ("stage1.moe.router", "embed")},
           {n: one[n] for n in ("stage1.moe.router", "embed")}, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_capacity_drops_pairs_unlike_one_device(runs, arch):
    """The train steps ran the a2a path only, every rank's dispatch
    dropped pairs at its local capacity, and the one-device step (global
    capacity) gives losses far outside the tolerance: the parity above
    tells the local capacity from the global one."""
    for r in runs["ranks"]:
        moe = r["train"][arch]["moe"]
        assert moe["calls"]["a2a"] > 0 and moe["calls"]["sort"] == 0, moe
        assert moe["drops"]["a2a"] > 0, moe
    mesh = np.asarray(runs["jax"]["train"][arch]["losses"])
    one = np.asarray(runs["jax"]["one_device"][arch]["losses"])
    assert np.abs(one - mesh).min() > 100 * 1e-5 * np.abs(mesh).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_placements_after_steps_are_the_rules(runs, arch):
    """Every param keeps the rules' checked placements through the
    steps, and so do the optimizer's master, m and v: the experts over
    model and their d over data (FSDP), the router whole."""
    for r in runs["ranks"]:
        got = r["train"][arch]
        assert all(ok for ok, _ in got["placements"].values()), \
            {n: s for n, (ok, s) in got["placements"].items() if not ok}
        assert got["opt_placed"]
    specs = runs["ranks"][0]["train"][arch]["placements"]
    moe = "stage1.moe."
    assert specs[moe + "w_gate"][1] == {1: ("model",), 2: ("data",)}
    assert specs[moe + "w_up"][1] == {1: ("model",), 2: ("data",)}
    assert specs[moe + "w_down"][1] == {1: ("model",), 3: ("data",)}
    assert specs[moe + "router"][1] == {}
    if arch == "deepseek-moe-16b":
        assert specs[moe + "shared.w_gate"][1] == {1: ("data",),
                                                   2: ("model",)}
        assert specs["stage0.mlp.w_down"][1] == {1: ("model",),
                                                 2: ("data",)}


@pytest.mark.parametrize("arch", ARCHS)
def test_partitioned_moe_prefill_and_decode_match_jax(runs, arch):
    """A [2, 32] prefill (the a2a path) and 3 decode steps (the global
    sort: one token a row) under ``serve_rules``: every rank's logits
    within the families test's tolerance of the JAX ``api.forward``
    under the same mesh."""
    want = runs["jax"]["serve"][arch]["logits"]
    for r in runs["ranks"]:
        got = r["serve"][arch]
        prefill, decode = got["forms"]
        assert prefill["calls"] == {"a2a": 2 if arch == "olmoe-1b-7b"
                                    else 1, "sort": 0}
        assert decode["calls"] == {"a2a": 0, "sort": DECODE * (
            2 if arch == "olmoe-1b-7b" else 1)}
        assert len(got["logits"]) == len(want) == DECODE + 1
        for i, (g, w) in enumerate(zip(got["logits"], want)):
            np.testing.assert_allclose(g, w, err_msg=f"{arch} step {i}",
                                       **TOL)


@pytest.mark.parametrize("case", [c[0] for c in _cell_cases()])
def test_fake_world_walk_charges_the_gloo_moe_collectives(runs, case):
    """The meta walk under ``fake_world((2, 4))`` charges the collectives
    the gloo ranks issue, by kind: the count CommDebugMode records on
    every rank and the wire bytes a device op_cost reads there; the a2a
    path's all-to-alls among them (train, prefill), none in decode's
    sort."""
    fake = runs["launcher"]["fake"][case]
    assert fake["partitioned"]
    assert ("all-to-all" in fake["counts"]) == (case != "olmoe_decode")
    for r in runs["ranks"]:
        w = r["walks"][case]
        assert w["comm_debug"] == {k: int(v) for k, v in
                                   fake["counts"].items()}
        assert w["counts"] == fake["counts"]
        assert w["wire"] == fake["wire"]


def test_the_a2a_exchanges_are_charged_at_their_local_sizes(runs):
    """Reduced olmoe's train cell (2 layers, [4, 32] in microbatches of
    2, remat full): a rank's block is 1 row x 8 tokens, so its buffer is
    [8 experts, C 8, 128] fp32; six all-to-alls a layer a microbatch
    (dispatch and return, forward, remat recompute and backward), each
    sending 3/4 of its buffer over the 4 model ranks."""
    fake = runs["launcher"]["fake"]["olmoe_train"]
    cfg = _cfg("olmoe-1b-7b")
    E, d = cfg.moe.num_experts, cfg.d_model
    buf = E * 8 * d * 4
    n = 6 * cfg.num_layers * 2
    assert fake["counts"]["all-to-all"] == n
    assert fake["wire"]["all-to-all"] == n * buf * (MODEL - 1) / MODEL


def test_moe_dry_run_records_are_partitioned_with_the_a2a(tmp_path):
    """The dry run's olmoe ``prefill_32k`` cell on the 256-rank fake
    world: a partitioned record whose per-device collectives hold the
    a2a's exchanges (two a layer, 16 layers) beside the two all-to-alls
    DTensor moves the k / v caches to ``kv_seq`` with on a CUDA world,
    and the FSDP gathers."""
    from repro_torch.launch import dryrun
    (rec,) = dryrun.run_target("olmoe-1b-7b", "prefill_32k", ("single",),
                               str(tmp_path))
    assert rec["status"] == "ok" and rec["partitioned"] is True
    per = rec["per_device"]
    assert per["collectives_by_kind"]["all-to-all"] == 2 * 16 + 2
    assert per["wire_bytes_by_kind"]["all-to-all"] > 0
    assert per["wire_bytes_by_kind"]["all-gather"] > 0
    assert rec["roofline"]["per_device"] is True
