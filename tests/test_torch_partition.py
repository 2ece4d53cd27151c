"""The partitioned step (DTensor: FSDP over ``data``, tensor parallelism
over ``model``) against the JAX package, on the CPU.

One run of 8 gloo ranks as a (data 2, model 4) mesh, each forked from
one launcher that imported torch once (``OMP_NUM_THREADS=1``), beside
one JAX process on one host device; every input comes from a numpy
seed and reaches each process through one pickle.  The ranks train
reduced fp32 h2o-danube-1.8b (2 kv heads on the 4-way axis: k / v stay
whole and each rank reads the kv head its q heads need) and reduced
phi3-mini-3.8b (every axis divides) and reduced qwen2.5-32b (danube's
heads, with q / k / v biases: DTensor's backward leaves a bias grad a
partial sum over the batch ranks) for 2 steps from the JAX package's
weights (``bridge.from_numpy(..., mesh=)``), run a [2, 32] prefill and
3 decode steps of reduced phi3 and internvl2-76b into caches whose
sequence is sharded over ``model``, count each rank's local bytes of
three cells, and walk those cells under ``op_cost`` and
``CommDebugMode``.  The launcher then walks the same cells on ``meta``
under ``fake_world((2, 4))``.

Tolerances: the train steps as ``tests/test_torch_distributed.py``
holds the ``--mesh`` step (losses 1e-5 relative, params 2e-5 absolute,
at lr 3e-5: fp32 sums in other orders, the tensor-parallel partial
sums among them); the logits
as ``tests/test_torch_families.py`` holds the forward (1e-4).
Placements, bytes and collectives are exact.
"""
import math
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
TRAIN_ARCHS = ("h2o-danube-1.8b", "phi3-mini-3.8b", "qwen2.5-32b")
SERVE_ARCHS = ("phi3-mini-3.8b", "internvl2-76b")
STEPS, B, S, MB = 2, 4, 32, 2          # train: 2 microbatches of 2 rows
PB, CTX, DECODE, GROW = 2, 32, 3, 36   # prefill [2, 32], 3 decode steps
LR = 3e-5
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
    cells."""
    return (("phi3_train", "phi3-mini-3.8b", "train", 16, 4, 2),
            ("danube_train", "h2o-danube-1.8b", "train", 16, 4, 2),
            ("phi3_prefill", "phi3-mini-3.8b", "prefill", 16, 2, None),
            ("phi3_decode", "phi3-mini-3.8b", "decode", 16, 2, None))


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


def _local_bytes(tree):
    from repro_torch.launch import cells
    from torch.utils import _pytree as pytree
    total = 0
    for t in pytree.tree_leaves(cells._struct(tree)):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if hasattr(t, "to_local") else t
            total += loc.numel() * loc.element_size()
    return total


def _coll_kinds(counts):
    """CommDebugMode's {op: count} -> {collective kind: count}."""
    from repro_torch.roofline.op_cost import COLLECTIVES
    out = {}
    for op, n in counts.items():
        kind = COLLECTIVES[str(op).split(".")[-1]][0]
        out[kind] = out.get(kind, 0) + n
    return out


def _walks(mesh, device):
    """Each walked cell: op_cost's collectives (kind: count, wire bytes)
    and product FLOPs (the walk counts one microbatch, scaled); on a
    real world also the counts CommDebugMode records over a whole step
    and the rank's local argument bytes against the cell's."""
    from torch.distributed.tensor.debug import CommDebugMode
    out = {}
    for case in _cell_cases():
        cell = _cell(case, mesh, device)
        rec = {}
        if device != "meta":
            rec["local_bytes"] = _local_bytes(cell.args)
            rec["arg_bytes"] = cell.arg_bytes_per_device()
            with CommDebugMode() as cdm:
                cell.run()
            rec["comm_debug"] = _coll_kinds(cdm.get_comm_counts())
        cost, _ = cell.walk()
        rec.update(counts=dict(cost.coll_op_counts),
                   wire=dict(cost.coll_op_bytes),
                   product_flops=cost.product_flops,
                   partitioned=cell.partitioned)
        out[case[0]] = rec
    return out


def _mqa_flash(mesh):
    """Flash on placed q heads over one whole kv head (MQA): every q
    rank reads the same kv head, so its dK / dV are partial sums over
    the model ranks.  The output and the gathered grads against the
    plain attention on whole tensors (max abs errors)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator().manual_seed(1)
    q, k, v, w = (torch.randn(shape, generator=g) for shape in
                  ((2, 8, MODEL, 8), (2, 8, 1, 8), (2, 8, 1, 8),
                   (2, 8, MODEL, 8)))
    whole = [t.clone().requires_grad_() for t in (q, k, v)]
    (attention_ref(*whole, causal=True) * w).sum().backward()
    rep = [Replicate(), Replicate()]
    placed = [distribute_tensor(t, mesh, pl).requires_grad_() for t, pl in
              ((q, [Replicate(), Shard(2)]), (k, rep), (v, rep))]
    out = flash_attention(*placed, causal=True)
    (out.full_tensor() * w).sum().backward()
    errs = {"out": float((out.full_tensor()
                          - attention_ref(q, k, v, causal=True)).abs().max())}
    for name, p, t in zip("qkv", placed, whole):
        errs["d" + name] = float((p.grad.full_tensor() - t.grad).abs().max())
    return errs


def _rank_main(rank, tmp):
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import api
    from repro_torch.training import loop as tl
    from repro_torch.training import optimizer as opt_mod
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg.store",
                            rank=rank, world_size=DATA * MODEL)
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        mesh = mesh_mod.make_test_mesh(DATA, MODEL)
        rules = shd.train_rules(mesh)
        out = {"coord": mesh.get_coordinate(), "train": {}, "serve": {}}
        for arch in TRAIN_ARCHS:
            cfg = _cfg(arch)
            params = bridge.from_numpy(inp["params"][arch], cfg,
                                       device="cpu", mesh=mesh, rules=rules)
            state = tl.init_train_state(cfg, _tc(), params=params)
            state = tl.place_state(state, mesh, rules)
            step = tl.make_train_step(cfg, _tc())
            losses, norms, layouts = [], [], []
            slices = opt_mod.slices

            def spy(*ts):
                # every tensor the accumulation and the update slice
                # (grads, accumulators, master, m, v, params) is placed,
                # all alike: no partial grad is read as a shard
                layouts.append(all(hasattr(t, "placements") for t in ts)
                               and len({tuple(t.placements)
                                        for t in ts}) == 1)
                return slices(*ts)
            opt_mod.slices = spy
            try:
                with shd.axis_rules(mesh, rules):
                    for t in range(STEPS):
                        batch = {k: torch.from_numpy(v) for k, v in
                                 inp["batches"][arch][t].items()}
                        state, met = step(state, batch)
                        losses.append(float(met["loss"]))
                        norms.append(float(met["grad_norm"]))
            finally:
                opt_mod.slices = slices
            want = shd.tree_shardings_checked(
                api.param_specs(cfg), dict(state.params.named_parameters()),
                mesh, rules)
            out["train"][arch] = {
                "losses": losses, "grad_norms": norms, "layouts": layouts,
                "params": bridge.to_numpy(state.params),
                "placements": {n: (tuple(p.placements) == want[n],
                                   _specs(p.placements, mesh))
                               for n, p in state.params.named_parameters()},
                "opt_placed": all(
                    tuple(t.placements) == tuple(p.placements)
                    for f in (state.opt.master, state.opt.m, state.opt.v)
                    for (n, p), t in zip(state.params.named_parameters(),
                                         f.values()))}
        for arch in SERVE_ARCHS:
            cfg = _cfg(arch)
            params = bridge.from_numpy(inp["params"][arch], cfg,
                                       device="cpu", mesh=mesh, rules=rules)
            batch = {k: torch.from_numpy(v)
                     for k, v in inp["prompts"][arch].items()}
            logits = []
            with shd.axis_rules(mesh, rules):
                lg, _, caches = api.forward(params, batch, cfg,
                                            mode="prefill")
                logits.append(lg.full_tensor().numpy())
                caches = api.grow_caches(cfg, caches, GROW)
                seq = _specs(caches["stage1"]["k"].placements, mesh)
                for tok in inp["decode_tokens"][arch]:
                    lg, _, caches = api.forward(
                        params, {"tokens": torch.from_numpy(tok)}, cfg,
                        mode="decode", caches=caches)
                    logits.append(lg.full_tensor().numpy())
            out["serve"][arch] = {"logits": logits, "cache_specs": seq}
        out["mqa"] = _mqa_flash(mesh)
        out["walks"] = _walks(mesh, "cpu")
        with open(os.path.join(tmp, f"rank_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _launch_all(tmp):
    """Every rank forked from this process (one thread, so a fork copies
    no thread's state); then, with no world left, the same cells walked
    on meta under a fake world of (2, 4) and unpartitioned."""
    import multiprocessing as mp

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.mesh import production_mesh_shape
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
        try:
            mesh_mod.fake_world((1,), ("data",)).__enter__()
            second = "no error"
        except RuntimeError as e:
            second = str(e)
    with mesh_mod.fake_world((DATA, MODEL), ("data", "model")) as mesh:
        cost, _ = _cell(_cell_cases()[2], mesh, "meta").walk()
    whole = _cell(_cell_cases()[0], production_mesh_shape(), "meta")
    with open(os.path.join(tmp, "launcher.pkl"), "wb") as f:
        pickle.dump({"fake": fake, "second_world": second,
                     "cuda_prefill": dict(cost.coll_op_counts),
                     "whole_product_flops": whole.walk()[0].product_flops,
                     "whole_partitioned": whole.partitioned}, f)


# ---------------------------------------------------------------------------
# the JAX side (one subprocess, one host device)
# ---------------------------------------------------------------------------

JAX_SCRIPT = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import TrainConfig, reduced_config
    from repro.models import api
    from repro.training import loop as tl, optimizer as opt
    tmp = sys.argv[1]
    inp = pickle.load(open(tmp + "/inputs.pkl", "rb"))
    out = {"train": {}, "serve": {}}
    for arch in %(train)r:
        cfg = reduced_config(arch).replace(num_layers=2, dtype="float32")
        tc = TrainConfig(learning_rate=%(lr)r, total_steps=3,
                         warmup_steps=1, microbatch=%(mb)d)
        params = jax.tree.map(jnp.asarray, inp["params"][arch])
        st = tl.TrainState(params=params, opt=opt.init_opt_state(params),
                           err=None)
        step = jax.jit(tl.make_train_step(cfg, tc))
        losses, norms = [], []
        for b in inp["batches"][arch]:
            st, met = step(st, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        out["train"][arch] = {"losses": losses, "grad_norms": norms,
                              "params": jax.tree.map(np.asarray, st.params)}
    for arch in %(serve)r:
        cfg = reduced_config(arch).replace(num_layers=2, dtype="float32")
        tree = jax.tree.map(jnp.asarray, inp["params"][arch])
        batch = {k: jnp.asarray(v) for k, v in inp["prompts"][arch].items()}
        lg, _, c = api.forward(tree, batch, cfg, mode="prefill")
        logits = [np.asarray(lg)]
        c = api.grow_caches(cfg, c, %(grow)d)
        for tok in inp["decode_tokens"][arch]:
            lg, _, c = api.forward(tree, {"tokens": jnp.asarray(tok)}, cfg,
                                   mode="decode", caches=c)
            logits.append(np.asarray(lg))
        out["serve"][arch] = {"logits": logits}
    pickle.dump(out, open(tmp + "/jax.pkl", "wb"))
""") % {"train": TRAIN_ARCHS, "serve": SERVE_ARCHS, "lr": LR, "mb": MB,
        "grow": GROW}


def _inputs():
    """The JAX package's weights (seed 0), the train batches and the
    prompts from numpy seeds; the decode tokens are the prompts'
    continuations drawn from a seed (the same for both packages)."""
    import jax

    from repro.configs import reduced_config as jax_reduced
    from repro.models import api as japi
    rng = np.random.default_rng(0)
    archs = sorted(set(TRAIN_ARCHS) | set(SERVE_ARCHS))
    params, batches, prompts, toks = {}, {}, {}, {}
    for arch in archs:
        jcfg = jax_reduced(arch).replace(num_layers=2, dtype="float32")
        params[arch] = jax.tree.map(np.asarray, japi.build_params(
            jax.random.PRNGKey(0), jcfg))
        V = jcfg.vocab_size
        batches[arch] = [{k: rng.integers(0, V, (B, S)).astype(np.int32)
                          for k in ("tokens", "labels")}
                         for _ in range(STEPS)]
        P = jcfg.num_patch_tokens if jcfg.family == "vlm" else 0
        prompts[arch] = {"tokens": rng.integers(0, V, (PB, CTX - P)
                                                ).astype(np.int32)}
        if P:
            prompts[arch]["patch_embeds"] = rng.standard_normal(
                (PB, P, jcfg.d_model)).astype(np.float32)
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
    tmp = str(tmp_path_factory.mktemp("partition"))
    inp = _inputs()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    launch = f"import sys; sys.path[:0] = [{TESTS!r}, {SRC!r}]; " \
        f"import test_torch_partition as t; t._launch_all({tmp!r})"
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", *args], env=_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, args in (("jax", [JAX_SCRIPT, tmp]),
                           ("torch", [launch]))}
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

@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_partitioned_train_steps_match_jax(runs, arch):
    """2 steps on (data 2, model 4): the losses and the grad norms within
    1e-5 of the JAX trainer's on one device, every param within 2e-5,
    the same on every rank (gathered whole).  AdamW's update does not
    see a grad scaled by a constant (a grad reduced twice): the norm
    does, and the grads reach the optimizer placed like their params."""
    want = runs["jax"]["train"][arch]
    w = dict(_flat(want["params"]))
    for r in runs["ranks"]:
        got = r["train"][arch]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                                   rtol=1e-5)
        assert got["layouts"] and all(got["layouts"])
        g = dict(_flat(got["params"]))
        assert g.keys() == w.keys()
        for name in w:
            np.testing.assert_allclose(g[name], w[name], atol=2e-5, rtol=0,
                                       err_msg=f"{arch} {name}")


def test_flash_on_one_kv_head_sums_its_partial_grads(runs):
    """MQA: q heads sharded over model, the one kv head whole; every
    rank's output and gathered dQ / dK / dV equal the plain attention's
    on whole tensors (fp32; the sums in another order)."""
    for r in runs["ranks"]:
        assert max(r["mqa"].values()) <= 1e-5, r["mqa"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_placements_after_steps_are_the_rules(runs, arch):
    """Every param keeps the rules' checked placements through the
    steps, and so do the optimizer's master, m and v."""
    for r in runs["ranks"]:
        got = r["train"][arch]
        assert all(ok for ok, _ in got["placements"].values()), \
            {n: s for n, (ok, s) in got["placements"].items() if not ok}
        assert got["opt_placed"]
    specs = runs["ranks"][0]["train"][arch]["placements"]
    # FSDP and tensor parallelism: d over data, the heads' columns and
    # the MLP's hidden width over model, the vocab over model
    assert specs["stage1.mlp.w_gate"][1] == {1: ("data",), 2: ("model",)}
    assert specs["stage1.mlp.w_down"][1] == {1: ("model",), 2: ("data",)}
    assert specs["embed"][1] == {0: ("model",), 1: ("data",)}
    assert specs["stage1.attn.wk"][1] == {1: ("data",), 2: ("model",)}


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_partitioned_prefill_and_decode_match_jax(runs, arch):
    """A [2, 32] prefill and 3 decode steps into caches grown to 36
    slots, their sequence sharded over model (context-parallel decode):
    every rank's logits within the families test's tolerance of the
    JAX ``api.forward``."""
    want = runs["jax"]["serve"][arch]["logits"]
    for r in runs["ranks"]:
        got = r["serve"][arch]
        assert got["cache_specs"] == {1: ("data",), 2: ("model",)}
        assert len(got["logits"]) == len(want) == DECODE + 1
        for i, (g, w) in enumerate(zip(got["logits"], want)):
            np.testing.assert_allclose(g, w, err_msg=f"{arch} step {i}",
                                       **TOL)


@pytest.mark.parametrize("case", [c[0] for c in _cell_cases()])
def test_local_bytes_equal_the_cells_argument_bytes(runs, case):
    """Each rank holds exactly ``arg_bytes_per_device`` of the placed
    cell's arguments."""
    for r in runs["ranks"]:
        w = r["walks"][case]
        assert w["partitioned"]
        assert w["local_bytes"] == w["arg_bytes"]


@pytest.mark.parametrize("case", [c[0] for c in _cell_cases()])
def test_fake_world_walk_charges_the_gloo_runs_collectives(runs, case):
    """The meta walk under ``fake_world((2, 4))`` charges the collectives
    the gloo ranks issue: by kind, the count CommDebugMode records on
    every rank and the wire bytes a device op_cost reads there."""
    fake = runs["launcher"]["fake"][case]
    assert fake["counts"], "no collective charged"
    for r in runs["ranks"]:
        w = r["walks"][case]
        assert w["comm_debug"] == {k: int(v) for k, v in
                                   fake["counts"].items()}
        assert w["counts"] == fake["counts"]
        assert w["wire"] == fake["wire"]


def test_per_device_product_flops_are_an_eighth_of_the_whole_step(runs):
    """Reduced phi3's train cell: every product is split 8 ways (batch
    over data, columns or rows over model), so the per-device product
    FLOPs times 8 equal the unpartitioned walk's exactly."""
    launcher = runs["launcher"]
    assert not launcher["whole_partitioned"]
    per_dev = launcher["fake"]["phi3_train"]["product_flops"]
    assert per_dev > 0
    assert per_dev * DATA * MODEL == launcher["whole_product_flops"]


def test_a_cuda_world_moves_shards_by_all_to_all(runs):
    """On a world of CUDA devices (the dry run's) the prefill's caches
    go from head-sharded to sequence-sharded by DTensor's all-to-all,
    where gloo's CPU world all-gathers them."""
    cuda = runs["launcher"]["cuda_prefill"]
    cpu = runs["launcher"]["fake"]["phi3_prefill"]["counts"]
    assert cuda.get("all-to-all", 0) > 0 and "all-to-all" not in cpu
    assert cpu["all-gather"] - cuda.get("all-gather", 0) == \
        cuda["all-to-all"]


def test_a_process_holds_one_world(runs):
    assert "a fake process group is running" in \
        runs["launcher"]["second_world"]


def test_make_train_step_refuses_whole_replicas_on_a_model_axis():
    """Placed parameters train on a model axis of 4 (above); whole
    replicas still raise there (a fake world of (1, 2) in this
    process)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.training import loop as tl
    cfg = _cfg("phi3-mini-3.8b")
    state = tl.init_train_state(cfg, _tc(), device="meta")
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    with mesh_mod.fake_world((1, 2), ("data", "model")) as mesh:
        with shd.axis_rules(mesh, shd.train_rules(mesh)):
            with pytest.raises(NotImplementedError, match="model axis"):
                tl.make_train_step(cfg, _tc())(state, batch)
        with pytest.raises(RuntimeError, match="fake process group"):
            mesh_mod.init_world("cpu")


def test_fake_world_meshes_of_the_production_sizes():
    """The dry run's fake worlds: 256 ranks as (16, 16) and 512 as
    (2, 16, 16); each ends with its block."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    for shape, names in (((16, 16), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model"))):
        with mesh_mod.fake_world(shape, names) as mesh:
            assert tuple(mesh.shape) == shape
            assert mesh.mesh_dim_names == names
            assert dist.get_world_size() == math.prod(shape)
        assert not dist.is_initialized()


def test_init_caches_places_by_the_cache_rules():
    """``init_caches(mesh=)``: k / v sharded by batch over data and by
    the sequence over model (context-parallel decode), len whole."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import api
    cfg = _cfg("phi3-mini-3.8b")
    with mesh_mod.fake_world((DATA, MODEL), ("data", "model"),
                             device_type="cpu") as mesh:
        caches = api.init_caches(cfg, 2, GROW, device="meta", mesh=mesh)
        k = caches["stage1"]["k"]
        assert _specs(k.placements, mesh) == {1: ("data",), 2: ("model",)}
        assert k.to_local().shape[1:3] == (1, GROW // MODEL)
        assert not hasattr(caches["len"], "placements")


def test_constrain_and_place_outside_a_mesh_are_identities():
    """Without rules (or on a plain tensor) ``constrain`` returns its
    input, as the JAX package does without a mesh."""
    from repro_torch.distributed import sharding as shd
    x = torch.ones(2, 3)
    assert shd.constrain(x, ("batch", None)) is x
    assert shd.gather_fsdp(x) is x
    assert shd.replicate_dim(x, -1) is x


def test_xlstm_dry_run_records_are_partitioned(tmp_path):
    """The last family to be partitioned: xlstm's decode_32k record is
    one device's share of the placed step on the 256-rank fake world,
    not the whole step divided by the chips, with the FSDP gathers and
    the mLSTM's reductions over ``model`` it issues."""
    from repro_torch.launch import dryrun
    (rec,) = dryrun.run_target("xlstm-125m", "decode_32k", ("single",),
                               str(tmp_path))
    assert rec["status"] == "ok" and rec["partitioned"] is True
    assert rec["roofline"]["per_device"] is True
    assert rec["per_device"]["flops"] == rec["cost"]["flops"]
    assert rec["per_device"]["flops"] != pytest.approx(
        rec["cost"]["flops"] / 256, rel=1e-3)
    assert rec["roofline"]["collective_s"] > 0.0
    kinds = rec["per_device"]["collectives_by_kind"]
    assert kinds["all-gather"] > 0 and kinds["all-reduce"] > 0


def test_placed_microbatch_widens_to_the_batch_ranks():
    from repro_torch.training.loop import placed_microbatch
    assert placed_microbatch(256, 16, 32) == 32      # qwen on two pods
    assert placed_microbatch(256, 32, 16) == 32
    assert placed_microbatch(8, None, 2) == 8
    assert placed_microbatch(8, 3, 2) == 8           # does not divide
