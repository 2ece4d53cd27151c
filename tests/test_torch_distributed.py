"""The port's distributed layer against the JAX package, on the CPU.

Multi-rank semantics run over ``torch.distributed``'s gloo backend,
one process a rank, each forked from one launcher that imported torch
once: a world of 8 (``compressed_psum``, ``grid_spawn``, ``barrier``),
a world of 4 (``ring_all_gather`` and ``overlapped_matmul`` on a line
of 4, the expert-parallel a2a MoE dispatch, the dispatch choice,
``reshard_like`` and the sharding rules on a 2x2 (data, model) mesh)
and a world of 2 running the train CLI's ``--mesh`` on reduced fp32
phi3, then olmoe (2 layers each).  The JAX side runs in one subprocess
with 8 forced host devices (``tests/test_multidevice.py`` does the
same), started beside them; it also runs the JAX trainer on one device
from the port's initial weights.  Every input comes from a numpy seed
and reaches each process through one pickle this test writes.

Tolerances: ``compressed_psum`` 1e-6 relative to the JAX ring (equal
bits expected: the same int8 terms added in the same order) and 0.15
of the exact sum (``tests/test_multidevice.py``); the ring, the
overlapped product and ``grid_spawn`` 1e-6 (ints: equal); the a2a
against the JAX sort path 5e-4 in y and 1e-5 in aux
(``tests/test_multidevice.py``), its grads 1e-5 of each grad's largest
entry (fp32 sums in other orders); the trainer as
``test_torch_training.py::test_train_step_matches_jax`` holds one step:
losses 1e-5 relative, params 2e-5 absolute, at lr 3e-5 (the card's
train phase's; at the CLI's default 3e-4, three steps of Adam, whose
g / (|g| + eps) amplifies the rounding of a grad near 0, left one
weight of a 4-layer olmoe 2.8e-5 from the JAX run); params across
ranks equal.
"""
import os
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
N_SPAWN, IPS = 103, 4
CLI_ARCHS = ("phi3-mini-3.8b", "olmoe-1b-7b")
CLI_ARGS = ["--reduced", "--device", "cpu", "--steps", "3", "--seq", "32",
            "--lr", "3e-5",
            "--batch", "4", "--microbatch", "2", "--log-every", "1"]
TIMEOUT = 300


# ---------------------------------------------------------------------------
# inputs, all from numpy seeds
# ---------------------------------------------------------------------------

def _moe_cfgs():
    import dataclasses

    from repro_torch.configs import reduced_config
    cfg = reduced_config("olmoe-1b-7b").replace(num_layers=1,
                                                dtype="float32")
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _cli_cfg(arch):
    from repro_torch.configs import reduced_config
    return reduced_config(arch).replace(num_layers=2, dtype="float32")


def _inputs():
    from repro_torch import bridge
    from repro_torch.models import api
    rng = np.random.default_rng(0)
    cfg = _moe_cfgs()
    d, m = cfg.d_model, cfg.moe
    E, ff = m.num_experts, m.d_ff
    f32 = np.float32
    moe_p = {
        "router": rng.standard_normal((d, E), f32) / d ** 0.5,
        "w_gate": rng.standard_normal((E, d, ff), f32) / d ** 0.5,
        "w_up": rng.standard_normal((E, d, ff), f32) / d ** 0.5,
        "w_down": rng.standard_normal((E, ff, d), f32) / ff ** 0.5}
    # the train CLI's initial weights: seed 0 on the CPU
    cli_params = {
        arch: bridge.to_numpy(api.build_params(
            _cli_cfg(arch), torch.Generator().manual_seed(0), device="cpu"))
        for arch in CLI_ARCHS}
    logical = {"w": ("embed", "mlp"), "b": ("vocab",),
               "odd": ("batch", "kv_seq"), "e": ("experts", "embed", None),
               "x": ("batch", None), "r": None, "frames": (None, "kv_seq")}
    host = {"w": rng.standard_normal((8, 6), f32),
            "b": rng.standard_normal((5,), f32),
            "odd": rng.standard_normal((3, 6), f32),
            "e": rng.standard_normal((4, 6, 3), f32),
            "x": rng.standard_normal((4, 2), f32),
            "r": rng.standard_normal((2, 2), f32),
            "frames": rng.standard_normal((2, 1500), f32)}
    return {
        "psum_x": rng.standard_normal((8, 64), f32),
        "ring_x": rng.standard_normal((8, 3), f32),
        "om_x": rng.standard_normal((2, 8), f32),
        "om_w": rng.standard_normal((8, 5), f32),
        "moe_p": moe_p,
        "moe_x": rng.standard_normal((4, 8, d), f32),
        "moe_g": rng.standard_normal((4, 8, d), f32),
        "cli_params": cli_params,
        "logical": logical, "host": host}


# ---------------------------------------------------------------------------
# the torch ranks (run in subprocesses: ``python -c`` imports this file)
# ---------------------------------------------------------------------------

def _specs_of(placements, mesh):
    """Placements -> a JAX-style spec: per tensor dim, the tuple of mesh
    axes that shard it, in mesh order."""
    from torch.distributed.tensor import Shard
    spec = {}
    for axis, pl in zip(mesh.mesh_dim_names, placements):
        if isinstance(pl, Shard):
            spec.setdefault(pl.dim, []).append(axis)
    return {dim: tuple(axes) for dim, axes in spec.items()}


def _world8(rank, inp):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.combinators import barrier
    from repro_torch.core.spawn import grid_spawn
    from repro_torch.distributed.compression import compressed_psum
    mesh = DeviceMesh("cpu", torch.arange(8), mesh_dim_names=("data",))
    x = torch.from_numpy(inp["psum_x"][rank:rank + 1])
    launcher = grid_spawn(
        lambda c, g, v: c + torch.where(v, g + 1, 0).sum(), N_SPAWN,
        mesh=mesh, axis_names=("data",), items_per_step=IPS,
        init=torch.tensor(0))
    tree = {"x": x, "n": torch.arange(3, dtype=torch.int32)}
    return {"psum": compressed_psum(x, "data", mesh=mesh).numpy(),
            "spawn": launcher().numpy(),
            "barrier": {k: v.numpy() for k, v in
                        barrier(tree, "data", mesh=mesh).items()},
            "barrier_x": barrier(x, "data", mesh=mesh).numpy()}


def _world4(rank, inp):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.combinators import barrier
    from repro_torch.distributed import collectives, elastic
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe, moe_a2a
    out = {}
    line = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("model",))
    out["ring"] = collectives.ring_all_gather(
        torch.from_numpy(inp["ring_x"][2 * rank:2 * rank + 2]), "model",
        mesh=line).numpy()
    out["om"] = collectives.overlapped_matmul(
        torch.from_numpy(inp["om_x"]),
        torch.from_numpy(inp["om_w"][2 * rank:2 * rank + 2]), "model",
        mesh=line).numpy()

    sq = mesh_mod.make_test_mesh(data=2, model=2)
    assert mesh_mod.make_test_mesh(data=4, model=2) is None
    i, j = sq.get_coordinate()
    out["coord"] = (i, j)
    x = torch.from_numpy(inp["psum_x"][rank:rank + 1])
    out["barriers"] = [barrier(x, a, mesh=sq).numpy()
                       for a in ("data", "model", ("data", "model"))]

    # the a2a dispatch on the rank's [B/2, S/2, d] block
    cfg = _moe_cfgs()
    p = {k: torch.from_numpy(v).requires_grad_()
         for k, v in inp["moe_p"].items()}
    rules = shd.train_rules(sq)
    xs, gs = inp["moe_x"], inp["moe_g"]
    B, S = xs.shape[:2]
    rows, cols = slice(i * B // 2, (i + 1) * B // 2), \
        slice(j * S // 2, (j + 1) * S // 2)
    blk = torch.from_numpy(xs[rows, cols].copy()).requires_grad_()
    with shd.axis_rules(sq, rules):
        assert moe_a2a.a2a_applicable(xs.shape)
        assert not moe_a2a.a2a_applicable((B, S - 1, xs.shape[2]))
        y, aux = moe_a2a.moe_forward_a2a(p, blk, cfg)
        # every rank's loss holds the (global) aux: a quarter each
        ((y * torch.from_numpy(gs[rows, cols].copy())).sum()
         + aux / 4).backward()
    out["a2a"] = {"y": y.detach().numpy(), "aux": aux.item(),
                  "dx": blk.grad.numpy(),
                  "dp": {k: v.grad.numpy() for k, v in p.items()}}
    # the dispatch choice in moe_forward, from the rank's rows
    xr = torch.from_numpy(xs[rows].copy())
    with torch.no_grad():
        with shd.axis_rules(sq, rules):
            ya, auxa = moe.moe_forward(p, xr, cfg)
        with shd.axis_rules(sq, {**rules, "moe_dispatch": "sort"}):
            assert not moe_a2a.a2a_applicable(xs.shape)
            ys, auxs = moe.moe_forward(p, xr, cfg)
    out["rows"] = {"a2a": (ya.numpy(), float(auxa)),
                   "sort": (ys.numpy(), float(auxs))}

    # reshard_like and the checked placements of the specs
    out["reshard"] = {
        k: v.to_local().numpy() for k, v in elastic.reshard_like(
            inp["host"], inp["logical"], sq).items()}
    structs = {k: torch.empty(v.shape, device="meta")
               for k, v in inp["host"].items()}
    out["placements"] = {
        k: _specs_of(v, sq) for k, v in shd.tree_shardings_checked(
            inp["logical"], structs, sq, rules).items()}
    out["unchecked"] = {
        k: _specs_of(v, sq) for k, v in shd.tree_shardings(
            inp["logical"], sq, rules).items()}
    return out


def _rank_main(scenario, rank, world, tmp):
    """One rank of a gloo world: run `scenario`, pickle its results."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp}/{scenario}"
                            ".store", rank=rank, world_size=world)
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        out = {"world8": _world8, "world4": _world4}[scenario](rank, inp)
        with open(os.path.join(tmp, f"{scenario}_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _cli_main(tmp):
    """One rank of the train CLI's --mesh, in the torchrun environment
    the launcher sets: reduced phi3, then olmoe, in fp32.  The world is
    started first, as ``--mesh`` would start it, so both runs share it."""
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as train_cli
    train_cli.reduced_config = lambda a: _cli_cfg(a)
    states, init = [], train_cli.tl.init_train_state
    # the step trains the state it is given in place: keep that object
    train_cli.tl.init_train_state = \
        lambda *a, **kw: states.append(init(*a, **kw)) or states[-1]
    _, started = mesh_mod.init_world("cpu")
    assert started and dist.get_world_size() == 2
    try:
        for arch in CLI_ARCHS:
            hist = []
            assert train_cli.main(["--arch", arch, "--mesh"] + CLI_ARGS,
                                  history=hist) == 0
            assert dist.is_initialized()       # main leaves it running
            with open(os.path.join(tmp, f"cli_{arch}_{dist.get_rank()}"
                                   ".pkl"), "wb") as f:
                pickle.dump({"history": hist,
                             "params": bridge.to_numpy(states[-1].params)},
                            f)
    finally:
        dist.destroy_process_group()


def _child(fn, args, env):
    os.environ.update(env)
    fn(*args)


def _launch_all(tmp):
    """Every rank of the three gloo worlds, forked from this process:
    it imported torch once and runs one thread (``OMP_NUM_THREADS=1``),
    so a fork copies no thread's state.  Exits non-zero if a rank
    failed or hung."""
    import multiprocessing as mp
    threads = len(os.listdir("/proc/self/task"))
    assert threads == 1, f"{threads} threads: a fork is not safe"
    port = str(_free_port())
    jobs = [(_rank_main, (w, r, n, tmp), {}) for w, n in (("world8", 8),
                                                         ("world4", 4))
            for r in range(n)]
    jobs += [(_cli_main, (tmp,), dict(
        RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
        MASTER_ADDR="127.0.0.1", MASTER_PORT=port)) for r in range(2)]
    ctx = mp.get_context("fork")
    procs = [ctx.Process(target=_child, args=job) for job in jobs]
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
    sys.exit(1 if any(codes) else 0)


# ---------------------------------------------------------------------------
# the JAX side (one subprocess, 8 forced host devices)
# ---------------------------------------------------------------------------

JAX_SCRIPT = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import TrainConfig, reduced_config
    from repro.configs.base import ShapeConfig
    from repro.core.spawn import grid_spawn
    from repro.data.pipeline import SyntheticLM
    from repro.distributed import collectives, sharding as shd
    from repro.distributed.compression import compressed_psum
    from repro.training import loop as tl, optimizer as opt
    tmp, archs = sys.argv[1], sys.argv[2].split(",")
    inp = pickle.load(open(tmp + "/inputs.pkl", "rb"))
    out = {}
    m8 = jax.make_mesh((8,), ("data",))
    out["psum"] = np.asarray(jax.jit(jax.shard_map(
        lambda x: compressed_psum(x, "data"), mesh=m8, in_specs=P("data"),
        out_specs=P("data"), check_vma=False))(inp["psum_x"]))
    out["spawn"] = np.asarray(grid_spawn(
        lambda c, g, v: c + jnp.where(v, g + 1, 0).sum(), %(n)d, mesh=m8,
        axis_names=("data",), items_per_step=%(ips)d,
        init=jnp.int32(0))(jnp.int32(0)))
    m4 = jax.make_mesh((4,), ("model",), devices=jax.devices()[:4])
    out["ring"] = np.asarray(jax.jit(jax.shard_map(
        lambda x: collectives.ring_all_gather(x, "model"), mesh=m4,
        in_specs=P("model"), out_specs=P("model"),
        check_vma=False))(inp["ring_x"]))
    out["om"] = np.asarray(jax.jit(jax.shard_map(
        lambda x, w: collectives.overlapped_matmul(x, w, "model"), mesh=m4,
        in_specs=(P(), P("model")), out_specs=P("model"),
        check_vma=False))(inp["om_x"], inp["om_w"]))
    sq = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    rules = shd.train_rules(sq)
    shard = shd.tree_shardings_checked(inp["logical"], inp["host"], sq, rules)
    out["specs"] = {k: tuple(v.spec) for k, v in shard.items()}
    out["unchecked"] = {k: tuple(v.spec) for k, v in
                        shd.tree_shardings(inp["logical"], sq, rules).items()}
    out["reshard"] = {}
    for k, v in inp["host"].items():
        arr = jax.device_put(v, shard[k])
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        out["reshard"][k] = {idx: by_dev[sq.devices[idx]]
                             for idx in np.ndindex(*sq.devices.shape)}
    out["train"] = {}
    for arch in archs:
        cfg = reduced_config(arch).replace(num_layers=2, dtype="float32")
        tc = TrainConfig(learning_rate=3e-5, total_steps=3, warmup_steps=1,
                         microbatch=2)
        params = jax.tree.map(jnp.asarray, inp["cli_params"][arch])
        st = tl.TrainState(params=params, opt=opt.init_opt_state(params),
                           err=None)
        step = jax.jit(tl.make_train_step(cfg, tc))
        src = SyntheticLM(cfg, ShapeConfig("cli", 32, 4, "train"), seed=0)
        losses = []
        for t in range(3):
            st, met = step(st, {k: jnp.asarray(v)
                                for k, v in src.batch(t).items()})
            losses.append(float(met["loss"]))
        out["train"][arch] = {"losses": losses, "params": jax.tree.map(
            np.asarray, st.params)}
    pickle.dump(out, open(tmp + "/jax.pkl", "wb"))
""") % {"n": N_SPAWN, "ips": IPS}


# ---------------------------------------------------------------------------
# the module fixture: every process started at once, then collected
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               **extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist"))
    inp = _inputs()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    launch = f"import sys; sys.path[:0] = [{TESTS!r}, {SRC!r}]; " \
        f"import test_torch_distributed as t; t._launch_all({tmp!r})"
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", *args], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, args, env in (
            ("jax", [JAX_SCRIPT, tmp, ",".join(CLI_ARCHS)], _env(
                XLA_FLAGS="--xla_force_host_platform_device_count=8")),
            ("torch", [launch], _env()))}
    logs = {}
    try:
        for name, p in procs.items():
            logs[name], _ = p.communicate(timeout=TIMEOUT)
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
    return {"inp": inp, "jax": load("jax"),
            "world8": [load(f"world8_{r}") for r in range(8)],
            "world4": [load(f"world4_{r}") for r in range(4)],
            "cli": {a: [load(f"cli_{a}_{r}") for r in range(2)]
                    for a in CLI_ARCHS},
            "logs": logs}


# ---------------------------------------------------------------------------
# collectives, compression, grid_spawn, barrier
# ---------------------------------------------------------------------------

def test_compressed_psum_matches_jax_ring_on_8_ranks(runs):
    got = np.concatenate([r["psum"] for r in runs["world8"]])
    want = runs["jax"]["psum"]
    exact = runs["inp"]["psum_x"].sum(0, keepdims=True)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * scale
    assert np.abs(got - exact).max() / (np.abs(exact).max() + 1e-9) < 0.15


def test_grid_spawn_matches_jax_partials_on_8_ranks(runs):
    parts = [r["spawn"] for r in runs["world8"]]
    # every rank gathers all partials, in rank order
    assert all(np.array_equal(p, parts[0]) for p in parts)
    np.testing.assert_array_equal(parts[0], runs["jax"]["spawn"])
    assert int(parts[0].sum()) == N_SPAWN * (N_SPAWN + 1) // 2


def test_ring_all_gather_and_overlapped_matmul_match_jax(runs):
    ring = np.stack([r["ring"] for r in runs["world4"]])
    np.testing.assert_allclose(ring.reshape(-1, 3), runs["jax"]["ring"],
                               atol=1e-6, rtol=0)
    om = np.concatenate([r["om"] for r in runs["world4"]])
    np.testing.assert_allclose(om, runs["jax"]["om"], atol=1e-6, rtol=1e-6)
    inp = runs["inp"]
    np.testing.assert_allclose(om[:2], inp["om_x"] @ inp["om_w"],
                               atol=1e-5, rtol=1e-5)


def test_barrier_leaves_its_input_unchanged(runs):
    x = runs["inp"]["psum_x"]
    for rank, r in enumerate(runs["world8"]):
        np.testing.assert_array_equal(r["barrier_x"], x[rank:rank + 1])
        np.testing.assert_array_equal(r["barrier"]["x"], x[rank:rank + 1])
        np.testing.assert_array_equal(r["barrier"]["n"], np.arange(3))
        assert r["barrier"]["n"].dtype == np.int32
    for rank, r in enumerate(runs["world4"]):
        for b in r["barriers"]:
            np.testing.assert_array_equal(b, x[rank:rank + 1])


# ---------------------------------------------------------------------------
# the sharding rules and reshard_like on a 2x2 mesh
# ---------------------------------------------------------------------------

def _norm(spec):
    """A JAX spec tuple -> {dim: axes tuple} (None entries dropped)."""
    out = {}
    for dim, e in enumerate(spec):
        if e is None:
            continue
        out[dim] = tuple(e) if isinstance(e, tuple) else (e,)
    return out


def test_tree_shardings_give_jax_axis_assignments(runs):
    r0 = runs["world4"][0]
    for key in ("specs", "unchecked"):
        want = {k: _norm(v) for k, v in runs["jax"][key].items()}
        got = r0["placements" if key == "specs" else "unchecked"]
        assert got == want, key
    # the dims that do not divide by 2 stay whole when checked
    assert r0["placements"]["b"] == {} and r0["placements"]["odd"] == {1: (
        "model",)}
    assert r0["unchecked"]["b"] == {0: ("model",)}


def test_reshard_like_gives_each_rank_jax_device_slice(runs):
    for r in runs["world4"]:
        for k, shards in runs["jax"]["reshard"].items():
            np.testing.assert_array_equal(r["reshard"][k], shards[r["coord"]],
                                          err_msg=f"{k} at {r['coord']}")


def test_sharding_rules_and_specs_match_jax():
    from jax.sharding import PartitionSpec

    from repro.distributed import sharding as jshd
    from repro_torch.distributed import sharding as shd

    class Mesh:      # the rules read axis names and sizes only
        def __init__(self, names):
            self.mesh_dim_names = self.axis_names = names
            self.shape = dict.fromkeys(names, 1)
    for names in (("data", "model"), ("pod", "data", "model")):
        assert shd.train_rules(Mesh(names)) == jshd.train_rules(Mesh(names))
        for sb in (True, False):
            assert shd.serve_rules(Mesh(names), shard_batch=sb) == \
                jshd.serve_rules(Mesh(names), shard_batch=sb)
        rules = shd.train_rules(Mesh(names))
        for logical in (("batch", None, "embed"), ("experts", "embed", None),
                        (None, "vocab"), ("kv_seq", "kv_heads", "seq")):
            assert PartitionSpec(*shd.logical_to_spec(logical, rules)) == \
                jshd.logical_to_spec(logical, rules)
    assert shd.mesh_tp_degree(None) == 1
    x = torch.ones(2)
    assert shd.constrain(x, ("batch",)) is x
    assert shd.current_context() is None
    with shd.axis_rules(None):
        assert shd.current_context() is None


# ---------------------------------------------------------------------------
# the expert-parallel a2a MoE dispatch on a 2x2 mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sort_refs(runs):
    """The JAX sort path (one device, no mesh) and the port's, with
    their grads of sum(y * g) + aux in x and the weights."""
    import jax
    import jax.numpy as jnp

    from repro.configs import reduced_config as jax_reduced_config
    from repro.models import moe as jmoe
    from repro_torch.models import moe
    inp = runs["inp"]
    cfg = _moe_cfgs()
    jcfg = jax_reduced_config("olmoe-1b-7b").replace(
        num_layers=1, dtype="float32", moe=cfg.moe)
    g = jnp.asarray(inp["moe_g"])

    def jloss(p, x):
        y, aux = jmoe.moe_forward(p, x, jcfg)
        return jnp.sum(y * g) + aux, (y, aux)
    (_, (jy, jaux)), (jdp, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in inp["moe_p"].items()},
        jnp.asarray(inp["moe_x"]))
    p = {k: torch.from_numpy(v).requires_grad_()
         for k, v in inp["moe_p"].items()}
    x = torch.from_numpy(inp["moe_x"]).requires_grad_()
    y, aux = moe.moe_forward(p, x, cfg)
    ((y * torch.from_numpy(inp["moe_g"])).sum() + aux).backward()
    return {"jax": (np.asarray(jy), float(jaux), np.asarray(jdx),
                    {k: np.asarray(v) for k, v in jdp.items()}),
            "port": (y.detach().numpy(), aux.item(), x.grad.numpy(),
                     {k: v.grad.numpy() for k, v in p.items()})}


def _assembled(runs):
    B, S, d = runs["inp"]["moe_x"].shape
    y, dx = np.zeros((B, S, d), np.float32), np.zeros((B, S, d), np.float32)
    for r in runs["world4"]:
        i, j = r["coord"]
        rows = slice(i * B // 2, (i + 1) * B // 2)
        cols = slice(j * S // 2, (j + 1) * S // 2)
        y[rows, cols] = r["a2a"]["y"]
        dx[rows, cols] = r["a2a"]["dx"]
    dp = {k: sum(r["a2a"]["dp"][k] for r in runs["world4"])
          for k in runs["inp"]["moe_p"]}
    return y, dx, dp


@pytest.mark.parametrize("ref", ["jax", "port"])
def test_a2a_matches_the_sort_dispatch(runs, sort_refs, ref):
    """The a2a path on 2x2 gloo against the sort path of the JAX package
    and of the port, both on one device: y, aux (the same on every
    rank), the grads of x and the weights summed over the ranks."""
    wy, waux, wdx, wdp = sort_refs[ref]
    y, dx, dp = _assembled(runs)
    assert np.abs(y - wy).max() < 5e-4
    for r in runs["world4"]:
        assert abs(r["a2a"]["aux"] - waux) < 1e-5
    assert np.abs(dx - wdx).max() <= 1e-5 * np.abs(wdx).max()
    for k, w in wdp.items():
        assert np.abs(dp[k] - w).max() <= 1e-5 * np.abs(w).max(), k


def test_moe_forward_picks_a2a_or_gathered_sort_by_the_rules(runs,
                                                             sort_refs):
    """From the rank's rows under the mesh: the a2a path (model axis 2
    divides S) and, with the rules' sort knob, the sort path over the
    tokens gathered across the batch axis; both give the rank's rows of
    the one-device result and its global aux."""
    wy, waux = sort_refs["port"][:2]
    B = wy.shape[0]
    for r in runs["world4"]:
        i = r["coord"][0]
        for form in ("a2a", "sort"):
            y, aux = r["rows"][form]
            np.testing.assert_allclose(y, wy[i * B // 2:(i + 1) * B // 2],
                                       atol=1e-5, rtol=0, err_msg=form)
            assert abs(aux - waux) < 1e-6, form


# ---------------------------------------------------------------------------
# data-parallel --mesh training, 2 gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_mesh_training_matches_jax_trainer(runs, arch):
    """The train CLI's --mesh on 2 ranks (batch 4 in microbatches of 2:
    one row of each per rank) against the JAX trainer on one device from
    the same weights: 3 steps' losses and the final params; every
    parameter equal across the ranks."""
    want = runs["jax"]["train"][arch]
    ranks = runs["cli"][arch]
    for r in ranks:
        assert [h["step"] for h in r["history"]] == [1, 2, 3]
        np.testing.assert_allclose([h["loss"] for h in r["history"]],
                                   want["losses"], rtol=1e-5)
    from repro_torch import bridge
    a = dict(bridge._leaves(ranks[0]["params"]))
    b = dict(bridge._leaves(ranks[1]["params"]))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    for name, w in bridge._leaves(want["params"]):
        np.testing.assert_allclose(a[name], np.asarray(w, np.float32),
                                   atol=2e-5, rtol=0, err_msg=name)
    assert f"[train] {arch} (reduced)" in runs["logs"]["torch"]
    assert "mesh {'data': 2, 'model': 1} (gloo) rank 1" in \
        runs["logs"]["torch"]


# ---------------------------------------------------------------------------
# single-process pieces: the combinators, grid_spawn, the mesh helpers
# ---------------------------------------------------------------------------

def _jt():
    import jax.numpy as jnp
    return jnp


@pytest.mark.parametrize("case", ["divergent", "divergent_no_else",
                                  "uniform_true", "uniform_false",
                                  "uniform_no_else", "scalar_pred"])
def test_simt_cond_matches_jax(case):
    from repro.core.combinators import simt_cond as jcond
    from repro_torch.core.combinators import simt_cond
    jnp = _jt()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 3)).astype(np.float32)
    lanes = np.asarray([True, False, True, False])

    def args(mod, t):
        fn_t = (lambda v: {"a": v * 2.0, "b": v.sum(-1)})
        fn_e = (lambda v: {"a": v - 1.0, "b": v.max(-1)}) if mod is jnp \
            else (lambda v: {"a": v - 1.0, "b": v.max(-1).values})
        pred = {"divergent": lanes, "divergent_no_else": lanes,
                "uniform_true": lanes, "uniform_false": ~lanes & False,
                "uniform_no_else": np.zeros(4, bool),
                "scalar_pred": np.asarray(False)}[case]
        uniform = {"divergent": False, "divergent_no_else": False,
                   "scalar_pred": None}.get(case, True)
        else_fn = None if case.endswith("no_else") else fn_e
        return t(pred), fn_t, else_fn, t(x), uniform
    jp, jt_, je, jx, u = args(jnp, jnp.asarray)
    want = jcond(jp, jt_, je, jx, uniform=u)
    tp, tt, te, tx, u = args(torch, torch.from_numpy)
    got = simt_cond(tp, tt, te, tx, uniform=u)
    for k in ("a", "b"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_simt_cond_uniform_runs_one_path():
    from repro_torch.core.combinators import simt_cond
    ran = []

    def then_fn(v):
        ran.append("then")
        return v * 2

    def else_fn(v):
        ran.append("else")
        return v * 3
    x = torch.tensor([1.0, 2.0])
    assert simt_cond(torch.tensor(True), then_fn, else_fn, x).tolist() \
        == [2.0, 4.0]
    assert simt_cond(False, then_fn, else_fn, x).tolist() == [3.0, 6.0]
    assert ran == ["then", "else"]
    assert simt_cond(torch.tensor(False), then_fn, None, x).tolist() \
        == [0.0, 0.0]


@pytest.mark.parametrize("same_structure", [True, False])
def test_masked_call_matches_jax(same_structure):
    from repro.core.combinators import masked_call as jmasked
    from repro_torch.core.combinators import masked_call
    jnp = _jt()
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    mask = np.asarray([True, False, True])
    if same_structure:
        jf = tf = (lambda v: v * 5)
    else:
        jf = (lambda v: (v + 1, v.sum(-1)))
        tf = (lambda v: (v + 1, v.sum(-1)))
    want = jmasked(jnp.asarray(mask), jf, jnp.asarray(x))
    got = masked_call(torch.from_numpy(mask), tf, torch.from_numpy(x))
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,ips", [(37, 5), (103, 4), (1, 1), (16, 3)])
def test_grid_spawn_without_a_mesh_covers_the_grid(n, ips):
    from repro.core.spawn import grid_spawn as jspawn
    from repro.core.spawn import spawn_ranges as jranges
    from repro_torch.core.spawn import grid_spawn, spawn_ranges
    jnp = _jt()
    got = grid_spawn(lambda c, g, v: c + torch.where(v, g + 1, 0).sum(), n,
                     items_per_step=ips, init=torch.tensor(0))()
    want = jspawn(lambda c, g, v: c + jnp.where(v, g + 1, 0).sum(), n,
                  items_per_step=ips, init=jnp.int32(0))(jnp.int32(0))
    assert int(got) == int(want) == n * (n + 1) // 2
    for n_dev in (1, 3, 8):
        assert spawn_ranges(n, n_dev) == jranges(n, n_dev)


def test_init_world_and_meshes_in_one_process():
    """A world of one gloo rank: a 1x1 test mesh, the production mesh
    refused with the size it needs, the a2a path not applicable at ep 1,
    the group destroyed after; a CUDA request never becomes gloo."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe_a2a
    assert mesh_mod.make_test_mesh(1, 1) is None        # no world yet
    dev, started = mesh_mod.init_world("cpu")
    try:
        assert started and dev.type == "cpu" and dist.get_backend() == "gloo"
        assert mesh_mod.init_world("cpu") == (dev, False)
        mesh = mesh_mod.make_test_mesh(1, 1)
        assert tuple(mesh.shape) == (1, 1) and mesh_mod.mesh_chips(mesh) == 1
        assert mesh_mod.make_test_mesh(2, 1) is None
        with pytest.raises(RuntimeError, match="needs a world of 256"):
            mesh_mod.make_production_mesh()
        with pytest.raises(RuntimeError, match="needs a world of 512"):
            mesh_mod.make_production_mesh(multi_pod=True)
        assert shd.mesh_tp_degree(mesh) == 1
        with shd.axis_rules(mesh, shd.train_rules(mesh)):
            assert not moe_a2a.a2a_applicable((4, 8, 16))
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_mesh_on_cuda_needs_nccl(monkeypatch):
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs NCCL"):
        mesh_mod.init_world("cuda")
    assert not dist.is_initialized()
