"""The port's dry-run layer (``models/api.py``'s specs and counts,
``launch/cells.py``, ``launch/dryrun.py``) against the JAX package.

- ``param_specs`` of every architecture equals
  ``repro.models.api.param_specs`` leaf by leaf (the bridge's dotted
  paths); ``count_params_analytic`` (all and active) and
  ``model_flops`` match exactly for every applicable shape, and
  ``cache_logical_axes`` with and without ``kv_quant``.
- One subprocess forces 256 host devices before importing JAX (as the
  JAX dry run does) and builds every applicable JAX cell on the
  single-pod mesh without lowering it; each argument leaf's JAX shard
  shape equals the port's placement on ``production_mesh_shape()``, and
  the summed argument bytes a device are equal.
- The meta walk of a reduced phi3 prefill, a reduced olmoe decode and a
  reduced phi3 train step equals the CPU walk of the same cell; a train
  cell's sampled microbatch equals the whole loop; the xlstm cells' fit
  over the sequence length is exact.
- ``python -m repro_torch.launch.dryrun`` writes an ``ok`` record.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")

from repro_torch.configs import (ARCH_IDS, ShapeConfig,  # noqa: E402
                                 applicable_shapes, get_config,
                                 reduced_config)
from repro_torch.launch import cells  # noqa: E402
from repro_torch.launch.mesh import production_mesh_shape  # noqa: E402
from repro_torch.models import api  # noqa: E402

CELLS = [(a, s.name) for a in ARCH_IDS
         for s in applicable_shapes(get_config(a))]


def _flat(tree, prefix=()):
    """{dotted path: leaf} of nested dicts / (named) tuples, None
    leaves dropped, a tuple of placements kept whole."""
    out = {}
    if isinstance(tree, tuple) and tree and all(
            hasattr(p, "is_shard") for p in tree):
        out[".".join(prefix)] = tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            out.update(_flat(v, prefix + (f,)))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (str(i),)))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
    elif tree is not None:
        out[".".join(prefix)] = tree
    return out


def _dict_flat(tree, prefix=""):
    """{dotted path: value} of nested dicts (any other value a leaf)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dict_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _jax_flat(tree):
    import jax
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None or type(x) is tuple)[0]
    return {".".join(str(getattr(p, "key", p)) for p in path): v
            for path, v in leaves}


@pytest.fixture(scope="module")
def japi():
    pytest.importorskip("jax")
    from repro.configs import get_config as jget
    from repro.models import api as jax_api
    return jax_api, jget


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, japi):
    jax_api, jget = japi
    want = {k: tuple(v) for k, v in
            _jax_flat(jax_api.param_specs(jget(arch))).items()}
    assert api.param_specs(get_config(arch)) == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_match_jax(arch, japi):
    jax_api, jget = japi
    from repro.configs import SHAPES_BY_NAME as JSHAPES
    cfg, jcfg = get_config(arch), jget(arch)
    assert api.count_params_analytic(cfg) == \
        jax_api.count_params_analytic(jcfg)
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.param_count() == jcfg.param_count()
    for s in applicable_shapes(cfg):
        assert api.model_flops(cfg, s) == \
            jax_api.model_flops(jcfg, JSHAPES[s.name])
    assert [s.name for s in applicable_shapes(cfg)] == \
        [s.name for s in __import__("repro.configs", fromlist=["x"])
         .applicable_shapes(jcfg)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_logical_axes_match_jax(arch, japi):
    jax_api, jget = japi
    from repro.configs import SHAPES_BY_NAME as JSHAPES
    cfg = get_config(arch)
    for s in applicable_shapes(cfg):
        if s.kind != "decode":
            continue
        for kv_quant in (False, True):
            got = _dict_flat(api.cache_logical_axes(cfg, s,
                                                    kv_quant=kv_quant))
            want = _jax_flat(jax_api.cache_logical_axes(
                jget(arch), JSHAPES[s.name], kv_quant=kv_quant))
            assert got == want, (s.name, kv_quant)
            specs = _flat(api.cache_specs(cfg, s, kv_quant=kv_quant))
            assert all(t.device.type == "meta" for t in specs.values())


def test_production_mesh_shape():
    m = production_mesh_shape()
    assert (m.mesh_dim_names, m.shape, m.ndim) == (("data", "model"),
                                                   (16, 16), 2)
    mm = production_mesh_shape(multi_pod=True, pods=3)
    assert mm.shape == (3, 16, 16) and mm.size(0) == 3
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import axis_size, mesh_chips
    assert mesh_chips(mm) == 768 and axis_size(mm, ("pod", "data")) == 48
    # whisper's 1500 frames on the 16-way model axis stay whole
    assert shd.checked_spec(("batch", "kv_seq"), (32, 1500), m,
                            shd.train_rules(m)) == (("data",), None)


# ---------------------------------------------------------------------------
# shard shapes against the JAX cells on 256 host devices
# ---------------------------------------------------------------------------

JAX_CELLS = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, {src!r})
    import jax
    from repro.launch import cells
    from repro.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    def key(path):
        return ".".join(str(getattr(p, "key", getattr(p, "name",
                        getattr(p, "idx", p)))) for p in path)
    out = {{}}
    for arch, shape in {cells!r}:
        c = cells.build_cell(arch, shape, mesh)
        shs = {{key(p): s for p, s in
               jax.tree_util.tree_flatten_with_path(c.in_shardings)[0]}}
        out[arch + "|" + shape] = {{
            key(p): [list(st.shape), list(shs[key(p)].shard_shape(st.shape)),
                     st.dtype.itemsize]
            for p, st in jax.tree_util.tree_flatten_with_path(c.args)[0]}}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_shards():
    pytest.importorskip("jax")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", JAX_CELLS.format(src=SRC, cells=CELLS)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_shard_shapes_match_jax(arch, shape, jax_shards):
    """Every argument leaf: the same shape and the same shard a device
    on the 16 x 16 mesh; the same summed bytes a device."""
    mesh = production_mesh_shape()
    c = cells.build_cell(arch, shape, mesh)
    args = _flat(cells._struct(c.args))
    places = _flat(cells._struct(c.in_shardings))
    got = {p: [list(t.shape), list(cells.shard_shape(t, places[p], mesh)),
               t.element_size()] for p, t in args.items()}
    want = jax_shards[f"{arch}|{shape}"]
    assert got == want
    assert c.arg_bytes_per_device() == sum(
        v[2] * math.prod(v[1]) for v in want.values())
    assert all(t.device.type == "meta" for t in args.values())


# ---------------------------------------------------------------------------
# walks: meta against the CPU, and the xlstm extrapolation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [("phi3-mini-3.8b", "prefill"),
                                       ("olmoe-1b-7b", "decode"),
                                       ("phi3-mini-3.8b", "train")])
def test_meta_walk_equals_cpu_walk(arch, kind):
    """The same reduced cell counts the same on meta (shapes only) and
    on the CPU (random weights, plain versions): every FLOP, byte,
    declared kernel cost and op."""
    cfg = reduced_config(arch)
    shape = ShapeConfig("check", 64, 4, kind)
    mesh = production_mesh_shape()
    walks = [cells.build_cell(arch, shape, mesh, device=dev, cfg=cfg).walk()
             for dev in ("cpu", "meta")]
    (a, out_a), (b, out_b) = walks
    assert (a.flops, a.bytes, a.product_flops, a.declared, a.op_counts) \
        == (b.flops, b.bytes, b.product_flops, b.declared, b.op_counts)
    assert a.flops > 0 and a.declared
    sa = {k: (tuple(v.shape), v.dtype) for k, v in _flat(
        cells._struct(out_a)).items() if isinstance(v, torch.Tensor)}
    sb = {k: (tuple(v.shape), v.dtype) for k, v in _flat(
        cells._struct(out_b)).items() if isinstance(v, torch.Tensor)}
    assert sa == sb


def test_train_cell_counts_one_microbatch_scaled():
    """A train step of 4 microbatches walked with sampling equals the
    whole step walked without it."""
    from repro_torch.configs import TrainConfig
    from repro_torch.roofline import op_cost
    cfg = reduced_config("phi3-mini-3.8b").replace(num_layers=1)
    shape = ShapeConfig("check", 32, 8, "train")
    tc = TrainConfig(microbatch=2, remat="full")
    c = cells.build_train_cell("phi3-mini-3.8b", shape,
                               production_mesh_shape(), tc=tc, cfg=cfg)
    assert c.microbatches == 4
    sampled = c.walk()[0]
    whole = op_cost.walk(c.fn, *c.args)[0]
    assert (sampled.flops, sampled.bytes, sampled.op_counts) == \
        (whole.flops, whole.bytes, whole.op_counts)


@pytest.mark.parametrize("placed", [False, True],
                         ids=["whole", "fake_world"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_xlstm_walk_fit_is_exact(kind, placed):
    """The xlstm cells' cost is a quadratic in the sequence length: the
    fit through the walks at 128, 192 and 256 tokens, taken at 320,
    equals the walk at 320 (each FLOP, byte and op), for the whole step
    (a ``MeshShape``, on the CPU) and the partitioned one (on meta under
    ``fake_world((2, 4))``, the placed batch sliced on its sequence dim),
    whose collectives' counts and bytes by kind the fit holds too."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.roofline import op_cost
    cfg = reduced_config("xlstm-125m").replace(
        xlstm_pattern=("m", "s"), num_layers=2)
    shape = ShapeConfig("check", 320, 2, kind)
    if placed:
        world = mesh_mod.fake_world((2, 4), ("data", "model"),
                                    device_type="cpu")
    else:
        world = contextlib.nullcontext(production_mesh_shape())
    with world as mesh:
        c = cells.build_cell("xlstm-125m", shape, mesh, cfg=cfg,
                             device="meta" if placed else "cpu")
        assert c.partitioned is placed
        fit = c.walk()[0]
        with (shd.axis_rules(mesh, c.rules) if placed
              else contextlib.nullcontext()):
            whole = op_cost.walk(c.fn, *c.args, sample_loops=True)[0]
    for f in ("flops", "bytes", "product_flops"):
        assert getattr(fit, f) == pytest.approx(getattr(whole, f),
                                                rel=1e-12), f
    assert fit.op_counts == pytest.approx(whole.op_counts, rel=1e-12)
    for name, d in whole.declared.items():
        assert fit.declared[name] == pytest.approx(d, rel=1e-12), name
    assert fit.coll_op_counts == pytest.approx(whole.coll_op_counts,
                                               rel=1e-12)
    assert fit.coll_op_bytes == pytest.approx(whole.coll_op_bytes,
                                              rel=1e-12)
    assert bool(whole.coll_op_counts) is placed


def test_state_bytes_per_device_counts_outputs_not_donated():
    mesh = production_mesh_shape()
    cfg = reduced_config("phi3-mini-3.8b")
    c = cells.build_prefill_cell("phi3-mini-3.8b",
                                 ShapeConfig("check", 64, 32, "prefill"),
                                 mesh, cfg=cfg)
    _, out = c.walk()
    logits_last, caches = out
    k = caches["stage1"]["k"]          # [L, B, S, KV, D]: B/16, S/16
    extra = logits_last.numel() * 2 + 2 * k.numel() * 2 / 256 + 4
    assert c.state_bytes_per_device(out) == pytest.approx(
        c.arg_bytes_per_device() + extra, rel=1e-12)
    d = cells.build_decode_cell("phi3-mini-3.8b",
                                ShapeConfig("check", 64, 32, "decode"),
                                mesh, cfg=cfg)
    _, out = d.walk()
    assert d.state_bytes_per_device(out) == d.arg_bytes_per_device() \
        + 32 * 4                       # next token (caches donated)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_dryrun_cli_writes_an_ok_record(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = SRC
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "phi3-mini-3.8b", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    with open(tmp_path / "phi3-mini-3.8b_decode_32k_single.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["chips"] == 256
    for k in ("desc", "per_device_bytes", "fits_hbm", "walk_s", "notes"):
        assert k in rec, k
    for k in ("compute_s", "memory_s", "collective_s", "dominant",
              "useful_fraction", "mfu_bound", "wire_bytes", "op_bytes",
              "op_counts"):
        assert k in rec["roofline"], k
    assert rec["roofline"]["dominant"] == "memory"
    # a dense cell is partitioned: its decode step issues the
    # tensor-parallel reductions and the context-parallel softmax's
    assert rec["partitioned"] and rec["roofline"]["per_device"]
    for k in ("flops", "bytes", "wire_bytes", "wire_bytes_by_kind"):
        assert k in rec["per_device"], k
    assert rec["fits_hbm"] and rec["roofline"]["collective_s"] > 0.0
    assert rec["per_device"]["wire_bytes_by_kind"]["all-reduce"] > 0.0


def test_dryrun_skips_inapplicable_shapes(tmp_path):
    from repro_torch.launch import dryrun
    recs = dryrun.run_target("phi3-mini-3.8b", "long_500k", ("single",),
                             str(tmp_path))
    assert [r["status"] for r in recs] == ["skipped (inapplicable)"]
    assert not list(tmp_path.iterdir())
