"""One reduced train cell's per-device cost: the port's partitioned
walk beside the JAX package's ``hlo_cost`` of the GSPMD-partitioned step.

    PYTHONPATH=src python experiments/partition_vs_gspmd.py
    ... --arch h2o-danube-1.8b --layers 2 --seq 256 --batch 8 --microbatch 4
    ... --arch xlstm-125m --layers 2 --pattern ms

The cell: the reduced config of `--arch` at `--layers` (its registry
dtype, bf16; for xlstm, its block pattern replaced by `--pattern`, as
"ms" for an mLSTM and an sLSTM block), a train step of [batch, seq] in
microbatches of `--microbatch`, remat full, on a (data 2, model 4) mesh
by the train rules.  JAX: the cell as ``repro.launch.cells.build_train_cell`` builds
it (state, shardings and step), lowered and compiled on 8 forced host
devices (``XLA_FLAGS``, set here before JAX is imported) and read by
``roofline.hlo_cost.analyze_hlo``: one partition's FLOPs, bytes and
collective wire bytes by kind.  The port: ``launch.cells`` on ``meta``
under ``mesh.fake_world((2, 4))``, walked by ``roofline.op_cost``: one
device's share of the DTensor step.  Prints one JSON line.  CPU only;
imports both packages, as the parity tests do.

A reading, not a gate: DTensor and GSPMD pick different collectives
(GSPMD may gather activations where the port gathers weights, and
fuses), and XLA counts bytes at fusion boundaries where the port counts
every eager op.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

DATA, MODEL = 2, 4


def _over(layers: int, pattern) -> dict:
    """The config fields replaced in both packages."""
    over = {"num_layers": layers}
    if pattern:
        over["xlstm_pattern"] = tuple(pattern)
    return over


def jax_cost(arch: str, layers: int, seq: int, batch: int, mb: int,
             pattern=None) -> dict:
    from repro.configs import TrainConfig, reduced_config
    from repro.configs.base import ShapeConfig
    from repro.distributed import sharding as shd
    from repro.launch import cells
    from repro.models import api
    from repro.roofline.hlo_cost import analyze_hlo
    from repro.training import loop
    cfg = reduced_config(arch).replace(**_over(layers, pattern))
    shape = ShapeConfig("check", seq, batch, "train")
    mesh = Mesh(np.array(jax.devices()[:DATA * MODEL]).reshape(DATA, MODEL),
                ("data", "model"))
    rules = shd.train_rules(mesh)
    tc = TrainConfig(microbatch=mb, remat="full")
    tp = shd.mesh_tp_degree(mesh)
    state = jax.eval_shape(
        lambda k: loop.init_train_state(k, cfg, tc, tp=tp),
        jax.random.PRNGKey(0))
    batch_struct = api.input_specs(cfg, shape)
    shardings = shd.tree_shardings_checked(loop.train_state_specs(cfg, tc),
                                           state, mesh, rules)
    cell = cells.Cell(
        arch=arch, cfg=cfg, shape=shape, mesh=mesh, rules=rules,
        fn=loop.make_train_step(cfg, tc, tp=tp), args=(state, batch_struct),
        in_shardings=(shardings, cells._batch_shardings(batch_struct, mesh,
                                                        rules)),
        out_shardings=(shardings, None), donate_argnums=(0,))
    cost = analyze_hlo(cell.lower().compile().as_text(), DATA * MODEL)
    return {"flops": cost.flops, "bytes": cost.bytes,
            "wire_bytes": cost.wire_bytes,
            "wire_bytes_by_kind": dict(cost.coll_op_bytes),
            "collectives_by_kind": dict(cost.coll_op_counts)}


def port_cost(arch: str, layers: int, seq: int, batch: int, mb: int,
              pattern=None) -> dict:
    from repro_torch.configs import ShapeConfig, TrainConfig, reduced_config
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import fake_world
    cfg = reduced_config(arch).replace(**_over(layers, pattern))
    shape = ShapeConfig("check", seq, batch, "train")
    with fake_world((DATA, MODEL), ("data", "model")) as mesh:
        cell = cells.build_train_cell(
            arch, shape, mesh, tc=TrainConfig(microbatch=mb, remat="full"),
            cfg=cfg)
        cost, _ = cell.walk()
    return {"flops": cost.flops, "bytes": cost.bytes,
            "wire_bytes": cost.wire_bytes,
            "wire_bytes_by_kind": dict(cost.coll_op_bytes),
            "collectives_by_kind": dict(cost.coll_op_counts),
            "product_flops": cost.product_flops,
            "partitioned": cell.partitioned}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=4)
    ap.add_argument("--pattern", default=None,
                    help="xlstm block kinds, e.g. 'ms'")
    a = ap.parse_args(argv)
    args = (a.arch, a.layers, a.seq, a.batch, a.microbatch, a.pattern)
    port, gspmd = port_cost(*args), jax_cost(*args)
    print(json.dumps({
        "cell": {"arch": a.arch, "layers": a.layers, "pattern": a.pattern,
                 "seq": a.seq,
                 "batch": a.batch, "microbatch": a.microbatch,
                 "mesh": {"data": DATA, "model": MODEL}, "remat": "full"},
        "port_per_device": port, "jax_hlo_cost_per_device": gspmd,
        "port_over_jax": {k: port[k] / gspmd[k] if gspmd[k] else None
                          for k in ("flops", "bytes", "wire_bytes")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
