"""Dry run of every (architecture x input shape) cell on the production
meshes: the twin of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch phi3-mini-3.8b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out /tmp/dr

For each cell it builds the step on ``meta`` tensors (nothing is
allocated, so it runs on a machine without a GPU) and writes one JSON
record: the state's bytes a device against an H100's 80 GB
(``fits_hbm``) and the roofline terms on ``H100``.  The JAX dry run
lowers and compiles each cell on 512 placeholder devices and reads the
compiler's cost and memory analyses of the partitioned module; there is
no compiler here, so ``--keep-hlo`` has no counterpart and ``walk_s``
stands where ``lower_s`` / ``compile_s`` stood.  ``--jobs`` walks cells
in that many processes.

Every cell is partitioned (each record's ``partitioned``): the job
builds a fake world of the production mesh's size (``mesh.fake_world``:
16 x 16, or 2 x 16 x 16 with ``--mesh multi``) in its own process,
places the cell on it and walks one device's share of the step under
``roofline.op_cost``, with the FSDP gathers, the tensor-parallel
reductions, the context-parallel decode softmax, the MoE a2a
dispatch's all-to-alls and the hybrid gated norms' all-reduces of row
statistics the step issues (``per_device``: FLOPs, bytes and wire
bytes by collective kind).  The xlstm train and prefill cells are
walked at three short lengths and fitted (``cells.Cell.walk``).

Temporaries are not counted (no compiler reports them), so
``per_device_bytes`` is a lower bound (each record's ``notes``).
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

from repro_torch.configs import (ALL_SHAPES, ARCH_IDS, applicable_shapes,
                                 get_config)
from repro_torch.launch import cells as cells_mod
from repro_torch.launch.mesh import (fake_world, mesh_chips,
                                     production_mesh_shape)
from repro_torch.models import api
from repro_torch.roofline import analysis
from repro_torch.roofline.hw import H100

MESHES = ("single", "multi")
NOTES = (
    "per_device_bytes counts the arguments and the outputs not donated; "
    "temporaries are not counted (no compiler reports them), so it is a "
    "lower bound",)
NOTES_PARTITIONED = (
    "partitioned: one device's share of the step on a fake world of the "
    "mesh's size (DTensor: FSDP over the batch axes, tensor parallelism "
    "over model, context-parallel decode, expert parallelism over model "
    "through the a2a dispatch, Mamba2 heads over model; whisper on the "
    "dense attention and MLP; xlstm's mLSTM inner channels over model, "
    "its recurrences on each rank's batch rows), with the "
    "collectives it issues; DTensor "
    "and GSPMD may pick other collectives",)


def _tag(arch: str, shape_name: str, mesh_kind: str) -> str:
    return f"{arch}_{shape_name}_{mesh_kind}".replace("/", "_")


def run_target(arch: str, shape_name: str, mesh_kinds=MESHES,
               out_dir: Optional[str] = None) -> List[dict]:
    """The records of one (arch, shape) on each mesh of `mesh_kinds`,
    each from its own walk; written under `out_dir` when given."""
    cfg = get_config(arch)
    shape = [s for s in applicable_shapes(cfg) if s.name == shape_name]
    if not shape:
        return [{"arch": arch, "shape": shape_name, "mesh": m,
                 "status": "skipped (inapplicable)"} for m in mesh_kinds]
    shape = shape[0]
    recs = []
    for mesh_kind in mesh_kinds:
        ms = production_mesh_shape(multi_pod=mesh_kind == "multi")
        with fake_world(ms.shape, ms.mesh_dim_names) as mesh:
            rec = _record(arch, cfg, shape, mesh)
        rec["mesh"] = mesh_kind
        recs.append(rec)
        if out_dir:
            _write(out_dir, _tag(arch, shape_name, mesh_kind), rec)
    return recs


def _record(arch, cfg, shape, mesh) -> dict:
    """One cell's record on `mesh`, from one walk."""
    n_chips = mesh_chips(mesh)
    cell = cells_mod.build_cell(arch, shape, mesh)
    t0 = time.time()
    walked = cell.walk()
    walk_s = time.time() - t0
    cost = cell.cost(walked)
    per_dev = cell.state_bytes_per_device(walked[1])
    roof = analysis.analyze(cost, n_chips=n_chips,
                            model_flops=api.model_flops(cfg, shape),
                            chip=H100, per_device=cell.partitioned)
    rec = {
        "arch": arch, "shape": shape.name,
        "chips": n_chips, "status": "ok", "desc": cell.static_desc,
        "partitioned": cell.partitioned,
        "walk_s": round(walk_s, 2), "microbatches": cell.microbatches,
        "cost": {"flops": cost.flops, "bytes": cost.bytes,
                 "wire_bytes": cost.wire_bytes,
                 "product_flops": cost.product_flops,
                 "declared": cost.declared},
        "per_device": {
            "flops": roof.flops_per_device,
            "bytes": roof.bytes_per_device,
            "wire_bytes": cost.wire_bytes,
            "wire_bytes_by_kind": dict(cost.coll_op_bytes),
            "collectives_by_kind": dict(cost.coll_op_counts)},
        "per_device_bytes": int(per_dev),
        "arg_bytes_per_device": int(cell.arg_bytes_per_device()),
        "fits_hbm": bool(per_dev <= H100.hbm_bytes),
        "roofline": {
            "compute_s": roof.compute_s, "memory_s": roof.memory_s,
            "collective_s": roof.collective_s,
            "dominant": roof.dominant, "total_s": roof.total_s,
            "model_flops": roof.model_flops,
            "hlo_flops_global": roof.hlo_flops_global,
            "useful_fraction": roof.useful_fraction,
            "mfu_bound": roof.mfu_bound,
            "wire_bytes": roof.wire_bytes,
            "op_bytes": roof.op_bytes, "op_counts": roof.op_counts,
            "per_device": roof.per_device,
        },
        "notes": list(NOTES) + list(NOTES_PARTITIONED),
    }
    return rec


def _write(out_dir: str, tag: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def _job(job: Tuple[str, str, Tuple[str, ...], Optional[str]]
         ) -> List[dict]:
    arch, shape_name, mesh_kinds, out_dir = job
    try:
        return run_target(arch, shape_name, mesh_kinds, out_dir)
    except Exception:
        err = traceback.format_exc()
        recs = [{"arch": arch, "shape": shape_name, "mesh": m,
                 "status": "error", "error": err} for m in mesh_kinds]
        if out_dir:
            for r in recs:
                _write(out_dir, _tag(arch, shape_name, r["mesh"]), r)
        return recs


def _line(rec: dict) -> str:
    tag = _tag(rec["arch"], rec["shape"], rec["mesh"])
    if rec["status"] != "ok":
        head = rec["status"] if rec["status"] != "error" else "FAIL"
        return f"[{head}] {tag}" + (f"\n{rec['error']}"
                                    if "error" in rec else "")
    r = rec["roofline"]
    return (f"[ok]   {tag}  walk={rec['walk_s']}s  "
            f"dev_bytes={rec['per_device_bytes'] / 1e9:.2f}G "
            f"fits={rec['fits_hbm']}  dom={r['dominant']}  "
            f"t=({r['compute_s']:.2e},{r['memory_s']:.2e},"
            f"{r['collective_s']:.2e})s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="walk the cells in this many processes")
    args = ap.parse_args(argv)

    meshes = MESHES if args.mesh == "both" else (args.mesh,)
    if args.all:       # inapplicable shapes give "skipped" records
        targets = [(a, s.name) for a in ARCH_IDS for s in ALL_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        targets = [(args.arch, args.shape)]

    jobs = []           # one a cell: each mesh's walk is its own
    for arch, shape_name in targets:
        for mesh_kind in meshes:
            path = os.path.join(args.out,
                                _tag(arch, shape_name, mesh_kind) + ".json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("status") == "ok":
                        print(f"[skip] {_tag(arch, shape_name, mesh_kind)}",
                              flush=True)
                        continue
            jobs.append((arch, shape_name, (mesh_kind,), args.out))

    failures = 0
    summary: Dict[str, int] = {}
    t0 = time.time()
    if args.jobs > 1 and len(jobs) > 1:
        # the longest walks first, so the pool ends together
        jobs.sort(key=lambda j: (j[1] != "train_4k", j[0]))
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(args.jobs, len(jobs))) as pool:
            results = pool.imap_unordered(_job, jobs)
            for recs in results:
                failures += _report(recs, summary)
    else:
        for job in jobs:
            failures += _report(_job(job), summary)
    print(f"[dryrun] {json.dumps(summary)} in {time.time() - t0:.1f}s",
          flush=True)
    return 1 if failures else 0


def _report(recs: List[dict], summary: Dict[str, int]) -> int:
    fails = 0
    for rec in recs:
        print(_line(rec), flush=True)
        key = rec["status"].split()[0]
        summary[key] = summary.get(key, 0) + 1
        fails += rec["status"] == "error"
    return fails


if __name__ == "__main__":
    sys.exit(main())
