"""Mesh construction: the twin of ``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``, over the ranks of the default process group, one
rank per device.  Functions only (no module-level mesh): importing this
module touches no process group.

Topology, as in the JAX package:
  single pod : (data=16, model=16)            = 256 devices
  multi-pod  : (pod=2, data=16, model=16)     = 512 devices
The ``pod`` axis composes with ``data`` for the batch, so adding pods
widens data parallelism without touching the in-pod layout.

``production_mesh_shape`` gives the production mesh's axes and sizes
without devices, for the dry run's placements (``launch/cells.py``) of
what needs no world: shard shapes, state bytes.  ``fake_world`` gives a
dry-run process a world of any size on torch's fake process group (its
collectives move nothing) and a ``DeviceMesh`` over it, on which a
partitioned step runs on ``meta`` shards and issues the collectives a
real world would.  A process holds a fake world or a real one, never
both, and one at a time.

``init_world`` starts the process group a mesh needs.  Under
``torchrun`` it takes the environment's world (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); otherwise it starts
a world of one rank on an in-process store.  The device decides the
backend: ``nccl`` for ``cuda``, ``gloo`` for ``cpu``; a CUDA request
without NCCL raises, it never becomes gloo.  NCCL refuses two ranks on
one GPU, so a world larger than one on CUDA needs as many cards.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import DeviceLike, resolve_device

Axes = Union[str, Sequence[str]]


def init_world(device: DeviceLike = None) -> Tuple[torch.device, bool]:
    """Start the default process group for `device` unless one exists.

    Returns (this rank's device, whether this call started the group:
    the caller that started it destroys it).  On CUDA the rank's device
    is ``cuda:LOCAL_RANK``, made current."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("--mesh on cuda needs NCCL, which this "
                               "torch build lacks")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"a {have} process group is running; device "
                               f"{dev} needs {backend}")
        return dev, False
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    return dev, True


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


@contextlib.contextmanager
def fake_world(shape: Sequence[int], names: Sequence[str],
               device_type: str = "cuda") -> Iterator[DeviceMesh]:
    """A world of ``prod(shape)`` ranks on torch's fake process group
    (this process is rank 0; a collective returns without moving data)
    and its ``DeviceMesh`` of `shape` with axes `names`, for a dry-run
    process: a partitioned cell built on ``meta`` runs on it exactly as
    on a real world of that size, shard shapes and collectives alike.
    `device_type` is the world's devices: ``cuda`` (NCCL's collectives;
    DTensor moves a shard from one dim to another by an all-to-all) or
    ``cpu`` (gloo's, where DTensor all-gathers instead).  Raises if a
    process group (fake or real) is running; the world ends with the
    block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(f"a {dist.get_backend()} process group is "
                           "running: a process holds one world")
    n = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield DeviceMesh(device_type,
                         torch.arange(n).reshape(tuple(shape)),
                         mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         pods: int = 2) -> DeviceMesh:
    """Single pod (16x16) or N pods x (16x16).  Builds only in a world
    of exactly that many ranks; otherwise raises, naming the size."""
    shape = (pods, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise RuntimeError(f"the production mesh {dict(zip(axes, shape))} "
                           f"needs a world of {need} ranks, this one has "
                           f"{world}")
    return DeviceMesh(_device_type(), torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axes and sizes without its devices: what the sharding
    rules read (``sharding.checked_spec``, ``spec_placements``) and
    ``mesh_chips`` counts.  The dry run places a 256- or 512-device cell
    on one, since a ``DeviceMesh`` needs a world as large as its
    shape."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self, mesh_dim: int = 0) -> int:
        return self.shape[mesh_dim]


def production_mesh_shape(*, multi_pod: bool = False,
                          pods: int = 2) -> MeshShape:
    """The axes and sizes of ``make_production_mesh``, no world needed:
    (data=16, model=16) or (pod=pods, data=16, model=16)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (pods, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_test_mesh(data: int = 1, model: int = 1) -> Optional[DeviceMesh]:
    """A (data, model) mesh over the first data*model ranks of the
    running world; None when the world is smaller (or absent), as the
    JAX twin returns None with too few devices."""
    n = dist.get_world_size() if dist.is_initialized() else 0
    if n < data * model:
        return None
    return DeviceMesh(_device_type(),
                      torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def mesh_chips(mesh: DeviceMesh) -> int:
    n = 1
    for s in mesh.shape:
        n *= s
    return n


def axis_size(mesh: DeviceMesh, axes: Axes) -> int:
    """The number of ranks along one mesh axis or a tuple of them."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    n = 1
    for a in names:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axis_group(mesh: DeviceMesh, axes: Axes):
    """This rank's process group along one mesh axis or a tuple of them
    (the tuple flattened in its order, the first axis major; the axes
    in the mesh's order).  The groups for a tuple are made once per
    mesh, by every rank, and kept on the mesh."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(names) == 1:
        return mesh.get_group(names[0])
    groups = mesh.__dict__.setdefault("_flat_groups", {})
    if names not in groups:
        dims = [mesh.mesh_dim_names.index(a) for a in names]
        rest = [d for d in range(mesh.ndim) if d not in dims]
        ranks = mesh.mesh.permute(rest + dims).reshape(
            -1, axis_size(mesh, names))
        groups[names], _ = dist.new_subgroups_by_enumeration(
            ranks.tolist())
    return groups[names]


def axis_index(mesh: DeviceMesh, axes: Axes) -> int:
    """This rank's index along the axes, flattened as ``axis_group``
    orders them (the last axis fastest, as JAX's ``axis_index`` sums)."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    idx = 0
    for a in names:
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx
