"""Logical-axis sharding rules: the twin of ``repro.distributed.sharding``.

Model code in the JAX package annotates tensors with *logical* axis
names; this module maps them onto the axes of a mesh (a
``DeviceMesh``, ``launch/mesh.py``).  The rules are the JAX package's:

  - batch        -> (pod, data)     data parallelism across and in pods
  - embed        -> data            FSDP: weights' d_model dim
  - mlp/qkv/...  -> model           tensor parallelism
  - vocab        -> model           vocab-sharded embedding + logits
  - experts      -> model           expert parallelism (EP == TP axis)
  - expert_cap   -> data            MoE dispatch buffers' capacity dim

A spec (``logical_to_spec``) is a tuple with one entry per tensor dim:
None, a mesh axis name, or a tuple of them (the PartitionSpec of the
JAX package).  ``tree_shardings`` and ``tree_shardings_checked`` give
the DTensor placements of a spec, one per mesh dim (``Shard(dim)`` or
``Replicate()``), which ``distribute_tensor`` takes
(``distributed/elastic.py`` ``reshard_like``).

The port's models run eagerly on tensors each rank holds whole, which
carry no layout for a constraint to propagate, so ``constrain`` returns
its input and the port's model modules do not call it.  Its data
parallelism is explicit instead: each rank runs its rows of every
microbatch and the trainer sums the gradients over the batch axes
(``training/loop.py``); the MoE layer reads the active rules to pick
its dispatch (``models/moe.py``, ``models/moe_a2a.py``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.utils import _pytree as pytree

Logical = Union[str, None]
Rules = Dict[str, Any]
Spec = Tuple[Any, ...]

_state = threading.local()


def _ctx():
    return getattr(_state, "ctx", None)


def current_context():
    """(mesh, rules) active via axis_rules, or None (single device)."""
    return _ctx()


def train_rules(mesh: DeviceMesh) -> Rules:
    has_pod = "pod" in mesh.mesh_dim_names
    return {
        "batch": ("pod", "data") if has_pod else ("data",),
        "seq": None,
        "embed": "data",        # FSDP (within pod)
        "mlp": "model",
        "qkv": "model",
        "heads": "model",
        "vocab": "model",
        "experts": "model",
        "expert_cap": "data",
        "ssm_inner": "model",
        "act_embed": None,      # activations' d_model dim
        "kv_seq": "model",      # KV-cache seq dim (context-parallel decode)
        "kv_heads": "model",    # flash-attention block layout (head-parallel)
        "state_heads": "model",  # SSM state heads dim
    }


def serve_rules(mesh: DeviceMesh, *, shard_batch: bool = True) -> Rules:
    r = train_rules(mesh)
    if not shard_batch:              # long_500k: global_batch == 1
        r["batch"] = None
    return r


@contextlib.contextmanager
def axis_rules(mesh: Optional[DeviceMesh], rules: Optional[Rules] = None):
    """Activate (mesh, rules) for this thread.  With mesh=None there is
    no context: the model code runs as on one device."""
    prev = _ctx()
    _state.ctx = None if mesh is None else (mesh, rules or train_rules(mesh))
    try:
        yield
    finally:
        _state.ctx = prev


def logical_to_spec(logical: Sequence[Logical], rules: Rules) -> Spec:
    return tuple(None if name is None else rules.get(name)
                 for name in logical)


def constrain(x: torch.Tensor, logical: Sequence[Logical]) -> torch.Tensor:
    """The JAX package's ``with_sharding_constraint`` by logical names.
    An eager tensor held per rank has no layout to constrain: x."""
    return x


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_placements(spec: Spec, mesh: DeviceMesh) -> Tuple[Any, ...]:
    """A spec's DTensor placements, one per mesh dim: ``Shard(d)`` where
    the spec names that mesh axis at tensor dim d, else ``Replicate()``.
    A tensor dim sharded over several mesh axes splits over them in the
    mesh's order, as a JAX spec's axis tuple does (its first axis
    major); JAX's specs name them in that order."""
    placements = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        for axis in _axes(entry):
            placements[mesh.mesh_dim_names.index(axis)] = Shard(dim)
    return tuple(placements)


def _is_spec_leaf(x) -> bool:
    # `type(x) is tuple` (not isinstance): NamedTuple containers such as
    # the optimizer state are traversed, not taken for spec leaves
    return x is None or type(x) is tuple


def tree_shardings(spec_tree, mesh: DeviceMesh, rules: Rules):
    """Map a tree of logical-axis tuples to a tree of placements."""
    def one(logical):
        if logical is None:
            return spec_placements((), mesh)
        return spec_placements(logical_to_spec(logical, rules), mesh)
    return pytree.tree_map(one, spec_tree, is_leaf=_is_spec_leaf)


def checked_spec(logical, shape: Sequence[int], mesh: DeviceMesh,
                 rules: Rules) -> Spec:
    """``logical_to_spec``, with every axis assignment dropped whose
    dimension does not divide by its mesh axes' size (whisper's 1500
    frames on a 16-way model axis stay whole)."""
    if logical is None:
        return ()
    parts = []
    for dim, name in zip(shape, logical):
        axis = rules.get(name) if name is not None else None
        if axis is not None:
            size = 1
            for a in _axes(axis):
                size *= mesh.size(mesh.mesh_dim_names.index(a))
            if dim % size != 0:
                axis = None
        parts.append(axis)
    return tuple(parts)


def tree_shardings_checked(spec_tree, struct_tree, mesh: DeviceMesh,
                           rules: Rules):
    """Like tree_shardings, but drops any axis assignment whose
    dimension is not divisible by the mesh axis size.  `struct_tree`'s
    leaves have a ``shape`` (tensors or arrays); a None leaf (an absent
    state, as the compression error without compression) is
    replicated."""
    return pytree.tree_map(
        lambda lg, st: spec_placements(
            checked_spec(lg, () if st is None else st.shape, mesh, rules),
            mesh),
        spec_tree, struct_tree, is_leaf=_is_spec_leaf)


def mesh_tp_degree(mesh: Optional[DeviceMesh]) -> int:
    if mesh is None:
        return 1
    names = mesh.mesh_dim_names
    return mesh.size(names.index("model")) if "model" in names else 1
