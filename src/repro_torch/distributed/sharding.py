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

A partitioned step holds its state as DTensors: ``place`` turns a tree
of tensors into DTensors with the rules' checked placements (a leaf
whose logical axes are None stays a plain tensor that every rank holds
whole), and the dense, vlm, MoE and hybrid model code runs on them.  There,
``constrain`` is GSPMD's ``with_sharding_constraint``: under active
rules it redistributes a DTensor to its spec's placements (a pending
partial sum becomes an all-reduce or a reduce-scatter, a sharded dim
that must be whole an all-gather).  Outside that, on a plain tensor or
without rules, it returns its input, as the JAX package does without
a mesh.  ``gather_fsdp`` gathers a weight's batch-axis (FSDP) shards
right before its product (an MoE layer gathers its expert shards
there and runs them on local tensors), and ``from_local`` /
``row_grads`` / ``partial_grads`` move a kernel's operands between
DTensors and the local shards it launches on, a replicated operand's
gradient a partial sum over the ranks that hold other rows (or, in a
Mamba2 mixer, other heads).  The data-parallel trainer of
whole replicas (``--mesh``) keeps plain tensors: each rank runs its
rows of every microbatch and the trainer sums the gradients over the
batch axes (``training/loop.py``).  In both forms the MoE layer reads
the active rules to pick its dispatch (``models/moe.py``,
``models/moe_a2a.py``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
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
    """The JAX package's ``with_sharding_constraint`` by logical names:
    under active rules with a ``DeviceMesh``, a DTensor is redistributed
    to the placements of its checked spec (a dimension that does not
    divide stays whole); anything else is returned as it is."""
    ctx = _ctx()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    want = spec_placements(checked_spec(logical, x.shape, mesh, rules),
                           mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def is_placed(x: Any) -> bool:
    """True for a DTensor: the partitioned form of the model code."""
    return isinstance(x, DTensor)


def place_leaf(t: torch.Tensor, logical, mesh: DeviceMesh,
               rules: Rules) -> DTensor:
    """`t` as a DTensor on `mesh` with the placements of its checked
    logical axes, its rank's chunk cut locally (every rank holds the
    same whole `t`)."""
    pl = spec_placements(checked_spec(logical, t.shape, mesh, rules), mesh)
    return distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)


def place(tree, logical_tree, mesh: DeviceMesh, rules: Rules):
    """`tree`'s tensors placed by ``place_leaf``.  A leaf whose logical
    axes are None stays a plain tensor (every rank holds it whole, as a
    replicated leaf); a None leaf stays None."""
    def one(logical, t):
        if logical is None or not isinstance(t, torch.Tensor):
            return t
        return place_leaf(t, logical, mesh, rules)
    return pytree.tree_map(one, logical_tree, tree, is_leaf=_is_spec_leaf)


def mesh_dims(mesh: DeviceMesh, rules: Rules, name: str) -> Tuple[int, ...]:
    """The mesh dims the rules map logical axis `name` onto."""
    names = mesh.mesh_dim_names
    return tuple(names.index(a) for a in _axes(rules.get(name))
                 if a in names)


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A weight with its FSDP shards gathered: the mesh dims of the
    rules' ``embed`` axis replicated, the tensor-parallel (model) shards
    kept.  Its forward is an all-gather over them and its backward a
    reduce-scatter of the gradient.  A plain tensor is returned as it
    is."""
    ctx = _ctx()
    if ctx is None or not isinstance(w, DTensor):
        return w
    mesh, rules = ctx
    pl = list(w.placements)
    for d in mesh_dims(mesh, rules, "embed"):
        pl[d] = Replicate()
    if tuple(pl) == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


def replicate_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`x` with tensor dim `dim` whole on every rank and no partial sum
    pending (an all-gather, an all-reduce, or nothing); a plain tensor
    as it is."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    pl = [Replicate() if (isinstance(p, Shard) and p.dim == dim)
          or isinstance(p, Partial) else p for p in x.placements]
    if tuple(pl) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """`x` whole on every rank, no partial sum pending; a plain tensor
    as it is."""
    if not isinstance(x, DTensor):
        return x
    pl = (Replicate(),) * x.device_mesh.ndim
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)


def local_offset(x: DTensor, dim: int) -> int:
    """The global index of this rank's first element of `x` along
    `dim` (0 where `dim` is not sharded)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    _, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return int(offset[dim]) if offset else 0


def row_grads(x: DTensor) -> Tuple[Any, ...]:
    """The gradient placements of a replicated operand (a norm's scale,
    an embedding table) used on `x`'s local rows: a partial sum over
    every mesh dim that shards `x`, whole where `x` is whole."""
    return tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in x.placements)


def partial_grads(w: DTensor, x: DTensor) -> Tuple[Any, ...]:
    """The gradient placements of operand `w` used whole on `x`'s local
    shards: `w`'s own shards kept, a partial sum over every other mesh
    dim that shards `x` (``row_grads`` for a replicated `w`; a Mamba2
    mixer's B, C and dt used on a rank's heads)."""
    return tuple(pw if isinstance(pw, Shard) else
                 Partial() if isinstance(px, Shard) else Replicate()
                 for pw, px in zip(w.placements, x.placements))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous, as
    the kernels' backward are: DTensor views a local gradient by its
    global layout, and a plain backward's may be a permuted view."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(t: torch.Tensor) -> torch.Tensor:
    """`t`, its gradient made contiguous (``_ContiguousGrad``)."""
    return _ContiguousGrad.apply(t)


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """`t` reduced by `op` ("sum", "max") over `group`, as a functional
    collective (which an op-cost walk charges), waited on."""
    import torch.distributed._functional_collectives as funcol
    out = funcol.all_reduce(t, op, group)
    return out.wait() if hasattr(out, "wait") else out


def from_local(t: torch.Tensor, like: DTensor, placements=None) -> DTensor:
    """A local result as a DTensor on `like`'s mesh, with `like`'s
    placements unless given (every shard even: the global shape is
    the local one times the shard counts)."""
    return DTensor.from_local(t, like.device_mesh,
                              like.placements if placements is None
                              else placements, run_check=False)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_placements(spec: Spec, mesh: DeviceMesh) -> Tuple[Any, ...]:
    """A spec's DTensor placements, one per mesh dim: ``Shard(d)`` where
    the spec names that mesh axis at tensor dim d, else ``Replicate()``.
    A tensor dim sharded over several mesh axes splits over them in the
    mesh's order, as a JAX spec's axis tuple does (its first axis
    major); JAX's specs name them in that order.  A mesh dim of one
    rank is ``Replicate()``: its one shard is the whole."""
    placements = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        for axis in _axes(entry):
            i = mesh.mesh_dim_names.index(axis)
            if mesh.size(i) > 1:        # one rank holds it whole anyway
                placements[i] = Shard(dim)
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
