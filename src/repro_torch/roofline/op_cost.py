"""Eager op-cost walk of one call: the port's twin of
``repro.roofline.hlo_cost``.

The JAX package reads the three roofline inputs (FLOPs, HBM bytes,
collective wire bytes) off the optimized HLO of a compiled step.  The
port runs eagerly and has no HLO, so its cost source is the step itself:
``OpCost`` is a ``TorchDispatchMode`` that sees every aten op of one call
(the backward's too) and returns a ``StepCost`` with ``analyze_hlo``'s
field names.  The mapping:

  HLO (hlo_cost.py)                      eager (here)
  dot / convolution                      mm, bmm, addmm, baddbmm, mv, dot
  elementwise / reduce                   every other op that computes
  _PLUMBING (parameter, bitcast,         views (``OpOverload.is_view``),
    reshape, broadcast, iota, rng, ...)    empty/arange/detach/random fills
  gather / scatter / slice / concat      index/gather/scatter/cat/sort/copy
  all-reduce, all-gather, ...            c10d, _c10d_functional and
                                           _dtensor.shard_dim_alltoall
  while-loop trip counts                 none: eager runs every iteration

Counting, as ``hlo_cost``'s docstring states it:

* a product is 2·numel(out)·K (K the contracted length; the bias of
  addmm / baddbmm adds numel(out));
* an elementwise or reduce op is numel (of its largest operand or
  result);
* bytes are the operand plus result bytes of every op that is not a view
  or plumbing (``log_sigmoid``'s scratch buffer, which only the CPU and
  meta kernels fill, left out).  A tensor counts the elements its
  strides reach (a broadcast operand its own size, not the
  broadcast's).  A gather reads
  only what it produces (2 x result bytes, plus the index), a scatter
  only its update (2 x update bytes, plus the index), as ``hlo_cost``
  charges them.  Unlike XLA's copies, which fusion mostly removes and
  ``hlo_cost`` takes for plumbing, an eager copy or fill moves its bytes
  and is counted (no FLOPs);
* a c10d collective costs ring-model wire bytes over its process
  group's size (``analysis.ring_wire_bytes``), and twice its result's
  bytes of HBM traffic.

A partitioned step (DTensors, ``distributed/sharding.py``) is counted
per device, as ``hlo_cost`` reads a partitioned module: an op whose
arguments are DTensors is charged nothing at its global shapes; the
walk declines it (``NotImplemented``), DTensor's own dispatch runs it
with the walk still active, and the local ops and ``_c10d_functional``
collectives it issues on this rank's shards are what the walk charges.
The shape inference DTensor runs on fake tensors (its sharding
propagation) is not charged.  A fake world's rank 0 stands for every
device (``launch/mesh.fake_world``).

Eager code runs every loop iteration, so no trip-count correction is
needed.  A train cell counts one microbatch and multiplies it by the
microbatch count, as ``hlo_cost`` multiplies a scan body: the trainer's
microbatch loop runs through ``repeats``, which under a walk made with
``sample_loops=True`` runs its first iteration only, its counts scaled
by the loop's length (every microbatch runs the same ops on the same
shapes).

The hand-written kernels are ``ctypes`` launches that no dispatch mode
sees.  So each ``kernels/*/ops.py`` entry declares its own cost to the
active walk (``kernel``): the bound formulas of PERF.md's kernel table
(flash 4·D FLOPs a query head and unmasked pair forward, 10·D backward;
SSD's products; each input byte read once and each output byte written
once).  The ops run inside a declared region (the plain version on the
CPU and on ``meta``, the wrapper's allocations on CUDA) are not counted
again, so a step counts the same on ``meta``, ``cpu`` and ``cuda``.
Without an active walk ``kernel`` and ``repeats`` do nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.roofline.analysis import ring_wire_bytes

try:        # torch's distributed package (absent from some builds)
    from torch.distributed.tensor import DTensor
except ImportError:                      # pragma: no cover
    DTensor = ()

# products: the position of the operand whose last dim is contracted
# (mat1), which is 1 where a bias comes first; ``product_flops`` counts
# FlopCounterMode's (PRODUCTS) only
PRODUCTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}
OTHER_PRODUCTS = {"mv": 0, "dot": 0, "addmv": 1}
# no FLOPs, no bytes
PLUMBING = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_unsafe_view", "detach", "alias", "lift_fresh",
    "arange", "scalar_tensor", "_local_scalar_dense", "set_", "resize_",
    "randn", "rand", "randint", "normal_", "uniform_", "random_",
    "bernoulli_", "wait_tensor", "sym_size", "sym_stride", "sym_numel",
    "is_same_size", "_has_compatible_shallow_copy_type", "record_stream",
}
# data movement: bytes, no FLOPs
GATHERS = {"index_select", "gather", "index", "_unsafe_index", "embedding",
           "take", "take_along_dim"}
SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "index_add",
            "index_add_", "scatter", "scatter_", "scatter_add",
            "scatter_add_", "scatter_reduce", "scatter_reduce_",
            "index_copy", "index_copy_", "index_fill", "index_fill_",
            "masked_scatter", "masked_scatter_"}
MOVES = {"cat", "stack", "sort", "argsort", "topk", "clone", "copy_",
         "copy", "constant_pad_nd", "flip", "roll", "repeat",
         "slice_scatter", "select_scatter", "diagonal_scatter",
         "as_strided_scatter", "narrow_copy", "unbind_copy",
         "split_with_sizes_copy", "zero_", "fill_", "zeros", "ones",
         "full", "zeros_like", "ones_like", "full_like", "new_zeros",
         "new_ones", "new_full", "tril_indices", "triu_indices",
         "embedding_dense_backward", "_embedding_bag"}
# op -> (position in its results, in its arguments) of a scratch buffer
# that its CPU and meta kernels fill and its CUDA kernel leaves empty:
# not counted, so that every device counts alike
SCRATCH = {"log_sigmoid_forward": (1, None),
           "log_sigmoid_backward": (None, 2)}
# c10d op -> (collective, where its operand / result tensors are)
COLLECTIVES = {
    "allreduce_": ("all-reduce", 0, 0),
    "allreduce_coalesced_": ("all-reduce", 0, 0),
    "allgather_": ("all-gather", 1, 0),
    "_allgather_base_": ("all-gather", 1, 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
    "reduce_scatter_": ("reduce-scatter", 1, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
    "alltoall_": ("all-to-all", 1, 0),
    "alltoall_base_": ("all-to-all", 1, 0),
    "broadcast_": ("collective-permute", 0, 0),
    "send": ("collective-permute", 0, 0),
    # _c10d_functional (result is the op's output)
    "all_reduce": ("all-reduce", 0, -1),
    "all_reduce_": ("all-reduce", 0, 0),
    "all_gather_into_tensor": ("all-gather", 0, -1),
    "reduce_scatter_tensor": ("reduce-scatter", 0, -1),
    "all_to_all_single": ("all-to-all", 0, -1),
    # DTensor's move of a shard between dims (NCCL meshes)
    "shard_dim_alltoall": ("all-to-all", 0, -1),
}
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "_dtensor")


@dataclasses.dataclass
class StepCost:
    """The three roofline inputs of one call, with ``analyze_hlo``'s
    names, and what the walk saw: ``product_flops`` (the products
    outside declared regions, the ops ``FlopCounterMode`` counts),
    ``declared`` (per kernel: calls, FLOPs, bytes) and ``op_counts``
    (calls of each counted aten op: no views, no plumbing)."""
    flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0
    coll_op_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_op_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    product_flops: float = 0.0
    declared: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    op_counts: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add_collective(self, kind: str, s_bytes: float, r_bytes: float,
                       n: int, times: float = 1.0) -> None:
        """`times` collectives of `kind` over a group of `n`, each with
        operand `s_bytes` and result `r_bytes` a device."""
        wire = times * ring_wire_bytes(kind, s_bytes, r_bytes, n)
        self.wire_bytes += wire
        self.coll_op_bytes[kind] = self.coll_op_bytes.get(kind, 0.0) + wire
        self.coll_op_counts[kind] = self.coll_op_counts.get(kind, 0.0) \
            + times
        self.bytes += times * 2.0 * r_bytes


def _comb(xs: List[Any], ws: List[float]) -> Any:
    if any(isinstance(x, dict) for x in xs):
        xs = [x or {} for x in xs]
        return {k: _comb([x.get(k) for x in xs], ws)
                for k in {k: 0 for x in xs for k in x}}
    return sum(w * (x or 0.0) for x, w in zip(xs, ws))


def combine(costs: List[StepCost], weights: List[float]) -> StepCost:
    """Σ weights[i]·costs[i], field by field (``launch/cells.py`` fits a
    cost that is a polynomial in the sequence length)."""
    return StepCost(**{f.name: _comb([getattr(c, f.name) for c in costs],
                                     list(weights))
                       for f in dataclasses.fields(StepCost)})


_ACTIVE: List["OpCost"] = []


def active() -> Optional["OpCost"]:
    """The innermost running walk, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def tensor_bytes(t: Any) -> int:
    """Bytes of the elements a tensor's strides reach (a broadcast
    dimension, stride 0, counts once); 0 for a non-tensor."""
    if not isinstance(t, torch.Tensor):
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _numel(t: Any) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _group_size(args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> int:
    from torch.distributed import ProcessGroup
    from torch.distributed import distributed_c10d as c10d
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.ScriptObject) and \
                str(a._type()).endswith("c10d.ProcessGroup"):
            return int(ProcessGroup.unbox(a).size())
        if isinstance(a, str):              # a _c10d_functional group name
            try:
                return int(c10d._resolve_process_group(a).size())
            except (RuntimeError, ValueError, KeyError):
                continue
    return 1


def _under_fake_mode() -> bool:
    """True inside DTensor's sharding propagation, which infers shapes
    on fake tensors under a ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import \
        _get_current_dispatch_mode_stack
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


class OpCost(TorchDispatchMode):
    """Count every aten op of the code run under it:
    ``with OpCost() as oc: fn(); oc.cost``.  `sample_loops`: loops run
    through ``repeats`` run their first iteration only, scaled."""

    def __init__(self, *, sample_loops: bool = False):
        super().__init__()
        self.cost = StepCost()
        self.sample_loops = sample_loops
        self.scale = 1.0
        self.suppress = 0      # > 0 inside a declared region

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if DTensor and any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs it on local shards
        out = func(*args, **kwargs)
        if not self.suppress and not _under_fake_mode():
            self._count(func, func.overloadpacket.__name__, args, kwargs,
                        out)
        return out

    def _count(self, func, name: str, args, kwargs, out) -> None:
        c, m = self.cost, self.scale
        if func.namespace in COLLECTIVE_NAMESPACES:
            if name in COLLECTIVES:
                kind, s_at, r_at = COLLECTIVES[name]
                s = sum(tensor_bytes(t) for t in _tensors(args[s_at]))
                r = sum(tensor_bytes(t) for t in _tensors(
                    out if r_at < 0 else args[r_at]))
                c.add_collective(kind, s, r, _group_size(args, kwargs),
                                 times=m)
            return
        if func.is_view or name in PLUMBING:
            return
        c.op_counts[name] = c.op_counts.get(name, 0.0) + m
        if name in SCRATCH:
            res, arg = SCRATCH[name]
            if res is not None:
                out = out[:res] + out[res + 1:]
            if arg is not None:
                args = args[:arg] + args[arg + 1:]
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if name in PRODUCTS or name in OTHER_PRODUCTS:
            at = PRODUCTS.get(name, OTHER_PRODUCTS.get(name))
            k = args[at].shape[-1]
            prod = 2.0 * _numel(outs[0]) * k
            c.flops += m * (prod + (_numel(outs[0]) if at == 1 else 0))
            if name in PRODUCTS:
                c.product_flops += m * prod
            c.bytes += m * (sum(map(tensor_bytes, ins))
                            + sum(map(tensor_bytes, outs)))
            return
        if name in GATHERS:
            idx = sum(tensor_bytes(t) for t in ins
                      if not t.is_floating_point())
            c.bytes += m * (2 * sum(map(tensor_bytes, outs)) + idx)
            return
        if name in SCATTERS:
            idx = sum(tensor_bytes(t) for t in ins[1:]
                      if not t.is_floating_point())
            upd = sum(tensor_bytes(t) for t in ins[1:]
                      if t.is_floating_point())
            c.bytes += m * (2 * upd + idx)
            return
        c.bytes += m * (sum(map(tensor_bytes, ins))
                        + sum(map(tensor_bytes, outs)))
        if name not in MOVES:
            c.flops += m * max([_numel(t) for t in ins + outs] or [0])


def walk(fn: Callable, *args, sample_loops: bool = False,
         **kwargs) -> Tuple[StepCost, Any]:
    """(cost, result) of ``fn(*args, **kwargs)`` under a fresh walk."""
    with OpCost(sample_loops=sample_loops) as oc:
        out = fn(*args, **kwargs)
    return oc.cost, out


@contextlib.contextmanager
def kernel(name: str, cost: Callable[[], Tuple[float, float]]
           ) -> Iterator[None]:
    """A hand-written kernel's region: the active walk adds
    ``cost() -> (flops, bytes)`` once and counts no op run inside.
    Without a walk (or inside another region) it does nothing, and
    `cost` is not called."""
    mode = active()
    if mode is None or mode.suppress:
        yield
        return
    flops, nbytes = cost()
    c, m = mode.cost, mode.scale
    c.flops += m * flops
    c.bytes += m * nbytes
    d = c.declared.setdefault(name, {"calls": 0.0, "flops": 0.0,
                                     "bytes": 0.0})
    d["calls"] += m
    d["flops"] += m * flops
    d["bytes"] += m * nbytes
    mode.suppress += 1
    try:
        yield
    finally:
        mode.suppress -= 1


def repeats(n: int) -> Iterator[int]:
    """``range(n)``; under a walk with ``sample_loops``, its first
    iteration only, with every count inside it scaled by n."""
    mode = active()
    if mode is None or not mode.sample_loops or n <= 1:
        yield from range(n)
        return
    mode.scale *= n
    try:
        yield 0
    finally:
        mode.scale /= n


def plain_route() -> bool:
    """True while a walk is running: the kernel wrappers then run the
    plain versions of CPU and meta tensors through the same
    ``autograd.Function`` as the kernels of CUDA tensors, so the
    autograd graph, and with it the count, is the same on every
    device."""
    return active() is not None


def plain_call(function, plain: Callable, grad: bool, *args):
    """A kernel wrapper's CPU or meta call: ``plain(*args)``, or, during
    a walk under grad, ``function.apply(*args)``, the kernel's
    ``autograd.Function`` with the plain forward and backward inside
    (the graph a CUDA call builds)."""
    if grad and plain_route():
        return function.apply(*args)
    return plain(*args)


# ---------------------------------------------------------------------------
# the kernels' declared costs (PERF.md's bound formulas)
# ---------------------------------------------------------------------------

def nbytes(*ts: Optional[torch.Tensor]) -> int:
    return sum(tensor_bytes(t) for t in ts if t is not None)


@functools.lru_cache(maxsize=None)
def attention_pairs(S: int, Sk: int, causal: bool,
                    window: Optional[int]) -> int:
    """(query, key) pairs on the mask of ``flash_attention``: key j is
    read by query i when (not causal or j <= i) and (no window or
    i - j < window)."""
    total = 0
    for i in range(S):
        hi = min(Sk - 1, i) if causal else Sk - 1
        lo = max(0, i - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total
