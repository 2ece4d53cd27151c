"""SIMT combinators: the twin of ``repro.core.combinators``, the paper's
divergence machinery over tensors of lanes.

``simt_cond(pred, then_fn, else_fn, *args)`` runs a data-dependent
branch over a *vector* of lanes the way the Vortex IPDOM hardware does:

  * both paths run masked (the divergent case: the serialized both-path
    execution of §IV-C),
  * with the **uniform-branch shortcut**: when the predicate is uniform
    (a Python bool, a 0-d tensor, or ``uniform=True``), only one path
    runs — "the split acts like a nop".  PyTorch runs eagerly, so the
    host picks the path: reading a CUDA predicate (``bool(pred.any())``)
    waits for the card, one host sync per uniform branch, where the
    JAX package's ``lax.cond`` decides on the device.

``masked_call`` predicates a function's writes like the thread-mask
register: outputs are where(mask, f(x), x).

``barrier`` is the `bar %id,%numW` analogue: an all-reduce of a zero
over a mesh axis's process group, added to every leaf, so no rank's
result exists before every rank of the axis has reached it (local
barrier = the "data"/"model" axis, global barrier = "pod").
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.distributed import collectives
from repro_torch.launch import mesh as mesh_mod


def _sel(mask: torch.Tensor):
    def sel(a, b):
        m = mask
        while m.dim() < a.dim():
            m = m[..., None]
        return torch.where(m, a, b)
    return sel


def simt_cond(pred, then_fn: Callable, else_fn: Optional[Callable],
              *args, uniform: Optional[bool] = None):
    """Vectorized if/else with SIMT both-path semantics.

    pred: bool tensor over lanes (leading dims broadcast against the
    outputs), or a Python bool.  then_fn / else_fn: lane-wise functions
    of *args.  uniform: True runs one path, chosen by pred.any(); with
    no else_fn a false predicate gives zeros shaped like then_fn's
    output (its shapes come from a run on the ``meta`` device)."""
    if isinstance(pred, bool) or (isinstance(pred, torch.Tensor)
                                  and pred.dim() == 0 and uniform is None):
        uniform = True
    if uniform:
        taken = bool(pred.any()) if isinstance(pred, torch.Tensor) \
            else bool(pred)
        if taken:
            return then_fn(*args)
        if else_fn is not None:
            return else_fn(*args)
        return _zeros_like_out(then_fn, args)

    # divergent: serialize both paths with lane masks (IPDOM semantics)
    t_out = then_fn(*args)
    e_out = else_fn(*args) if else_fn else pytree.tree_map(torch.zeros_like,
                                                           t_out)
    return pytree.tree_map(_sel(pred), t_out, e_out)


def _zeros_like_out(fn, args):
    dev = next((a.device for a in pytree.tree_leaves(args)
                if isinstance(a, torch.Tensor)), torch.device("cpu"))
    meta = pytree.tree_map(
        lambda a: a.to("meta") if isinstance(a, torch.Tensor) else a, args)
    shapes = fn(*meta)
    return pytree.tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev), shapes)


def masked_call(mask: torch.Tensor, fn: Callable, x, *rest):
    """Thread-mask predication: lanes where ~mask pass `x` through
    unchanged (no register write, like a predicated-off lane).  When
    fn's output structure differs from x, masked-off lanes give zeros."""
    y = fn(x, *rest)
    same = pytree.tree_structure(y) == pytree.tree_structure(x)
    fallback = x if same else pytree.tree_map(torch.zeros_like, y)
    return pytree.tree_map(_sel(mask), y, fallback)


def barrier(x, axis_name: str, *, mesh=None):
    """`bar` analogue over a mesh axis: every leaf of x plus an
    all-reduced zero of the axis's group, so each rank's result waits
    for every rank of the axis.  The mesh is `mesh` or the one
    ``sharding.axis_rules`` holds."""
    mesh = collectives.resolve_mesh(mesh)
    leaves = [t for t in pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]
    dev = leaves[0].device if leaves else torch.device(mesh.device_type)
    token = torch.zeros((), device=dev, dtype=x.dtype
                        if isinstance(x, torch.Tensor) else torch.float32)
    dist.all_reduce(token, group=mesh_mod.axis_group(mesh, axis_name))
    return pytree.tree_map(lambda t: t + token.to(t.dtype), x)
