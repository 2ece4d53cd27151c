"""Collectives over a mesh axis: the twin of
``repro.distributed.collectives``, and the differentiable collectives
the port's distributed paths take gradients through.

``ring_all_gather`` and ``overlapped_matmul`` run the JAX package's ring
of ``ppermute`` hops as ``batch_isend_irecv`` exchanges over the axis's
process group (``launch/mesh.py`` ``axis_group``): rank i sends to
i+1 and receives from i-1, mod n.  ``overlapped_matmul`` keeps the next
shard's exchange in flight while it multiplies the current one.  At an
axis of size 1 both are plain (no exchange), as in the JAX package.

``all_to_all``, ``all_gather`` and ``all_reduce_sum`` are autograd
functions (``torch.distributed.nn.functional`` is deprecated in the
installed torch).  Each rank's backward gives the gradient of the SUM
of every rank's loss with respect to its own input: the backward of a
gather sums the ranks' gradients of this rank's rows, that of an
all-reduce sums the ranks' gradients, that of an all-to-all sends each
block's gradient back to where the block came from.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_mod


def resolve_mesh(mesh):
    if mesh is not None:
        return mesh
    ctx = shd.current_context()
    if ctx is None:
        raise RuntimeError("no mesh: pass one or run under "
                           "sharding.axis_rules(mesh, rules)")
    return ctx[0]


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """One ring hop over `group`: this rank's x goes to rank i+1, and
    rank i-1's arrives (the JAX package's ``ppermute`` with the
    permutation [(i, i+1 mod n)])."""
    recv = torch.empty_like(x)
    for work in _ring_exchange(x.contiguous(), recv, group):
        work.wait()
    return recv


def _ring_exchange(send: torch.Tensor, recv: torch.Tensor, group):
    n, me = dist.get_world_size(group), dist.get_rank(group)
    to = dist.get_global_rank(group, (me + 1) % n)
    frm = dist.get_global_rank(group, (me - 1) % n)
    return dist.batch_isend_irecv([dist.P2POp(dist.isend, send, to, group),
                                   dist.P2POp(dist.irecv, recv, frm, group)])


def ring_all_gather(x: torch.Tensor, axis_name: str, axis: int = 0, *,
                    mesh=None) -> torch.Tensor:
    """Ring all-gather over a mesh axis.  The chunks stand in hop order,
    as in the JAX package: chunk h came from rank (i - h) mod n, not
    from rank h; a caller that needs source order rolls them."""
    mesh = resolve_mesh(mesh)
    n = mesh_mod.axis_size(mesh, axis_name)
    if n == 1:
        return x
    group = mesh_mod.axis_group(mesh, axis_name)
    chunks = [x]
    for _ in range(n - 1):
        chunks.append(ring_shift(chunks[-1], group))
    return torch.cat(chunks, dim=axis)


def overlapped_matmul(x: torch.Tensor, w: torch.Tensor, axis_name: str, *,
                      mesh=None) -> torch.Tensor:
    """y = x @ all_gather(w, axis=0) over a mesh axis, where each rank
    holds a [d/n, f] shard of w and x's last dim is d.  At hop h the
    rank multiplies the shard of rank (i - h) mod n while the next hop's
    exchange is in flight; the products add in hop order in the
    promoted dtype, as in the JAX package."""
    mesh = resolve_mesh(mesh)
    n = mesh_mod.axis_size(mesh, axis_name)
    if n == 1:
        return x @ w
    group = mesh_mod.axis_group(mesh, axis_name)
    me = mesh_mod.axis_index(mesh, axis_name)
    d_shard = w.shape[0]
    dtype = torch.promote_types(x.dtype, w.dtype)
    acc = torch.zeros(x.shape[:-1] + (w.shape[-1],), dtype=dtype,
                      device=x.device)
    cur = w.contiguous()
    for h in range(n):
        src = (me - h) % n
        works, nxt = [], None
        if h < n - 1:                       # in flight ...
            nxt = torch.empty_like(cur)
            works = _ring_exchange(cur, nxt, group)
        xs = x[..., src * d_shard:(src + 1) * d_shard]
        acc = acc + (xs @ cur).to(dtype)    # ... while we multiply
        for work in works:
            work.wait()
        cur = nxt
    return acc


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` over dim 0 with equal splits: the rank's
    block j (of n) goes to rank j; block j of the result came from rank
    j.  Its backward is the same exchange of the gradient."""
    return _AllToAll.apply(x, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        n, me = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(n, dim=0)[me], None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' x concatenated over dim 0 in group-rank order.  Its
    backward sums every rank's gradient of this rank's rows (an
    all-reduce of the whole gradient, then this rank's rows: gloo has
    no reduce-scatter in every torch)."""
    return _AllGather.apply(x, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group: Optional[object] = None
                   ) -> torch.Tensor:
    """The sum of the ranks' x, with the sum of the ranks' gradients as
    its backward."""
    return _AllReduceSum.apply(x, group)
