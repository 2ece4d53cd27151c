"""Expert-parallel MoE dispatch over a mesh: the twin of
``repro.models.moe_a2a``.

  * tokens stay sharded over (pod, data) x model — the sequence dim
    rides the model axis during dispatch, so the routing and the sort
    are local to a rank;
  * a local capacity-C dispatch builds the [E, C_loc, d] send buffer,
    through the ``moe_dispatch`` kernel on CUDA (``moe_dispatch_ref`` on
    the CPU; its backward is the ``moe_dispatch_bwd`` kernel);
  * one all-to-all over the model axis moves each expert's tokens to
    the rank that owns it (EP == TP axis), the expert GEMMs run on
    [E/ep, C_loc*ep, d], and a second all-to-all returns the outputs;
  * the combine is the sort path's (``models/moe.py``), in fp32.

Two forms, one body (``_exchange``: the JAX ``shard_fn``):

- Plain tensors (the ``--mesh`` trainer of whole replicas): every rank
  holds whole weight replicas and takes its slice of the experts, E/ep
  of them, from its replica.  The all-to-alls and the aux loss's sums
  are autograd functions (``distributed/collectives.py``): a rank's
  backward gives the gradient of the sum of every rank's loss, so the
  aux loss, which every rank computes whole, counts once per rank in
  that sum.
- Placed tensors (the partitioned step, ``moe_forward_placed``): x is
  redistributed to JAX's ``x_spec`` (batch over the batch axes, the
  sequence over ``model``), the rank routes its local block with the
  replicated router, and its expert shards, FSDP-sharded over the
  ``embed`` mesh dims, are all-gathered there (``gather_fsdp``: JAX's
  ZeRO-3 unshard inside the shard; its backward reduce-scatters the
  gradient).  The loss is DTensor's, counted once: the aux sums are
  partial sums made whole (their backward passes the whole gradient
  through), and the router's and the gathered experts' gradients are
  partial sums over the mesh dims whose ranks route other tokens.  The
  all-to-alls are the plain form's (a permutation of blocks: its
  backward is the reverse exchange under either count).

Vortex framing: routing is control divergence — the a2a is the IPDOM
serialization that brings every divergent path (expert) its lanes, and
the combine is the `join`.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.moe_dispatch.ops import moe_dispatch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.mlp import mlp_forward


def _round8(c: int) -> int:
    return max(8, ((c + 7) // 8) * 8)


def batch_size(mesh, rules) -> int:
    """The number of ranks the batch is split over."""
    axes = rules.get("batch")
    return 1 if axes is None else mesh_mod.axis_size(mesh, axes)


def a2a_applicable(x: Union[torch.Tensor, Sequence[int]]) -> bool:
    """The JAX package's test, on the GLOBAL [B, S, d] shape (a tensor
    or a shape): a mesh is active, the rules do not ask for the sort
    dispatch, the model axis has more than one rank and divides S, and
    the batch axes divide B."""
    shape = tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(x)
    ctx = shd.current_context()
    if ctx is None:
        return False
    mesh, rules = ctx
    if rules.get("moe_dispatch", "a2a") != "a2a":
        return False
    ep = mesh_mod.axis_size(mesh, "model")
    if ep <= 1 or shape[1] % ep != 0:
        return False
    return shape[0] % batch_size(mesh, rules) == 0


def _exchange(xf: torch.Tensor, router: torch.Tensor, weights,
              cfg: ModelConfig, C: int, reduce
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``shard_fn`` on this rank's tokens xf [T_loc, d]: route
    with `router`, dispatch through the kernel at the local capacity C,
    the global aux loss (``reduce(t, differentiable)`` sums a vector
    over the ranks that route other tokens), the dispatch all-to-all
    over ``model``, the grouped GEMMs on ``weights()`` (the rank's E/ep
    experts' w_gate, w_up, w_down), the return all-to-all and the
    combine.  Returns (y [T_loc, d] fp32, aux)."""
    mesh, _ = shd.current_context()
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    ep = mesh_mod.axis_size(mesh, "model")
    T_loc, d = xf.shape
    model = mesh_mod.axis_group(mesh, "model")

    probs, gates, eidx = moe_mod.route(router, xf, k)
    buf, dest_tk, counts = moe_dispatch(eidx, xf, E, C)    # [E, C, d]

    # aux load-balance loss, global: probs, counts and T summed over
    # every mesh axis (the token blocks are disjoint across them)
    P_sum = reduce(probs.sum(0), True)
    ft = reduce(torch.cat([counts.float(),
                           torch.full((1,), float(T_loc), device=xf.device)]),
                False)
    f_sum, T_glob = ft[:E], ft[E]
    aux = E * torch.sum((f_sum / (T_glob * k)) * (P_sum / T_glob)) \
        * m.router_aux_coef

    # ---- dispatch a2a: [E, C, d] -> [E/ep, ep*C, d] -----------------------
    recv = collectives.all_to_all(buf, model)      # [ep(src) * E/ep, C, d]
    recv = recv.reshape(ep, E // ep, C, d).transpose(0, 1) \
        .reshape(E // ep, ep * C, d)
    out = moe_mod.experts(recv, *weights())
    # ---- return a2a: [E/ep, ep*C, d] -> [E, C, d] -------------------------
    out = out.reshape(E // ep, ep, C, d).transpose(0, 1).contiguous()
    out = collectives.all_to_all(out, model).reshape(E, C, d)
    return moe_mod.combine(out, dest_tk, gates), aux


def moe_forward_a2a(p: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: the rank's [B/bsz, S/ep, d] block -> (y of that block, aux).
    Needs an active mesh with a "model" axis (``sharding.axis_rules``);
    at ep 1 it is the sort path on the block, exchanges included.  The
    weights are whole replicas (plain tensors)."""
    mesh, _ = shd.current_context()
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    ep = mesh_mod.axis_size(mesh, "model")
    j = mesh_mod.axis_index(mesh, "model")
    Bl, Sl, d = x.shape
    C = _round8(int(Bl * Sl * k / E * m.capacity_factor))
    every = mesh_mod.axis_group(mesh, mesh.mesh_dim_names)

    def reduce(t, differentiable):
        if differentiable:
            return collectives.all_reduce_sum(t, every)
        dist.all_reduce(t, group=every)
        return t

    def weights():             # the rank's experts, from its whole replica
        lo, hi = j * (E // ep), (j + 1) * (E // ep)
        return p["w_gate"][lo:hi], p["w_up"][lo:hi], p["w_down"][lo:hi]

    xf = x.reshape(Bl * Sl, d)
    y, aux = _exchange(xf, p["router"], weights, cfg, C, reduce)
    if "shared" in p:
        y = y + mlp_forward(p["shared"], xf).float()
    return y.to(x.dtype).reshape(Bl, Sl, d), aux


def block_placements(mesh, rules) -> Tuple[Any, ...]:
    """JAX's ``x_spec`` P(batch axes, "model", None) as placements: the
    rows over the batch axes, the sequence over ``model``."""
    return shd.spec_placements((rules.get("batch"), "model", None), mesh)


def moe_forward_placed(p: Mapping[str, Any], x, cfg: ModelConfig
                       ) -> Tuple[Any, torch.Tensor]:
    """The a2a path of a partitioned step: placed x [B, S, d] (any
    layout; a2a_applicable of its global shape) -> (y placed like x,
    aux, the same on every rank).  x is redistributed to
    ``block_placements`` (under ``seq_shard`` it is there already) and
    ``_exchange`` runs on the local block; the rank's expert shards are
    FSDP-gathered (``moe.local_experts``); the shared experts run on x
    through the placed ``mlp_forward``, outside the exchange, as in the
    JAX package."""
    mesh, rules = shd.current_context()
    m = cfg.moe
    E = m.num_experts
    ep = mesh_mod.axis_size(mesh, "model")
    xs = x.redistribute(x.device_mesh, block_placements(mesh, rules))
    xl = xs.to_local()
    Bl, Sl, d = xl.shape
    C = _round8(int(Bl * Sl * m.top_k / E * m.capacity_factor))
    # the rank's tokens differ along every mesh dim that shards them:
    # there a replicated operand's gradient is a partial sum
    part = shd.row_grads(xs)
    router = shd.replicated(p["router"]).to_local(grad_placements=part)

    def reduce(t, _differentiable):
        return shd.from_local(t, xs, part).full_tensor()

    def weights():
        return moe_mod.local_experts(p, xs.placements,
                                     mesh.get_local_rank("model") * (E // ep),
                                     E // ep)

    y, aux = _exchange(xl.reshape(Bl * Sl, d), router, weights, cfg, C,
                       reduce)
    y = shd.from_local(y.reshape(Bl, Sl, d), xs)
    if tuple(y.placements) != tuple(x.placements):
        y = y.redistribute(x.device_mesh, x.placements)
    return moe_mod.with_shared(p, x, y), aux


def moe_forward_rows(p: Mapping[str, Any], x: torch.Tensor,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The a2a path from the rank's rows [B/bsz, S, d], which the ranks
    of a model axis hold alike: each takes its S/ep block, runs
    ``moe_forward_a2a`` on it, and the blocks are all-gathered over the
    model axis back to [B/bsz, S, d]."""
    mesh, _ = shd.current_context()
    ep = mesh_mod.axis_size(mesh, "model")
    j = mesh_mod.axis_index(mesh, "model")
    S = x.shape[1]
    y, aux = moe_forward_a2a(p, x[:, j * S // ep:(j + 1) * S // ep], cfg)
    y = collectives.all_gather(y.transpose(0, 1).contiguous(),
                               mesh_mod.axis_group(mesh, "model"))
    return y.transpose(0, 1), aux
