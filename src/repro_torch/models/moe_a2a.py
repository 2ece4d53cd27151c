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

Two differences of form from the JAX code, none of result:

- JAX's expert weights are FSDP-sharded over ``data`` and all-gathered
  inside the shard (a ZeRO-3 unshard).  The port keeps whole weight
  replicas on every rank, so the rank takes its slice of the experts,
  E/ep of them, from its replica.
- The all-to-alls are autograd functions
  (``distributed/collectives.py``): a rank's backward gives the
  gradient of the sum of every rank's loss, so the aux loss, which
  every rank computes whole, counts once per rank in that sum.

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


def moe_forward_a2a(p: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: the rank's [B/bsz, S/ep, d] block -> (y of that block, aux).
    Needs an active mesh with a "model" axis (``sharding.axis_rules``);
    at ep 1 it is the sort path on the block, exchanges included."""
    mesh, rules = shd.current_context()
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    ep = mesh_mod.axis_size(mesh, "model")
    Bl, Sl, d = x.shape
    T_loc = Bl * Sl
    C = _round8(int(T_loc * k / E * m.capacity_factor))
    model = mesh_mod.axis_group(mesh, "model")
    j = mesh_mod.axis_index(mesh, "model")

    xf = x.reshape(T_loc, d)
    probs, gates, eidx = moe_mod.route(p["router"], xf, k)
    buf, dest_tk, counts = moe_dispatch(eidx, xf, E, C)    # [E, C, d]

    # aux load-balance loss, global: probs, counts and T summed over
    # every mesh axis (the token blocks are disjoint across them)
    every = mesh_mod.axis_group(mesh, mesh.mesh_dim_names)
    P_sum = collectives.all_reduce_sum(probs.sum(0), every)
    ft = torch.cat([counts.float(),
                    torch.full((1,), float(T_loc), device=x.device)])
    dist.all_reduce(ft, group=every)
    f_sum, T_glob = ft[:E], ft[E]
    aux = E * torch.sum((f_sum / (T_glob * k)) * (P_sum / T_glob)) \
        * m.router_aux_coef

    # ---- dispatch a2a: [E, C, d] -> [E/ep, ep*C, d] -----------------------
    recv = collectives.all_to_all(buf, model)      # [ep(src) * E/ep, C, d]
    recv = recv.reshape(ep, E // ep, C, d).transpose(0, 1) \
        .reshape(E // ep, ep * C, d)
    # ---- the rank's experts, from its whole replica ------------------------
    lo, hi = j * (E // ep), (j + 1) * (E // ep)
    out = moe_mod.experts(recv, p["w_gate"][lo:hi], p["w_up"][lo:hi],
                          p["w_down"][lo:hi])
    # ---- return a2a: [E/ep, ep*C, d] -> [E, C, d] -------------------------
    out = out.reshape(E // ep, ep, C, d).transpose(0, 1).contiguous()
    out = collectives.all_to_all(out, model).reshape(E, C, d)

    y = moe_mod.combine(out, dest_tk, gates)
    if "shared" in p:
        y = y + mlp_forward(p["shared"], xf).float()
    return y.to(x.dtype).reshape(Bl, Sl, d), aux


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
