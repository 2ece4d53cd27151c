"""Mixture-of-Experts block, sort-dispatch path: the twin of
``repro.models.moe`` (``moe_capacity``, ``init_moe``, ``moe_forward``).

Top-k routing in fp32, the dispatch of the (token, slot) pairs to
the capacity buffer [E, C, d] (a stable sort by expert with global
capacity: pairs past an expert's capacity C go to the drop slot E*C),
grouped expert GEMMs, and the combine.

The dispatch is one kernel (``kernels/moe_dispatch``): it ranks each
expert's pairs, writes each pair's slot and the per-expert counts and
fills the buffer, bit-exact with the plain sort and gather of
``moe_dispatch_ref``, which the CPU runs.  Two differences of form from
the JAX code, none of result:

- The JAX code scatters token rows into the buffer
  (``.at[dest].set(take(xf, token_of))``); here the buffer is
  *gathered*, each slot reading the token it holds.
- The JAX combine is a scatter-add over the sorted pairs.  Here the
  expert outputs are picked per (token, slot) pair with ``dest_tk`` to
  [T, k, d] and summed over k in fp32, with no atomics, so a request
  gives the same tokens run to run.

Training runs through the same code.  On CUDA the dispatch's backward
is a kernel too (``moe_dispatch_bwd``: each token's dx gathers and sums
its slots' rows of the buffer's gradient, in a fixed order).  The
combine's ``index_select`` backward scatters each pair's gradient to its
slot: ``dest_tk`` names every filled slot once, so each of those rows
receives one addition onto zero, and only the drop row E*C, a constant
zero row whose gradient is discarded, receives several.  So the MoE
layer's backward gives the same bits run to run, and a layer recomputed
under remat routes as its first forward did (topk and the dispatch are
deterministic).

Under a mesh (``sharding.axis_rules``) the dispatch is chosen as in
the JAX package: the expert-parallel all-to-all path (``moe_a2a``)
where it applies (a model axis of more than one rank that divides S),
else this sort path over the GLOBAL tokens, so capacity, drops and the
aux loss are the JAX program's.  Two forms:

- Plain x is the rank's rows of the batch, as the data-parallel
  trainer of whole replicas gives them: the rows are all-gathered over
  the batch axes (with autograd), routed, dispatched and combined as on
  one device, and the rank keeps its rows.
- Placed x (a DTensor: the partitioned step) is GSPMD's global sort
  (``_sort_placed``): every rank routes and dispatches every token on
  local tensors (the dispatch kernel on CUDA), the expert GEMMs run on
  the rank's shard of the buffer, experts over ``model`` and the
  capacity over ``data`` (JAX's ("experts", "expert_cap", None)), with
  the rank's experts FSDP-gathered (``local_experts``), and the
  outputs are gathered whole for the combine; the rank keeps its rows.
  The shared experts run on x through the placed ``mlp_forward``.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.moe_dispatch.ops import moe_dispatch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import params as P
from repro_torch.models.common import swiglu
from repro_torch.models.mlp import mlp_forward


def moe_capacity(num_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(num_tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


def moe_spec(cfg: ModelConfig):
    """``repro.models.moe.init_moe``: the router stays fp32 (and whole on
    every shard: the a2a dispatch needs it; ``moe_specs``)."""
    d, m, E = cfg.d_model, cfg.moe, cfg.moe.num_experts
    spec = {"router": P.dense(d, E, fan_in=d, fp32=True,
                              axes=(None, None)),
            "w_gate": P.dense(E, d, m.d_ff, fan_in=d,
                              axes=("experts", "embed", None)),
            "w_up": P.dense(E, d, m.d_ff, fan_in=d,
                            axes=("experts", "embed", None)),
            "w_down": P.dense(E, m.d_ff, d, fan_in=m.d_ff,
                              axes=("experts", None, "embed"))}
    if m.num_shared:
        spec["shared"] = P.mlp_spec(d, m.num_shared * m.d_ff)
    return spec


def route(router: torch.Tensor, xf: torch.Tensor, k: int):
    """Top-k routing in fp32: (probs [T, E], gates [T, k] renormalized,
    eidx [T, k] int64)."""
    logits = xf.float() @ router                           # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)             # [T, k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, eidx


def experts(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """The grouped expert GEMMs: [E', C', d] -> [E', C', d]."""
    h = swiglu(torch.bmm(buf, w_gate), torch.bmm(buf, w_up))
    return torch.bmm(h, w_down)


def combine(out: torch.Tensor, dest_tk: torch.Tensor, gates: torch.Tensor
            ) -> torch.Tensor:
    """Each (token, slot) pair's expert row, picked with dest_tk from
    out [E, C, d] (E*C: the zero drop row) and summed over k in fp32
    with its gate: [T, d] fp32."""
    E, C, d = out.shape
    T, k = gates.shape
    out_flat = torch.cat([out.reshape(E * C, d),
                          torch.zeros((1, d), dtype=out.dtype,
                                      device=out.device)])
    picked = out_flat.index_select(0, dest_tk).reshape(T, k, d).float()
    return (picked * gates[..., None]).sum(dim=1)


def local_experts(p: Mapping[str, torch.Tensor], tokens_pl, lo: int,
                  n: int) -> Tuple[torch.Tensor, ...]:
    """The rank's experts [lo, lo + n) of placed w_gate, w_up and w_down
    as local tensors: each weight's FSDP shards gathered
    (``sharding.gather_fsdp``, whose backward reduce-scatters), sliced
    where the weight holds more experts than the rank runs.  The local
    gradient is a partial sum over each mesh dim where the weight is
    whole and `tokens_pl` (the placements of the tokens that reach the
    rank's experts) shards the tokens."""
    out = []
    for name in ("w_gate", "w_up", "w_down"):
        w = shd.gather_fsdp(p[name])
        grads = tuple(pw if isinstance(pw, shd.Shard)
                      else shd.Partial() if isinstance(pt, shd.Shard)
                      else shd.Replicate()
                      for pw, pt in zip(w.placements, tokens_pl))
        wl = w.to_local(grad_placements=grads)
        e0 = shd.local_offset(w, 0)
        if (e0, wl.shape[0]) != (lo, n):
            wl = wl[lo - e0:lo - e0 + n]
        out.append(wl)
    return tuple(out)


def with_shared(p: Mapping[str, torch.Tensor], x, y):
    """A placed MoE layer's output: y (the routed experts' fp32 sum,
    placed like x) plus the shared experts on x (the placed
    ``mlp_forward``, reduced onto x's layout), in x's dtype."""
    if "shared" in p:
        sh = mlp_forward(p["shared"], x)
        y = y + sh.redistribute(x.device_mesh, x.placements).float()
    return y.to(x.dtype)


def moe_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar fp32).  Under a
    mesh, plain x and y are the rank's rows and placed x and y are
    DTensors of the global shape; aux is the global loss."""
    from repro_torch.models import moe_a2a
    if shd.is_placed(x):
        if moe_a2a.a2a_applicable(x):
            return moe_a2a.moe_forward_placed(p, x, cfg)
        return _sort_placed(p, x, cfg)
    ctx = shd.current_context()
    if ctx is not None:
        mesh, rules = ctx
        B, S, d = x.shape
        bsz = moe_a2a.batch_size(mesh, rules)
        if moe_a2a.a2a_applicable((B * bsz, S, d)):
            return moe_a2a.moe_forward_rows(p, x, cfg)
        if bsz > 1:
            group = mesh_mod.axis_group(mesh, rules["batch"])
            y, aux = _sort_forward(p, collectives.all_gather(x, group), cfg)
            i = mesh_mod.axis_index(mesh, rules["batch"])
            return y[i * B:(i + 1) * B], aux
    return _sort_forward(p, x, cfg)


def _sort_placed(p: Mapping[str, torch.Tensor], x, cfg: ModelConfig):
    """The global sort of a partitioned step (module docstring).  Every
    rank computes the same whole routing, buffer, combine and aux, so
    their gradients are whole on every rank (DTensor's ``Replicate``);
    only the expert GEMMs run on shards."""
    mesh = x.device_mesh
    whole = (shd.Replicate(),) * mesh.ndim
    xw = shd.replicated(x).to_local()                      # every token
    B, S, d = xw.shape
    m = cfg.moe
    T, k, E = B * S, m.top_k, m.num_experts
    C = moe_capacity(T, cfg)
    xf = xw.reshape(T, d)
    probs, gates, eidx = route(shd.replicated(p["router"]).to_local(), xf, k)
    buf, dest_tk, counts = moe_dispatch(eidx, xf, E, C)    # [E, C, d]
    f_e = counts.float() / (T * k)
    aux = E * torch.sum(f_e * probs.mean(dim=0)) * m.router_aux_coef

    # the rank's experts over model, its slots over data
    bufd = shd.constrain(shd.from_local(buf, x, whole),
                         ("experts", "expert_cap", None))
    bl = bufd.to_local()
    out = experts(bl, *local_experts(p, bufd.placements,
                                     shd.local_offset(bufd, 0), bl.shape[0]))
    out = shd.from_local(out, bufd).full_tensor()          # [E, C, d]
    y = combine(out, dest_tk, gates).reshape(B, S, d)
    y = shd.from_local(y, x, whole).redistribute(mesh, x.placements)
    return with_shared(p, x, y), aux


def _sort_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, d = x.shape
    m = cfg.moe
    T, k, E = B * S, m.top_k, m.num_experts
    C = moe_capacity(T, cfg)
    xf = x.reshape(T, d)
    probs, gates, eidx = route(p["router"], xf, k)

    # --- dispatch: each pair's slot, the per-expert counts, the buffer ----
    buf, dest_tk, counts = moe_dispatch(eidx, xf, E, C)    # [E, C, d]

    # aux load-balancing loss (Switch-style): E * sum_e f_e * P_e
    f_e = counts.float() / (T * k)
    aux = E * torch.sum(f_e * probs.mean(dim=0)) * m.router_aux_coef

    out = experts(buf, p["w_gate"], p["w_up"], p["w_down"])  # [E, C, d]
    y = combine(out, dest_tk, gates)

    # --- shared experts: one dense MLP --------------------------------------
    if "shared" in p:
        y = y + mlp_forward(p["shared"], xf).float()
    return y.to(x.dtype).reshape(B, S, d), aux
