"""Mixture-of-Experts block, sort-dispatch path: the twin of
``repro.models.moe`` (``moe_capacity``, ``init_moe``, ``moe_forward``).

Top-k routing in fp32, a stable argsort of the (token, slot) pairs by
expert with global capacity (pairs past an expert's capacity C go to
the drop slot E*C), the capacity buffer [E, C, d] built by the MoE
gather kernel, grouped expert GEMMs, and the combine.

Two differences of form, none of result:

- The JAX code scatters token rows into the buffer
  (``.at[dest].set(take(xf, token_of))``).  Here the same map is
  inverted into ``slot_token`` [E*C] (the token held by each slot, -1
  for an empty one) and the buffer is *gathered*: that gather is the
  kernel (``kernels/moe_dispatch``), bit-exact with the scatter.
- The JAX combine is a scatter-add over the sorted pairs.  Here the
  expert outputs are un-sorted to [T, k, d] and summed over k in fp32,
  with no atomics, so a request gives the same tokens run to run.

The expert-parallel all-to-all path (``moe_a2a``) is not ported.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_dispatch.ops import moe_gather
from repro_torch.models import params as P
from repro_torch.models.common import swiglu
from repro_torch.models.mlp import mlp_forward


def moe_capacity(num_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(num_tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


def moe_spec(cfg: ModelConfig):
    """``repro.models.moe.init_moe``: the router stays fp32."""
    d, m = cfg.d_model, cfg.moe
    spec = {"router": P.Leaf((d, m.num_experts), "normal", d, fp32=True),
            "w_gate": P.dense(m.num_experts, d, m.d_ff, fan_in=d),
            "w_up": P.dense(m.num_experts, d, m.d_ff, fan_in=d),
            "w_down": P.dense(m.num_experts, m.d_ff, d, fan_in=m.d_ff)}
    if m.num_shared:
        spec["shared"] = P.mlp_spec(d, m.num_shared * m.d_ff)
    return spec


def moe_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar fp32)."""
    B, S, d = x.shape
    m = cfg.moe
    T, k, E = B * S, m.top_k, m.num_experts
    C = moe_capacity(T, cfg)
    dev = x.device
    xf = x.reshape(T, d)

    # --- routing (fp32) ---------------------------------------------------
    logits = xf.float() @ p["router"]                      # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)             # [T, k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # aux load-balancing loss (Switch-style): E * sum_e f_e * P_e
    flat_e = eidx.reshape(T * k)
    counts = torch.bincount(flat_e, minlength=E)
    f_e = counts.float() / (T * k)
    aux = E * torch.sum(f_e * probs.mean(dim=0)) * m.router_aux_coef

    # --- dispatch: sort (token, slot) pairs by expert ----------------------
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=dev) - starts[sorted_e]
    dest = torch.where(pos < C, sorted_e * C + pos,
                       torch.full_like(pos, E * C))        # E*C = drop slot
    token_of = sort_idx // k
    # inverse map: the token each slot holds; dest is unique except for
    # the drop slot, which is cut off
    slot_token = torch.full((E * C + 1,), -1, dtype=torch.int32, device=dev)
    slot_token[dest] = token_of.to(torch.int32)
    buf = moe_gather(xf, slot_token[:E * C], E, C)          # [E, C, d]

    # --- grouped expert GEMMs ----------------------------------------------
    h = swiglu(torch.bmm(buf, p["w_gate"]), torch.bmm(buf, p["w_up"]))
    out = torch.bmm(h, p["w_down"])                        # [E, C, d]

    # --- combine: un-sort to [T, k] and sum over k in fp32 ----------------
    out_flat = torch.cat([out.reshape(E * C, d),
                          torch.zeros((1, d), dtype=out.dtype, device=dev)])
    dest_tk = torch.empty_like(dest)
    dest_tk[sort_idx] = dest                               # (token, slot)
    picked = out_flat[dest_tk].reshape(T, k, d).float()
    y = (picked * gates[..., None]).sum(dim=1)

    # --- shared experts: one dense MLP --------------------------------------
    if "shared" in p:
        y = y + mlp_forward(p["shared"], xf).float()
    return y.to(x.dtype).reshape(B, S, d), aux
