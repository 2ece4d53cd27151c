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

The expert-parallel all-to-all path (``moe_a2a``) is not ported.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_dispatch.ops import moe_dispatch
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
    xf = x.reshape(T, d)

    # --- routing (fp32) ---------------------------------------------------
    logits = xf.float() @ p["router"]                      # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)             # [T, k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # --- dispatch: each pair's slot, the per-expert counts, the buffer ----
    buf, dest_tk, counts = moe_dispatch(eidx, xf, E, C)    # [E, C, d]

    # aux load-balancing loss (Switch-style): E * sum_e f_e * P_e
    f_e = counts.float() / (T * k)
    aux = E * torch.sum(f_e * probs.mean(dim=0)) * m.router_aux_coef

    # --- grouped expert GEMMs ----------------------------------------------
    h = swiglu(torch.bmm(buf, p["w_gate"]), torch.bmm(buf, p["w_up"]))
    out = torch.bmm(h, p["w_down"])                        # [E, C, d]

    # --- combine: each pair's row to [T, k], summed over k in fp32 ---------
    out_flat = torch.cat([out.reshape(E * C, d),
                          torch.zeros((1, d), dtype=out.dtype,
                                      device=x.device)])
    picked = out_flat.index_select(0, dest_tk).reshape(T, k, d).float()
    y = (picked * gates[..., None]).sum(dim=1)

    # --- shared experts: one dense MLP --------------------------------------
    if "shared" in p:
        y = y + mlp_forward(p["shared"], xf).float()
    return y.to(x.dtype).reshape(B, S, d), aux
