"""Dense SwiGLU MLP block: the twin of ``repro.models.mlp``.

Placed weights (a partitioned step) follow the rules' layout: ``w_gate``
and ``w_up`` are column-parallel (("embed", "mlp"): d over the batch
axes, the hidden width over ``model``) and ``w_down`` row-parallel, so
the output is a partial sum over ``model`` that the residual's
``constrain`` reduces.  Each weight's FSDP shards are gathered right
before its product (``sharding.gather_fsdp``), never the activation.
A placed x [B, S, d] whose sequence is sharded (``seq_shard``'s
residual, over the same ``model`` axis as the hidden width) is gathered
whole over the sequence first.
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.distributed.sharding import (gather_fsdp, is_placed,
                                                replicate_dim)
from repro_torch.models.common import swiglu


def mlp_forward(p: Mapping[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    if is_placed(x) and x.ndim == 3:
        x = replicate_dim(x, 1)
    return swiglu(x @ gather_fsdp(p["w_gate"]), x @ gather_fsdp(p["w_up"])
                  ) @ gather_fsdp(p["w_down"])
