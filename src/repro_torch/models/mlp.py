"""Dense SwiGLU MLP block: the twin of ``repro.models.mlp``.

Placed weights (a partitioned step) follow the rules' layout: ``w_gate``
and ``w_up`` are column-parallel (("embed", "mlp"): d over the batch
axes, the hidden width over ``model``) and ``w_down`` row-parallel, so
the output is a partial sum over ``model`` that the residual's
``constrain`` reduces.  Each weight's FSDP shards are gathered right
before its product (``sharding.gather_fsdp``), never the activation.
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.distributed.sharding import gather_fsdp
from repro_torch.models.common import swiglu


def mlp_forward(p: Mapping[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    return swiglu(x @ gather_fsdp(p["w_gate"]), x @ gather_fsdp(p["w_up"])
                  ) @ gather_fsdp(p["w_down"])
