"""Dense SwiGLU MLP block: the twin of ``repro.models.mlp``."""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.models.common import swiglu


def mlp_forward(p: Mapping[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    return swiglu(x @ p["w_gate"], x @ p["w_up"]) @ p["w_down"]
