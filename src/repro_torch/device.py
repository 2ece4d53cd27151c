"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  With
no GPU and no explicit CPU request they raise: the port never carries on
silently on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA request without a GPU raises.
    ``meta`` (shapes only, nothing allocated) is the dry run's device
    (``launch/cells.py``) and is taken only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu on the CLI) to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
