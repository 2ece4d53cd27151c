"""Plain PyTorch MoE gather: the twin of
``repro.kernels.moe_dispatch.ref.moe_gather_ref`` (take with a
validity mask)."""
from __future__ import annotations

import torch


def moe_gather_ref(x: torch.Tensor, slot_token: torch.Tensor, E: int,
                   C: int) -> torch.Tensor:
    """x: [T, d]; slot_token: [E*C] -> [E, C, d] (invalid slots -> 0)."""
    T, d = x.shape
    st = slot_token.long()
    valid = (st >= 0) & (st < T)
    rows = torch.where(valid, st, torch.zeros_like(st))
    buf = x[rows]
    buf = torch.where(valid[:, None], buf, torch.zeros_like(buf))
    return buf.reshape(E, C, d)
