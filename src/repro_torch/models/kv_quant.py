"""Int8 KV-cache quantization and the decode masks: the twins of
``repro.models.attention._quantize_kv`` and ``_dequantize_kv``, and of
the masks of its ``decode_attention`` / ``decode_attention_q8``.

The model layer (``models.attention``) and the plain int8 decode
attention (``kernels.decode_q8.ref``) both use them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as IEEE division rounds it.  On CUDA PyTorch divides
    by a Python scalar as a product with its reciprocal, which can be
    one bit off; JAX divides."""
    return x / torch.full_like(x, d)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (int8 [..., D], fp16 scale [...]).  The payload is
    quantized with the fp32 scale max|x|/127 (floored at 1e-8), rounding
    half to even; the scale is stored as fp16 only afterwards."""
    xf = x.float()
    scale = torch.clamp(_div(xf.abs().amax(dim=-1), 127.0), min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale.float()[..., None]


def valid_positions(lens: torch.Tensor, smax: int,
                    window: Optional[int]) -> torch.Tensor:
    """[B, Smax] bool: the cache positions a decode over `lens` tokens
    attends.  A windowed cache with Smax == window is a ring: every
    written slot is valid."""
    pos = torch.arange(smax, device=lens.device)
    if window is not None and smax == window:
        return pos[None] < torch.clamp(lens, max=smax)[:, None]
    valid = pos[None] < lens[:, None]
    if window is not None:
        valid &= pos[None] >= (lens - window)[:, None]
    return valid
