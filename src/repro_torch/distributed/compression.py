"""Gradient compression: the twin of ``repro.distributed.compression``'s
``int8_compress_decompress`` (the fidelity model inside the train step:
per-tensor-max int8 quantization with error feedback).  The wire
all-reduce ``compressed_psum`` waits for the distributed slice of the
port (ROADMAP Queue 1, item 8)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Tree = Dict[str, torch.Tensor]


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0
    scale = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def int8_compress_decompress(grads: Tree, err: Tree) -> Tuple[Tree, Tree]:
    """Error-feedback int8 round trip, per leaf:
    g_eff = g + err;  g_hat = deq(quant(g_eff));  err' = g_eff - g_hat.
    Returns new (g_hat, err') trees; the inputs are not modified."""
    g_hat, new_err = {}, {}
    for name, g in grads.items():
        g_eff = g.float() + err[name]
        q, s = _quantize(g_eff)
        g_hat[name] = _dequantize(q, s)
        new_err[name] = g_eff - g_hat[name]
    return g_hat, new_err
