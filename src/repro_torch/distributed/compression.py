"""Gradient compression: the twin of ``repro.distributed.compression``.

``int8_compress_decompress`` is the fidelity model inside the train
step: per-tensor-max int8 quantization with error feedback.
``compressed_psum`` is the wire form: a ring all-reduce over a mesh
axis whose hops carry an int8 payload and its fp32 scale.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.launch import mesh as mesh_mod

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


def compressed_psum(x: torch.Tensor, axis_name: str, *,
                    mesh=None) -> torch.Tensor:
    """Ring all-reduce over a mesh axis with an int8 payload: n - 1
    hops, each moving the int8 term and its fp32 scale one rank on, as
    the JAX package's ``ppermute`` ring does.  Each rank adds the term
    it receives and forwards it re-quantized.  The decode side is
    ``_dequantize``'s, bit for bit; the result is x's dtype.  The mesh
    is `mesh` or the one ``sharding.axis_rules`` holds."""
    mesh = collectives.resolve_mesh(mesh)
    n = mesh_mod.axis_size(mesh, axis_name)
    if n == 1:
        return x
    group = mesh_mod.axis_group(mesh, axis_name)
    acc = x.float()
    q, s = _quantize(acc)
    for _ in range(n - 1):
        q = collectives.ring_shift(q, group)
        s = collectives.ring_shift(s.reshape(1), group).reshape(())
        acc = acc + _dequantize(q, s)
        q, s = _quantize(_dequantize(q, s))   # re-quantize the forwarded term
    return acc.to(x.dtype)
