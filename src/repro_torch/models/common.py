"""Shared building blocks: the twin of ``repro.models.common``.

``rmsnorm`` and ``add_rmsnorm`` dispatch to the kernel wrappers, which
launch the CUDA kernel for CUDA tensors and run the plain version for
CPU tensors (on DTensors, on each rank's local rows).  ``embed_lookup``
on a placed table is the vocab-parallel lookup: each rank looks up the
tokens of its vocab shard, zeroes the others' rows, and the result is
a partial sum over the model axis that the caller's ``constrain``
reduces.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.kernels.rmsnorm.ops import add_rmsnorm as _add_rmsnorm_op
from repro_torch.kernels.rmsnorm.ops import rmsnorm as _rmsnorm_op
from repro_torch.roofline import op_cost

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 statistics, output in x's dtype."""
    return _rmsnorm_op(x, scale, eps)


def add_rmsnorm(x: torch.Tensor, h: Optional[torch.Tensor],
                scale: torch.Tensor, eps: float = 1e-5
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the pre-norm after it, in one kernel:
    (s = x + h, rmsnorm(s)).  h None (no branch pending, the first
    norm of a stack): (x, rmsnorm(x))."""
    if h is None:
        return x, _rmsnorm_op(x, scale, eps)
    return _add_rmsnorm_op(x, h, scale, eps)


class _EmbedLookup(torch.autograd.Function):
    """``table[tokens]`` with a deterministic backward: the rows of the
    gradient are sorted by token (a stable sort), each token's rows are
    summed in fp32 in that order (``torch.segment_reduce``, one thread
    per segment and column, no atomics) and written once.  Autograd of
    plain indexing would scatter-add them (``index_put_`` with
    accumulate), which this keeps out of the training path so that two
    runs of a step give the same bits."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, dx):
        (tokens,) = ctx.saved_tensors
        # declared like a kernel: its segments' sizes depend on the data,
        # so meta (the dry run) makes the gradient's shape only
        with op_cost.kernel("embed_bwd", lambda: (
                dx.numel(), op_cost.nbytes(dx, tokens) + math.prod(
                    ctx.table_shape) * ctx.table_dtype.itemsize)):
            grad = torch.zeros(ctx.table_shape, dtype=ctx.table_dtype,
                               device=dx.device)
            if dx.device.type == "meta":
                return grad, None
            flat = tokens.reshape(-1)
            order = torch.argsort(flat, stable=True)
            uniq, counts = torch.unique_consecutive(flat[order],
                                                    return_counts=True)
            rows = dx.reshape(-1, dx.shape[-1])[order].float()
            sums = torch.segment_reduce(rows, "sum", lengths=counts, axis=0)
            grad[uniq] = sums.to(ctx.table_dtype)
        return grad, None


def _embed_placed(table, tokens):
    """The lookup on a placed table [Vp, d] (vocab over the model axis,
    d over the batch axes) for placed tokens: d gathered (FSDP), each
    rank's vocab rows looked up and the other tokens' rows zeroed; the
    result is a partial sum over the vocab-sharding mesh dims."""
    t = shd.gather_fsdp(table)
    rows_pl, out_pl = [], []
    for pt, pk in zip(t.placements, tokens.placements):
        if isinstance(pt, shd.Shard):     # the vocab shard
            rows_pl.append(pt)
            out_pl.append(shd.Partial())
        else:
            rows_pl.append(shd.Partial() if isinstance(pk, shd.Shard)
                           else shd.Replicate())
            out_pl.append(pk)
    w = t.to_local(grad_placements=rows_pl)
    idx = tokens.to_local() - shd.local_offset(t, 0)
    vl = w.shape[0]
    out = embed_lookup(w, torch.clamp(idx, 0, vl - 1))
    if vl != t.shape[0]:
        keep = (idx >= 0) & (idx < vl)
        out = torch.where(keep[..., None], out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return shd.from_local(out, tokens, out_pl)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; under grad, with the deterministic backward of
    ``_EmbedLookup``; on a placed table, the vocab-parallel lookup."""
    if shd.is_placed(table):
        return _embed_placed(table, tokens)
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbedLookup.apply(table, tokens)
    return table[tokens]


def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S].  Split
    halves, angles in fp32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                # [D/2]
    if shd.is_placed(positions):                          # replicated
        freqs = shd.from_local(freqs, positions,
                               [shd.Replicate()] * positions.device_mesh.ndim)
    angles = positions[..., :, None].float() * freqs      # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                 # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def stack_layers(layers, shape, like: torch.Tensor) -> torch.Tensor:
    """Per-layer tensors stacked on a new leading axis; no layers: a
    [0, *shape] tensor in `like`'s dtype (as a scan over no layers
    gives)."""
    if layers:
        return torch.stack(layers)
    return like.new_zeros((0,) + tuple(shape))


def _sinusoid(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """[..., dim]: sin then cos of fp32 `pos` over dim / 2 timescales."""
    log_timescale = math.log(10_000.0) / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        dim // 2, dtype=torch.float32, device=pos.device))
    scaled = pos.float()[..., None] * inv
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)


def sinusoidal_positions(length: int, dim: int,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings [length, dim] (fp32)."""
    return _sinusoid(torch.arange(length, dtype=torch.float32,
                                  device=device), dim)


def sinusoid_at(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """The same embedding at position(s) `pos`: scalar -> [dim], [B] ->
    [B, dim] (whisper's ``_sinusoid_at``, for decode)."""
    return _sinusoid(pos, dim)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu in fp32, cast back to gate's dtype, times up."""
    return F.silu(gate.float()).to(gate.dtype) * up


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def padded_vocab(vocab: int, multiple: int = 128) -> int:
    return pad_to_multiple(vocab, multiple)
