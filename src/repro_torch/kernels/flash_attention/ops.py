"""Flash-attention forward wrapper: the CUDA kernel for CUDA tensors,
the plain version for CPU tensors.

Layout contract: [B,S,H,D] queries and [B,Sk,KV,D] keys/values, read by
the kernel through their strides (no transposes, unlike the JAX
``repro.kernels.flash_attention.ops``); the output is a new contiguous
[B,S,H,D] tensor.

Two routes, chosen by dtype and never swapped for one another: bf16
runs the Hopper kernel (wgmma tiles fed by TMA), fp32 the FMA kernel
(exact to 2e-5; tensor cores would round to TF32).  ``launches`` counts
kernel launches only, ``launches_by_route`` the same per route.

Gradients: on CUDA, when grad mode is on and q, k or v requires grad,
the call runs as a ``torch.autograd.Function`` that saves (q, k, v,
out, lse): the forward kernel also writes the fp32 row log-sum-exp, and
the backward is the hand-written FA-2 kernel
(``csrc/flash_attention_bwd.cu``, ``flash_attention_bwd_cuda``,
counted in ``bwd_launches``), on the same two routes: bf16 on wgmma
tiles fed by TMA (P and dS rounded to bf16 before their products), fp32
on FMA.  On the CPU plain autograd runs through
``attention_ref``.  ``ref.flash_fwd_ref`` / ``ref.flash_bwd_ref`` are
the kernels' plain versions in the tests and ``chip_smoke.py``.

DTensors (a partitioned step, ``distributed/sharding.py``) launch the
same kernels on each rank's local shards: q's heads sharded over the
model axis (or whole), k and v sharded alike (the kv heads divide the
axis) or whole, in which case each rank slices the kv heads its own q
heads read (several ranks may read one kv head: its dK / dV are then a
partial sum over them, reduced by DTensor's backward).  The output has
q's placements.

Meta tensors (the dry run) take ``attention_ref`` for their shapes.
The entry and the backward declare their costs to an active op-cost
walk (``roofline.op_cost.kernel``); during a walk a CPU or meta call
under grad runs ``_Flash`` with ``flash_fwd_ref`` / ``flash_bwd_ref``
inside, the graph of a CUDA call, so every device counts alike.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_bwd_ref,
                                                     flash_fwd_ref)
from repro_torch.roofline import op_cost

SOURCE = "src/repro_torch/csrc/flash_attention.cu"
BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
HEAD_DIMS = tuple(range(16, 129, 16))    # bf16 rows of 16-byte words
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.float32: "fma", torch.bfloat16: "wgmma"}
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_ARGTYPES = ([_P] * 5 + [_I] * 6 + [_L] * 9
             + [_I, _I, ctypes.c_float, _I, _P])
_BWD_ARGTYPES = ([_P] * 10 + [_I] * 6 + [_L] * 9
                 + [_I, _I, ctypes.c_float, _I, _P])

launches = 0
launches_by_route = {route: 0 for route in ROUTES.values()}
bwd_launches = 0


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.device.type == "cuda":
            out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                            window=window, with_lse=True)
        elif q.device.type == "meta":       # the dry run: shapes only
            B, S, H, _ = q.shape
            out = q.new_empty(q.shape)       # the kernel's layouts
            lse = q.new_empty((B, H, S), dtype=torch.float32)
        else:
            out, lse = flash_fwd_ref(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        with op_cost.kernel("flash_attention_bwd",
                            lambda: _cost(q, k, ctx.causal, ctx.window,
                                          backward=True)):
            if q.device.type == "cuda":
                dq, dk, dv = flash_attention_bwd_cuda(
                    q, k, v, out, lse, do, causal=ctx.causal,
                    window=ctx.window)
            elif q.device.type == "meta":   # the dry run: shapes only
                dq, dk, dv = (t.new_empty(t.shape) for t in (q, k, v))
            else:
                dq, dk, dv = flash_bwd_ref(q, k, v, out, lse, do,
                                           causal=ctx.causal,
                                           window=ctx.window)
        return dq, dk, dv, None, None


def _cost(q: torch.Tensor, k: torch.Tensor, causal: bool,
          window: Optional[int], backward: bool = False,
          lse: bool = False) -> Tuple[float, float]:
    """(flops, bytes) of one call, PERF.md's bound: 4·D operations a
    query head and unmasked (query, key) pair forward, 10·D backward;
    q, k, v read and out (and the fp32 row LSE) written once, the
    backward reading q, k, v, out, dout, LSE and writing dq, dk, dv."""
    B, S, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    pairs = op_cost.attention_pairs(S, Sk, causal, window)
    qb, kb = op_cost.nbytes(q), op_cost.nbytes(k)
    lse_b = 4 * B * H * S
    if backward:
        return 10 * D * pairs * H * B, 4 * qb + 4 * kb + lse_b
    return 4 * D * pairs * H * B, 2 * qb + 2 * kb + (lse_b if lse else 0)


def _kv_slice(q, k) -> Optional[Tuple[int, int]]:
    """The kv heads [lo, hi) that this rank's q heads read when q's
    heads are sharded and k's are whole (all KV of them too, as with one
    kv head: dK / dV are still partial sums over the q ranks); None when
    k's local heads are already the ones (sharded like q's, or both
    whole)."""
    H, KV = q.shape[2], k.shape[2]
    hl, kl = q.to_local().shape[2], k.to_local().shape[2]
    if kl * H == KV * hl:
        return None
    G = H // KV
    h0 = shd.local_offset(q, 2)
    if G % hl == 0:                       # one kv head serves them all
        lo, hi = h0 // G, h0 // G + 1
    elif hl % G == 0 and h0 % G == 0:     # whole groups
        lo, hi = h0 // G, (h0 + hl) // G
    else:
        raise NotImplementedError(
            f"{hl} q heads a rank from {h0} do not map onto whole kv heads "
            f"of groups of {G}")
    return lo, hi


def _placed(q, k, v, causal, window):
    """The kernel on DTensors: this rank's q heads against the kv heads
    they read; the output with q's placements."""
    sl = _kv_slice(q, k)
    if sl is None:
        kl, vl = k.to_local(), v.to_local()
    else:
        grads = tuple(shd.Partial() if isinstance(pq, shd.Shard)
                      and pq.dim == 2 and not isinstance(pk, shd.Shard)
                      else pk for pq, pk in zip(q.placements, k.placements))
        kl = k.to_local(grad_placements=grads)[:, :, sl[0]:sl[1]]
        vl = v.to_local(grad_placements=grads)[:, :, sl[0]:sl[1]]
    out = _flash_attention(*map(shd.contiguous_grad,
                                (q.to_local(), kl, vl)),
                           causal=causal, window=window)
    return shd.from_local(out, q)


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True,
                     window: Optional[int] = None) -> torch.Tensor:
    """q: [B,S,H,D]; k,v: [B,Sk,KV,D] -> [B,S,H,D]."""
    if shd.is_placed(q):
        return _placed(q, k, v, causal, window)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    with op_cost.kernel("flash_attention",
                        lambda: _cost(q, k, causal, window, lse=grad)):
        if q.device.type in ("cpu", "meta"):   # meta: the dry run's shapes
            return op_cost.plain_call(
                _Flash, lambda q, k, v, causal, window: attention_ref(
                    q, k, v, causal=causal, window=window).contiguous(),
                grad, q, k, v, causal, window)
        if grad:
            return _Flash.apply(q, k, v, causal, window)
        return flash_attention_cuda(q, k, v, causal=causal, window=window)


flash_attention = obs.instrument_kernel("flash_attention", _flash_attention)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    """Raise unless q, k, v are what the kernels take."""
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention kernel needs CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes fp32 or bf16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         "not match (GQA needs H % KV == 0)")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    for t in (q, k, v):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                st * t.element_size() % 16 for st in t.stride()[:3]):
            raise ValueError("flash_attention kernel needs unit stride on D "
                             "and 16-byte aligned pointers and strides")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         with_lse: bool = False):
    """The forward kernel: out [B,S,H,D]; with `with_lse`, (out, lse)
    with lse the fp32 row log-sum-exp [B,H,S] (out is the same bits
    either way)."""
    global launches
    _check(q, k, v, window)
    B, S, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, S, Sk, H, KV, D,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 int(causal), int(window or 0), 1.0 / (D ** 0.5),
                 _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention_fwd")
    launches += 1
    launches_by_route[ROUTES[q.dtype]] += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None):
    """The FA-2 backward kernel: (dq, dk, dv) in q's dtype, contiguous,
    from the forward's out and fp32 lse [B,H,S].  out and do may be
    strided (they are made contiguous)."""
    global bwd_launches
    _check(q, k, v, window)
    B, S, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out, do = out.contiguous(), do.contiguous()
    lse = lse.contiguous()
    for name, t in (("out", out), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype} does not match q "
                             f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype}, want fp32 {(B, H, S)}")
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KV, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Sk, KV, D), dtype=q.dtype, device=q.device)
    fn = build.function("flash_attention_bwd", "flash_attention_bwd",
                        _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 B, S, Sk, H, KV, D,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 int(causal), int(window or 0), 1.0 / (D ** 0.5),
                 _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv
