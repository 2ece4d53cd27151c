"""SSD intra-chunk wrapper: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

cum [B,nc,Q,H], xdt [B,nc,Q,H,P] and Bc/Cc [B,nc,Q,N], all fp32, give
y_intra [B,nc,Q,H,P] and S_chunk [B,nc,H,N,P] in fp32, as
``ssd_intra_ref``.  The kernel takes any Q from 1 to 256 (the model's
chunk is any divisor of the sequence length up to 256), P and N
multiples of 4 up to 128.  One launch writes both outputs, a block per
(chunk, head), with the products on the tensor cores in 3xTF32 (about
fp32 accuracy).  ``launches`` counts wrapper calls that launched the
kernel.

Gradients: on CUDA, when grad mode is on and an input requires grad,
the call runs as a ``torch.autograd.Function`` that saves its four
inputs and nothing else; the backward is the kernel of
``csrc/ssm_scan_bwd.cu`` (``ssd_intra_bwd_cuda``, counted in
``bwd_launches``); autograd feeds it zeros for an output that took
no gradient.  It
recomputes C·Bᵀ (once per chunk) and the decay, runs its products on
the tensor cores in 3xTF32, writes dcum, dxdt, dB and dC in fp32
(within 1e-4 of ``ssd_intra_bwd_ref``), and gives the same bits run to
run.  Its scratch (C·Bᵀ tiles, the head groups' partial sums) is one
fp32 buffer of ``ssd_intra_bwd_workspace`` floats.  On the CPU plain
autograd runs through ``ssd_intra_ref``.

DTensors (a partitioned Mamba2 mixer, ``models/ssm.py``) launch the
same kernels on each rank's heads (``_placed``): cum and xdt sharded
on their head dim over the model axis, B and C whole there, and the
gradients of B and C partial sums over the ranks that hold other heads
(``sharding.partial_grads``), which DTensor reduces.  The kernels take
H as a launch parameter, so a rank's H / model heads need nothing
else.

Meta tensors (the dry run) take ``ssd_intra_ref`` for their shapes.
The entry and the backward declare their costs to an active op-cost
walk (``roofline.op_cost.kernel``); during a walk a CPU or meta call
under grad runs ``_SsdIntra`` over the plain versions, the graph of a
CUDA call, so every device counts alike.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch import obs
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import build
from repro_torch.kernels.ssm_scan.ref import (ssd_intra_bwd_ref,
                                              ssd_intra_ref)
from repro_torch.roofline import op_cost

SOURCE = "src/repro_torch/csrc/ssm_scan.cu"
BWD_SOURCE = "src/repro_torch/csrc/ssm_scan_bwd.cu"
MAX_DIM = 128
MAX_Q = 256
_I, _P = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_P] * 6 + [_I] * 5 + [_P]
_BWD_ARGTYPES = [_P] * 11 + [_I] * 5 + [_P]

launches = 0
bwd_launches = 0


class _SsdIntra(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cum, xdt, Bc, Cc):
        ctx.save_for_backward(cum, xdt, Bc, Cc)
        if cum.device.type == "cuda":
            return ssd_intra_cuda(cum, xdt, Bc, Cc)
        return _plain(cum, xdt, Bc, Cc)

    @staticmethod
    def backward(ctx, dy, dS):
        cum, xdt, Bc, Cc = ctx.saved_tensors
        with op_cost.kernel("ssd_intra_bwd", lambda: bwd_cost(*xdt.shape,
                                                              Bc.shape[-1])):
            if cum.device.type == "cuda":
                return ssd_intra_bwd_cuda(cum, xdt, Bc, Cc, dy, dS)
            if cum.device.type == "meta":      # the dry run: shapes only
                return tuple(torch.empty_like(t) for t in (cum, xdt, Bc, Cc))
            return tuple(t.contiguous() for t in
                         ssd_intra_bwd_ref(cum, xdt, Bc, Cc, dy, dS))


def cost(B: int, nc: int, Q: int, H: int, P: int,
         N: int) -> Tuple[float, float]:
    """(flops, bytes) of one forward, PERF.md's bound: C·Bᵀ over the
    causal pairs once a chunk, M = C·Bᵀ ∘ decay and M @ xdt a head, the
    state product a head; the four fp32 inputs read and both outputs
    written once."""
    pairs = Q * (Q + 1) // 2
    flops = B * nc * (pairs * 2 * N + H * pairs * (2 + 2 * P)
                      + H * Q * (N + 2 * N * P))
    nbytes = 4 * B * nc * (Q * H + 2 * Q * H * P + 2 * Q * N + H * N * P)
    return flops, nbytes


def bwd_cost(B: int, nc: int, Q: int, H: int, P: int,
             N: int) -> Tuple[float, float]:
    """(flops, bytes) of one backward: its six inputs read and four
    outputs written once (fp32); the products over the lower triangle
    (dM = dy xdtᵀ and Mᵀ dy a head, C Bᵀ, dCB B and dCBᵀ C once a chunk)
    and the dS terms (B dS, xdt dSᵀ a head)."""
    tri = Q * (Q + 1) // 2
    nbytes = 4 * B * nc * (2 * Q * H + 3 * Q * H * P + 4 * Q * N
                           + H * N * P)
    flops = 2 * B * nc * (2 * tri * P * H + 3 * tri * N + 2 * Q * N * P * H)
    return flops, nbytes


def _plain(cum, xdt, Bc, Cc) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_intra_ref`` in the kernel's (contiguous) layouts, so that
    the ops after it run alike on every device."""
    y, S = ssd_intra_ref(cum, xdt, Bc, Cc)
    return y.contiguous(), S.contiguous()


def _placed(cum, xdt, Bc, Cc) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on DTensors: cum [B,nc,Q,H] and xdt [B,nc,Q,H,P] with
    their heads sharded alike (or whole), Bc / Cc [B,nc,Q,N] whole over
    the mesh dims that shard the heads.  It launches on this rank's
    heads; y_intra comes back with xdt's placements and S [B,nc,H,N,P]
    sharded on its head dim alike.  Bc's and Cc's gradients are partial
    sums over the ranks that hold other heads."""
    grads = shd.partial_grads(Bc, xdt)
    y, S = _ssd_intra(*map(shd.contiguous_grad, (
        cum.to_local(), xdt.to_local(), Bc.to_local(grad_placements=grads),
        Cc.to_local(grad_placements=grads))))
    s_pl = [shd.Shard(2) if p == shd.Shard(3) else p
            for p in xdt.placements]
    return shd.from_local(y, xdt), shd.from_local(S, xdt, s_pl)


def _ssd_intra(cum: torch.Tensor, xdt: torch.Tensor, Bc: torch.Tensor,
               Cc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if shd.is_placed(xdt):
        return _placed(cum, xdt, Bc, Cc)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (cum, xdt, Bc, Cc))
    with op_cost.kernel("ssd_intra", lambda: cost(*xdt.shape,
                                                  Bc.shape[-1])):
        if cum.device.type in ("cpu", "meta"):  # meta: the dry run's shapes
            return op_cost.plain_call(_SsdIntra, _plain, grad, cum, xdt, Bc,
                                      Cc)
        if grad:
            return _SsdIntra.apply(cum, xdt, Bc, Cc)
        return ssd_intra_cuda(cum, xdt, Bc, Cc)


ssd_intra = obs.instrument_kernel("ssd_intra", _ssd_intra)


def ssd_intra_cuda(cum: torch.Tensor, xdt: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    B, nc, Q, H, P, N = _check(cum, xdt, Bc, Cc)
    y = torch.empty((B, nc, Q, H, P), dtype=torch.float32,
                    device=cum.device)
    S = torch.empty((B, nc, H, N, P), dtype=torch.float32,
                    device=cum.device)
    fn = build.function("ssm_scan", "ssd_intra_fwd", _ARGTYPES)
    with torch.cuda.device(cum.device):
        err = fn(cum.data_ptr(), xdt.data_ptr(), Bc.data_ptr(),
                 Cc.data_ptr(), y.data_ptr(), S.data_ptr(), B * nc, Q, H,
                 N, P, torch.cuda.current_stream().cuda_stream)
    build.check(err, "ssd_intra_fwd")
    launches += 1
    return y, S


def _check(cum: torch.Tensor, xdt: torch.Tensor, Bc: torch.Tensor,
           Cc: torch.Tensor) -> Tuple[int, ...]:
    """(B, nc, Q, H, P, N) of inputs the kernels take; raises on others."""
    ts = (cum, xdt, Bc, Cc)
    if cum.device.type != "cuda" or any(t.device != cum.device for t in ts):
        raise ValueError("ssd_intra kernel needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("ssd_intra kernel takes fp32 inputs, got "
                        f"{[t.dtype for t in ts]}")
    if cum.dim() != 4 or xdt.dim() != 5 or Bc.dim() != 4 \
            or Cc.shape != Bc.shape:
        raise ValueError(f"bad ranks: cum {tuple(cum.shape)}, xdt "
                         f"{tuple(xdt.shape)}, B {tuple(Bc.shape)}, "
                         f"C {tuple(Cc.shape)}")
    B, nc, Q, H = cum.shape
    P, N = xdt.shape[-1], Bc.shape[-1]
    if tuple(xdt.shape[:4]) != (B, nc, Q, H) \
            or tuple(Bc.shape[:3]) != (B, nc, Q):
        raise ValueError(f"shapes do not match: cum {tuple(cum.shape)}, "
                         f"xdt {tuple(xdt.shape)}, B {tuple(Bc.shape)}")
    if not 0 < Q <= MAX_Q:
        raise ValueError(f"chunk length Q={Q} must be in [1, {MAX_Q}]")
    if P % 4 or N % 4 or not 0 < P <= MAX_DIM or not 0 < N <= MAX_DIM:
        raise ValueError(f"P={P} and N={N} must be multiples of 4 in "
                         f"[4, {MAX_DIM}]")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError("ssd_intra kernel needs contiguous, 16-byte "
                         "aligned inputs")
    return B, nc, Q, H, P, N


def ssd_intra_bwd_cuda(cum: torch.Tensor, xdt: torch.Tensor,
                       Bc: torch.Tensor, Cc: torch.Tensor, dy: torch.Tensor,
                       dS: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The backward kernel: (dcum, dxdt, dB, dC) in fp32 from the
    forward's inputs and the gradients of y [B,nc,Q,H,P] and S
    [B,nc,H,N,P] (strided ones are made contiguous)."""
    global bwd_launches
    B, nc, Q, H, P, N = _check(cum, xdt, Bc, Cc)
    dev = cum.device
    grads = []
    for name, g, shape in (("dy", dy, (B, nc, Q, H, P)),
                           ("dS", dS, (B, nc, H, N, P))):
        if tuple(g.shape) != shape or g.dtype != torch.float32 \
                or g.device != dev:
            raise ValueError(f"ssd_intra_bwd: {name} {tuple(g.shape)} "
                             f"{g.dtype} on {g.device}, want fp32 {shape}")
        grads.append(g.contiguous())
    dy, dS = grads
    dcum, dxdt = torch.empty_like(cum), torch.empty_like(xdt)
    dB, dC = torch.empty_like(Bc), torch.empty_like(Cc)
    ws = torch.empty(bwd_workspace(B * nc, Q, H, N, P), dtype=torch.float32,
                     device=dev)
    fn = build.function("ssm_scan_bwd", "ssd_intra_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(cum.data_ptr(), xdt.data_ptr(), Bc.data_ptr(),
                 Cc.data_ptr(), dy.data_ptr(), dS.data_ptr(),
                 dcum.data_ptr(), dxdt.data_ptr(), dB.data_ptr(),
                 dC.data_ptr(), ws.data_ptr(), B * nc, Q, H, N, P,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "ssd_intra_bwd")
    bwd_launches += 1
    return dcum, dxdt, dB, dC


def bwd_workspace(BC: int, Q: int, H: int, N: int, P: int) -> int:
    """Floats of scratch the backward kernel takes for BC chunks of Q
    positions, H heads, state N and head dim P (its C function
    ``ssd_intra_bwd_workspace``)."""
    fn = build.function("ssm_scan_bwd", "ssd_intra_bwd_workspace", [_I] * 5,
                        ctypes.c_longlong)
    n = fn(BC, Q, H, N, P)
    if n < 0:
        raise ValueError(f"ssd_intra_bwd takes no Q={Q}, N={N}, P={P}")
    return n
