"""RMSNorm wrappers: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors.  Rank-polymorphic over leading dims, like the JAX
``repro.kernels.rmsnorm.ops.rmsnorm``.

Two forms of one kernel: ``rmsnorm(x, scale)`` and the fused
``add_rmsnorm(x, h, scale) -> (s, y)`` with ``s = x + h`` (bit-exact
with torch's add) and ``y = rmsnorm(s)``.  ``launches`` counts kernel
launches of both forms, ``launches_by_form`` each form's (the CPU path
never bumps either).

Gradients: on CUDA, when grad mode is on and an input requires grad,
each form runs as a ``torch.autograd.Function`` whose backward is the
hand-written backward kernel (``rmsnorm_bwd``); ``bwd_launches`` /
``bwd_launches_by_form`` count its launches (one per call: the row pass
and the dscale sum).  On the CPU plain autograd runs through the plain
versions; ``ref.rmsnorm_bwd_ref`` / ``ref.add_rmsnorm_bwd_ref`` are the
backward kernel's plain versions in the tests and ``chip_smoke.py``.

DTensors (a partitioned step, ``distributed/sharding.py``) launch the
same kernels on each rank's local rows: the normalized dim is gathered
whole first (internvl's ``act_shard`` shards the residual's d_model over
``model``) and any pending partial sum reduced, the scale is gathered
whole, and its gradient is a partial sum over the mesh dims that shard
the rows (``sharding.row_grads``), reduced by DTensor's backward.

Meta tensors (the dry run) take the plain versions for their shapes.
Each entry, and each backward, declares its cost to an active op-cost
walk (``roofline.op_cost.kernel``); during a walk a CPU or meta call
under grad runs the same ``autograd.Function`` as a CUDA one, with the
plain forward and backward inside, so every device counts alike.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import (add_rmsnorm_bwd_ref,
                                             add_rmsnorm_ref,
                                             rmsnorm_bwd_ref, rmsnorm_ref)
from repro_torch.roofline import op_cost

SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
MAX_ROW_BYTES = 512 * 8 * 16   # csrc/rmsnorm.cu: kMaxThreads x kMaxVec words
BWD_BLOCKS_PER_SM = 8          # row blocks of the backward (dscale partials)

launches = 0
launches_by_form = {"rmsnorm": 0, "add_rmsnorm": 0}
bwd_launches = 0
bwd_launches_by_form = {"rmsnorm": 0, "add_rmsnorm": 0}


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if x.device.type == "cuda":
            return _launch(x, None, scale, eps)[1]
        return rmsnorm_ref(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        with op_cost.kernel("rmsnorm_bwd",
                            lambda: _bwd_cost(x, None, dy, scale)):
            if x.device.type == "cuda":
                dx, dscale = rmsnorm_bwd_cuda(x, None, dy, scale, ctx.eps)
            else:
                dx, dscale = rmsnorm_bwd_ref(x, scale, dy, ctx.eps)
        return dx, dscale, None


class _AddRmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, scale, eps):
        ctx.set_materialize_grads(False)
        if x.device.type == "cuda":
            s, y = _launch(x, h, scale, eps)
        else:
            s, y = add_rmsnorm_ref(x, h, scale, eps)
        ctx.save_for_backward(s, scale)
        ctx.eps = eps
        return s, y

    @staticmethod
    def backward(ctx, ds, dy):
        if dy is None:      # only the sum took a gradient
            return ds, ds, None, None
        s, scale = ctx.saved_tensors
        with op_cost.kernel("add_rmsnorm_bwd",
                            lambda: _bwd_cost(s, ds, dy, scale)):
            if s.device.type == "cuda":
                dh, dscale = rmsnorm_bwd_cuda(s, ds, dy, scale, ctx.eps)
            else:
                dh, dscale = add_rmsnorm_bwd_ref(s, ds, dy, scale, ctx.eps)
        return dh, dh, dscale, None


def _cost(x: torch.Tensor, h: Optional[torch.Tensor],
          scale: torch.Tensor) -> Tuple[float, float]:
    """(flops, bytes) of one forward: x (and h) and scale read, y (and
    the sum s) written; 4 operations an element (square, sum, the two
    scalings), 5 with the add."""
    n = x.numel()
    io = op_cost.nbytes(x, scale) + x.numel() * x.element_size() * (
        1 if h is None else 3)
    return (4 if h is None else 5) * n, io


def _bwd_cost(x: torch.Tensor, ds: Optional[torch.Tensor],
              dy: torch.Tensor, scale: torch.Tensor) -> Tuple[float, float]:
    """(flops, bytes) of one backward: x, dy (and ds) and scale read, dx
    and dscale written; 8 operations an element."""
    return 8 * x.numel(), (op_cost.nbytes(x, dy, ds, scale)
                           + x.numel() * x.element_size()
                           + op_cost.nbytes(scale))


def _placed(x, h, scale, eps):
    """Either form on DTensors: the kernel on this rank's local rows,
    the results with x's placements (rows sharded, d whole)."""
    x = shd.replicate_dim(x, -1)
    if h is not None:
        h = h.redistribute(x.device_mesh, x.placements)
    sc = scale.redistribute(scale.device_mesh,
                            [shd.Replicate()] * scale.device_mesh.ndim)
    sl = sc.to_local(grad_placements=shd.row_grads(x))
    if h is None:
        return shd.from_local(_rmsnorm(x.to_local(), sl, eps), x)
    s, y = _add_rmsnorm(x.to_local(), h.to_local(), sl, eps)
    return shd.from_local(s, x), shd.from_local(y, x)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x: [..., d]; scale: [d] -> [..., d] in x's dtype."""
    if shd.is_placed(x):
        return _placed(x, None, scale, eps)
    with op_cost.kernel("rmsnorm", lambda: _cost(x, None, scale)):
        if x.device.type in ("cpu", "meta"):   # meta: the dry run's shapes
            return op_cost.plain_call(_RmsNorm, rmsnorm_ref,
                                      _needs_grad(x, scale), x, scale, eps)
        if _needs_grad(x, scale):
            return _RmsNorm.apply(x, scale, eps)
        return rmsnorm_cuda(x, scale, eps)


rmsnorm = obs.instrument_kernel("rmsnorm", _rmsnorm)


def _add_rmsnorm(x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, h: [..., d]; scale: [d] -> (x + h, rmsnorm(x + h))."""
    if shd.is_placed(x):
        return _placed(x, h, scale, eps)
    with op_cost.kernel("add_rmsnorm", lambda: _cost(x, h, scale)):
        if x.device.type in ("cpu", "meta"):   # meta: the dry run's shapes
            return op_cost.plain_call(_AddRmsNorm, add_rmsnorm_ref,
                                      _needs_grad(x, h, scale), x, h,
                                      scale, eps)
        if _needs_grad(x, h, scale):
            return _AddRmsNorm.apply(x, h, scale, eps)
        return add_rmsnorm_cuda(x, h, scale, eps)


add_rmsnorm = obs.instrument_kernel("add_rmsnorm", _add_rmsnorm)


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    return _launch(x, None, scale, eps)[1]


def add_rmsnorm_cuda(x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch(x, h, scale, eps)


def _check(form: str, x: torch.Tensor, ins, scale: torch.Tensor,
           like_x) -> None:
    """Raise unless `ins` are CUDA tensors of one device and dtype (fp32
    or bf16), `scale` is [d], every tensor of `like_x` has x's shape and
    every row fits the kernel."""
    if x.device.type != "cuda" or any(t.device != x.device for t in ins):
        raise ValueError(f"{form} kernel needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in ins]}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ins):
        raise TypeError(f"{form} kernel takes fp32 or bf16 tensors of one "
                        f"dtype, got {[t.dtype for t in ins]}")
    d = x.shape[-1]
    if scale.shape != (d,) or any(t.shape != x.shape for t in like_x):
        raise ValueError(f"{form}: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}, others "
                         f"{[tuple(t.shape) for t in like_x]}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError(f"{form} kernel needs contiguous inputs")
    row = d * x.element_size()
    if row % 16 or any(t.data_ptr() % 16 for t in ins):
        raise ValueError(f"{form} kernel needs 16-byte aligned rows "
                         f"(d={d}, dtype={x.dtype})")
    if row > MAX_ROW_BYTES:
        raise ValueError(f"{form} kernel holds rows of at most "
                         f"{MAX_ROW_BYTES} bytes in registers, got d={d} "
                         f"in {x.dtype}")


def _launch(x: torch.Tensor, h: Optional[torch.Tensor], scale: torch.Tensor,
            eps: float) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    global launches
    form = "rmsnorm" if h is None else "add_rmsnorm"
    ins = [x, scale] + ([] if h is None else [h])
    _check(form, x, ins, scale, [] if h is None else [h])
    d = x.shape[-1]
    y = torch.empty_like(x)
    s = None if h is None else torch.empty_like(x)
    fn = build.function("rmsnorm", "rmsnorm_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), None if h is None else h.data_ptr(),
                 scale.data_ptr(), None if s is None else s.data_ptr(),
                 y.data_ptr(), x.numel() // d, d, float(eps),
                 _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
    build.check(err, f"rmsnorm_fwd ({form})")
    launches += 1
    launches_by_form[form] += 1
    return s, y


def rmsnorm_bwd_cuda(x: torch.Tensor, ds: Optional[torch.Tensor],
                     dy: torch.Tensor, scale: torch.Tensor,
                     eps: float = 1e-5
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel: (dx, dscale) of ``rmsnorm(x, scale)`` for
    ``ds`` None, else (dh, dscale) of the fused form, x being its saved
    sum s.  dy and ds may be strided (they are made contiguous)."""
    global bwd_launches
    form = "rmsnorm" if ds is None else "add_rmsnorm"
    dy = dy.contiguous()
    ds = None if ds is None else ds.contiguous()
    ins = [x, dy, scale] + ([] if ds is None else [ds])
    _check(form, x, ins, scale, [dy] + ([] if ds is None else [ds]))
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    if rows == 0:
        return dx, dscale.zero_()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nb = min(rows, BWD_BLOCKS_PER_SM * sms)
    part = torch.empty((nb, d), dtype=torch.float32, device=x.device)
    fn = build.function("rmsnorm", "rmsnorm_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dy.data_ptr(),
                 None if ds is None else ds.data_ptr(), scale.data_ptr(),
                 dx.data_ptr(), part.data_ptr(), dscale.data_ptr(), rows, d,
                 nb, float(eps), _DTYPES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, f"rmsnorm_bwd ({form})")
    bwd_launches += 1
    bwd_launches_by_form[form] += 1
    return dx, dscale
