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
whole first (internvl's and zamba2's ``act_shard`` shards the
residual's d_model over ``model``) and any pending partial sum reduced,
the scale is gathered whole, and its gradient is a partial sum over the
mesh dims that shard the rows (``sharding.row_grads``), reduced by
DTensor's backward.

Rows split over ranks (``rmsnorm_split``: zamba2's gated norm over
d_inner, sharded over ``model``) are not gathered: each pass is two
kernels of ``csrc/rmsnorm.cu`` around an all-reduce of one fp32
statistic a row (``_RowsSplit``): ``rmsnorm_row_stat`` (the sum of
squares, or in the backward of dy * scale * x), ``rmsnorm_row_fwd``
and ``rmsnorm_row_bwd``, counted in ``row_launches`` by kernel (not in
``launches``); ``ref.row_*_ref`` are their plain versions.  A mesh
dim of one rank still takes this form, and then gives the whole-row
kernels' bits.

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
                                             rmsnorm_bwd_ref, rmsnorm_ref,
                                             row_bwd_ref, row_fwd_ref,
                                             row_stat_ref)
from repro_torch.roofline import op_cost

SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ROW_ARGTYPES = {
    "rmsnorm_row_stat": [_P] * 4 + [_I] * 3 + [_P],
    "rmsnorm_row_fwd": [_P] * 4 + [_I] * 3 + [_F, _I, _P],
    "rmsnorm_row_bwd": [_P] * 8 + [_I] * 4 + [_F, _I, _P]}
MAX_ROW_BYTES = 512 * 8 * 16   # csrc/rmsnorm.cu: kMaxThreads x kMaxVec words
BWD_BLOCKS_PER_SM = 8          # row blocks of the backward (dscale partials)

launches = 0
launches_by_form = {"rmsnorm": 0, "add_rmsnorm": 0}
bwd_launches = 0
bwd_launches_by_form = {"rmsnorm": 0, "add_rmsnorm": 0}
# the split-row kernels' launches, forward and backward, by kernel
row_launches = {"rmsnorm_row_stat": 0, "rmsnorm_row_fwd": 0,
                "rmsnorm_row_bwd": 0}


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
    or bf16), `scale` is [d] (or None), every tensor of `like_x` has x's
    shape and every row fits the kernel."""
    if x.device.type != "cuda" or any(t.device != x.device for t in ins):
        raise ValueError(f"{form} kernel needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in ins]}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ins):
        raise TypeError(f"{form} kernel takes fp32 or bf16 tensors of one "
                        f"dtype, got {[t.dtype for t in ins]}")
    d = x.shape[-1]
    if (scale is not None and scale.shape != (d,)) \
            or any(t.shape != x.shape for t in like_x):
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


# ---------------------------------------------------------------------------
# rows split over ranks (the gated norm of a partitioned Mamba2 mixer)
# ---------------------------------------------------------------------------

def _stat_cost(x, dy, scale) -> Tuple[float, float]:
    """(flops, bytes) of a row statistic: x (and dy, scale) read, one
    fp32 a row written; 2 operations an element, 3 with dy."""
    return ((2 if dy is None else 3) * x.numel(),
            op_cost.nbytes(x, dy, scale) + 4 * (x.numel() // x.shape[-1]))


def row_stat(x: torch.Tensor, dy: Optional[torch.Tensor] = None,
             scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 [...] of x [..., d]: each row's sum(x^2) over these columns,
    or sum(dy * scale * x) when `dy` is given."""
    with op_cost.kernel("rmsnorm_row_stat", lambda: _stat_cost(x, dy, scale)):
        if x.device.type in ("cpu", "meta"):
            return row_stat_ref(x, dy, scale)
        return row_stat_cuda(x, dy, scale)


def row_fwd(x: torch.Tensor, ss: torch.Tensor, scale: torch.Tensor,
            d_total: int, eps: float) -> torch.Tensor:
    """These columns of rows d_total wide normalised by `ss`, the whole
    rows' sums of squares."""
    with op_cost.kernel("rmsnorm_row_fwd", lambda: (
            2 * x.numel(), 2 * op_cost.nbytes(x) + op_cost.nbytes(ss, scale))):
        if x.device.type in ("cpu", "meta"):
            return row_fwd_ref(x, ss, scale, d_total, eps)
        return row_fwd_cuda(x, ss, scale, d_total, eps)


def row_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
            ss: torch.Tensor, dot: torch.Tensor, d_total: int,
            eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of ``row_fwd`` from the whole rows' sums."""
    with op_cost.kernel("rmsnorm_row_bwd", lambda: (
            8 * x.numel(), 3 * op_cost.nbytes(x) + op_cost.nbytes(
                ss, dot) + 2 * op_cost.nbytes(scale))):
        if x.device.type in ("cpu", "meta"):
            return row_bwd_ref(x, dy, scale, ss, dot, d_total, eps)
        return row_bwd_cuda(x, dy, scale, ss, dot, d_total, eps)


class _RowsSplit(torch.autograd.Function):
    """RMSNorm of local columns of rows split over `group`: each pass's
    row statistic is all-reduced over the group between its two
    kernels, as GSPMD partitions the JAX norm (a [rows] fp32 sum, never
    the rows)."""

    @staticmethod
    def forward(ctx, x, scale, eps, d_total, group):
        ss = shd.all_reduce(row_stat(x), "sum", group)
        ctx.save_for_backward(x, scale, ss)
        ctx.eps, ctx.d_total, ctx.group = eps, d_total, group
        return row_fwd(x, ss, scale, d_total, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale, ss = ctx.saved_tensors
        dy = dy.contiguous()
        dot = shd.all_reduce(row_stat(x, dy, scale), "sum", ctx.group)
        dx, dscale = row_bwd(x, dy, scale, ss, dot, ctx.d_total, ctx.eps)
        return dx, dscale, None, None, None


def _rmsnorm_split(x: torch.Tensor, scale: torch.Tensor, eps: float,
                   mesh_dim: int) -> torch.Tensor:
    """RMSNorm of placed x [..., d] whose last dim is split over mesh dim
    `mesh_dim` (sharded there, or whole where that dim has one rank),
    with `scale` [d] split alike: the row statistics all-reduced over
    that dim (``_RowsSplit``), the rows never gathered.  The result has
    x's placements; the scale's gradient is a partial sum over the mesh
    dims that shard x's rows.  Where x's last dim is whole over a dim of
    more ranks it is ``rmsnorm``.

    A mesh dim of one rank (a partitioned step at 1 x 1) takes the split
    form over a group of one on purpose, not the whole-row kernel: the
    split kernels then run on one card's main path, and give the
    whole-row kernels' bits there (their sums are laid out alike).  That
    costs one statistic launch more a pass, 0.02121 ms forward and
    0.03990 ms backward at zamba2's [4096, 7168] bf16 on an H100
    (``chip_smoke.py`` ``norm_split_phase``), and a one-rank
    all-reduce."""
    mesh = x.device_mesh
    split = [i for i, p in enumerate(x.placements)
             if p == shd.Shard(x.ndim - 1)]
    if split not in ([], [mesh_dim]):
        raise NotImplementedError(f"a norm's rows split over mesh dims "
                                  f"{split}, not {mesh_dim}")
    if not split and mesh.size(mesh_dim) > 1:      # the rows are whole
        return _rmsnorm(x, scale, eps)
    if scale.placements[mesh_dim] != (shd.Shard(0) if split
                                      else shd.Replicate()):
        raise ValueError(f"scale {scale.placements} is not split as x "
                         f"{x.placements}")
    xl = x.to_local()
    sl = scale.to_local(grad_placements=shd.partial_grads(scale, x))
    y = _RowsSplit.apply(xl, sl, eps, x.shape[-1],
                         mesh.get_group(mesh_dim))
    return shd.from_local(y, x)


rmsnorm_split = obs.instrument_kernel("rmsnorm_split", _rmsnorm_split)


def row_stat_cuda(x: torch.Tensor, dy: Optional[torch.Tensor] = None,
                  scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    ins = [x] + ([] if dy is None else [dy, scale])
    _check("rmsnorm_row_stat", x, ins, scale, [] if dy is None else [dy])
    d = x.shape[-1]
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    fn = build.function("rmsnorm", "rmsnorm_row_stat",
                        _ROW_ARGTYPES["rmsnorm_row_stat"])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), None if dy is None else dy.data_ptr(),
                 None if dy is None else scale.data_ptr(), out.data_ptr(),
                 x.numel() // d, d, _DTYPES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "rmsnorm_row_stat")
    row_launches["rmsnorm_row_stat"] += 1
    return out


def _check_stats(x: torch.Tensor, *stats: torch.Tensor) -> None:
    want = tuple(x.shape[:-1])
    for t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != want \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"row statistics must be contiguous fp32 "
                             f"{want} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def row_fwd_cuda(x: torch.Tensor, ss: torch.Tensor, scale: torch.Tensor,
                 d_total: int, eps: float) -> torch.Tensor:
    _check("rmsnorm_row_fwd", x, [x, scale], scale, [])
    _check_stats(x, ss)
    d = x.shape[-1]
    y = torch.empty_like(x)
    fn = build.function("rmsnorm", "rmsnorm_row_fwd",
                        _ROW_ARGTYPES["rmsnorm_row_fwd"])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), ss.data_ptr(), scale.data_ptr(), y.data_ptr(),
                 x.numel() // d, d, d_total, float(eps), _DTYPES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "rmsnorm_row_fwd")
    row_launches["rmsnorm_row_fwd"] += 1
    return y


def row_bwd_cuda(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                 ss: torch.Tensor, dot: torch.Tensor, d_total: int,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dx and dscale in one call (the row pass and the dscale sum, as
    ``rmsnorm_bwd_cuda`` lays them out)."""
    dy = dy.contiguous()
    _check("rmsnorm_row_bwd", x, [x, dy, scale], scale, [dy])
    _check_stats(x, ss, dot)
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    if rows == 0:
        return dx, dscale.zero_()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nb = min(rows, BWD_BLOCKS_PER_SM * sms)
    part = torch.empty((nb, d), dtype=torch.float32, device=x.device)
    fn = build.function("rmsnorm", "rmsnorm_row_bwd",
                        _ROW_ARGTYPES["rmsnorm_row_bwd"])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dy.data_ptr(), scale.data_ptr(),
                 ss.data_ptr(), dot.data_ptr(), dx.data_ptr(),
                 part.data_ptr(), dscale.data_ptr(), rows, d, d_total, nb,
                 float(eps), _DTYPES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "rmsnorm_row_bwd")
    row_launches["rmsnorm_row_bwd"] += 1
    return dx, dscale
