"""The RMSNorm of rows split over ranks (``kernels/rmsnorm/ops.py``
``rmsnorm_split``: the gated norm of a partitioned Mamba2 mixer).  Its
plain versions on the CPU against the whole-row plain norm and its
autograd; its CUDA kernels (``csrc/rmsnorm.cu`` ``rmsnorm_row_*``)
against the plain versions and the whole-row kernels on a card (``gpu``
marker, skipped here): ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_rmsnorm_split.py``.
The partitioned norm itself runs in ``test_torch_partition_hybrid.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import (  # noqa: E402
    rmsnorm_bwd_ref, rmsnorm_ref, row_bwd_ref, row_fwd_ref, row_stat_ref)

EPS = 1e-5


def _inputs(rows, d, dtype, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, d, generator=g)
    scale = torch.rand(d, generator=g) + 0.5
    dy = torch.randn(rows, d, generator=g)
    return [t.to(device=device, dtype=dtype) for t in (x, scale, dy)]


def _split(fns, x, scale, dy, blocks):
    """The split-row norm over `blocks` column blocks, each block's
    statistic summed between the passes: (y, dx, dscale), each the
    blocks' results side by side.  `fns`: (stat, fwd, bwd)."""
    stat, fwd, bwd = fns
    d = x.shape[-1]
    xs, ss_, dys = ([c.contiguous() for c in t.chunk(blocks, dim=-1)]
                    for t in (x, scale, dy))
    ss = sum(stat(t) for t in xs)
    y = torch.cat([fwd(t, ss, s, d, EPS) for t, s in zip(xs, ss_)], dim=-1)
    dot = sum(stat(t, o, s) for t, o, s in zip(xs, dys, ss_))
    parts = [bwd(t, o, s, ss, dot, d, EPS) for t, o, s in zip(xs, dys, ss_)]
    return (y, torch.cat([p[0] for p in parts], dim=-1),
            torch.cat([p[1] for p in parts]))


PLAIN = (row_stat_ref, row_fwd_ref, row_bwd_ref)
CUDA = (rms_ops.row_stat_cuda, rms_ops.row_fwd_cuda, rms_ops.row_bwd_cuda)


@pytest.mark.parametrize("rows,d,blocks", [(24, 256, 4), (7, 512, 16),
                                           (3, 64, 1)])
def test_split_row_norm_plain_matches_whole_row(rows, d, blocks):
    """The plain versions on column blocks of seeded fp32 rows, their
    statistics summed between the passes: the forward and both
    gradients equal the whole-row plain norm and its autograd to fp32
    rounding."""
    x, scale, dy = _inputs(rows, d, torch.float32)
    y, dx, dscale = _split(PLAIN, x, scale, dy, blocks)
    xw, sw = x.clone().requires_grad_(), scale.clone().requires_grad_()
    want = rmsnorm_ref(xw, sw, EPS)
    want.backward(dy)
    torch.testing.assert_close(y, want.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dx, xw.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dscale, sw.grad, rtol=1e-5, atol=1e-5)


def test_split_row_kernels_refuse_cpu_tensors():
    """A CUDA wrapper given CPU tensors raises before anything is built
    (no fallback to the plain version)."""
    x, scale, dy = _inputs(4, 64, torch.float32)
    ss = row_stat_ref(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rms_ops.row_stat_cuda(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rms_ops.row_fwd_cuda(x, ss, scale, 64, EPS)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rms_ops.row_bwd_cuda(x, dy, scale, ss, ss, 64, EPS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,blocks", [(64, 7168, 16), (33, 256, 4),
                                           (5, 3072, 2), (1, 128, 1)])
def test_split_row_kernels_match_plain(cuda, dtype, rows, d, blocks):
    """Each kernel against its plain version on the same inputs (the
    statistics the kernels summed), and the split norm against the
    whole-row plain norm."""
    x, scale, dy = _inputs(rows, d, dtype, cuda)
    tol = TOL[dtype]
    for t in x.chunk(blocks, dim=-1):
        t = t.contiguous()
        torch.testing.assert_close(rms_ops.row_stat_cuda(t), row_stat_ref(t),
                                   rtol=1e-5, atol=1e-4)
    y, dx, dscale = _split(CUDA, x, scale, dy, blocks)
    py, pdx, pdscale = _split(PLAIN, x, scale, dy, blocks)
    for got, want in ((y, py), (dx, pdx), (dscale, pdscale)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    torch.testing.assert_close(y.float(), rmsnorm_ref(x, scale, EPS).float(),
                               rtol=tol, atol=tol)
    wdx, wds = rmsnorm_bwd_ref(x, scale, dy, EPS)
    torch.testing.assert_close(dx.float(), wdx.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(dscale.float(), wds.float(), rtol=tol,
                               atol=10 * tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(4096, 7168), (64, 128), (3, 2560)])
def test_one_block_is_the_whole_row_kernels_bits(cuda, dtype, rows, d):
    """With every column on one rank (d == d_total) the split kernels
    give the whole-row kernels' bits, forward and backward: the
    partitioned step at 1 x 1 is the whole step."""
    x, scale, dy = _inputs(rows, d, dtype, cuda, seed=3)
    y, dx, dscale = _split(CUDA, x, scale, dy, 1)
    assert torch.equal(y, rms_ops.rmsnorm_cuda(x, scale, EPS))
    wdx, wds = rms_ops.rmsnorm_bwd_cuda(x, None, dy, scale, EPS)
    assert torch.equal(dx, wdx) and torch.equal(dscale, wds)


@pytest.mark.gpu
def test_split_row_kernels_count_their_launches(cuda):
    x, scale, dy = _inputs(8, 256, torch.bfloat16, cuda)
    before = dict(rms_ops.row_launches)
    whole = (rms_ops.launches, rms_ops.bwd_launches)
    _split(CUDA, x, scale, dy, 2)
    assert rms_ops.row_launches == {
        "rmsnorm_row_stat": before["rmsnorm_row_stat"] + 4,
        "rmsnorm_row_fwd": before["rmsnorm_row_fwd"] + 2,
        "rmsnorm_row_bwd": before["rmsnorm_row_bwd"] + 2}
    assert (rms_ops.launches, rms_ops.bwd_launches) == whole
