"""The port's kernels: plain versions against the JAX package's Pallas
kernels (interpret mode) and oracles on the CPU; the CUDA kernels
(RMSNorm plain and fused with the residual add, flash attention, the
MoE dispatch, SSD intra-chunk) against the plain versions on a card
(``gpu`` marker, skipped here).  The MoE and SSD plain versions' CPU
parity tests are in ``test_torch_moe.py`` and ``test_torch_hybrid.py``.

JAX is imported inside the CPU parity tests only, so the ``gpu`` tests
also run on a machine without JAX:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py``.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops as dispatch_ops  # noqa: E402
from repro_torch.kernels.moe_dispatch.ref import moe_dispatch_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import (  # noqa: E402
    add_rmsnorm_ref, rmsnorm_ref)
from repro_torch.kernels.ssm_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssd_intra_ref  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels and oracles."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.ops import flash_attention
    from repro.kernels.flash_attention.ref import attention_ref as attn_ref
    from repro.kernels.rmsnorm.ops import rmsnorm
    from repro.kernels.rmsnorm.ref import rmsnorm_ref as rms_ref
    from repro.models.common import rmsnorm as model_rmsnorm
    return types.SimpleNamespace(jnp=jnp, flash=flash_attention,
                                 attn_ref=attn_ref, rmsnorm=rmsnorm,
                                 rms_ref=rms_ref, model_rmsnorm=model_rmsnorm)


def _pair(jx, a: np.ndarray, dtype: str):
    """The same values as a torch and a jax array of `dtype` (both cast
    from fp32 with round-to-nearest-even)."""
    return (torch.from_numpy(a).to(DTYPES[dtype]),
            jx.jnp.asarray(a).astype(getattr(jx.jnp, dtype)))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("R,d", [(64, 128), (33, 256), (4, 3072)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(jx, R, d, dtype):
    rng = np.random.default_rng(1)
    x, xj = _pair(jx, rng.standard_normal((R, d), np.float32), dtype)
    s, sj = _pair(jx, rng.standard_normal(d, np.float32), dtype)
    got = _f32(rmsnorm_ref(x, s))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (jx.rmsnorm(xj, sj), jx.rms_ref(xj, sj)):
        np.testing.assert_allclose(got, _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("R,d", [(64, 128), (33, 256), (2, 2048),
                                 (4, 3072)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rmsnorm_plain_matches_jax_model(jx, R, d, dtype):
    """The fused form's plain path against the JAX model's residual add
    and ``repro.models.common.rmsnorm``: s bit-exact, y within tol."""
    rng = np.random.default_rng(4)
    x, xj = _pair(jx, rng.standard_normal((R, d), np.float32), dtype)
    h, hj = _pair(jx, rng.standard_normal((R, d), np.float32), dtype)
    g, gj = _pair(jx, rng.standard_normal(d, np.float32), dtype)
    s, y = rms_ops.add_rmsnorm(x, h, g)
    sj = xj + hj
    assert s.dtype == y.dtype == x.dtype
    assert np.array_equal(_f32(s), _f32(sj))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(y), _f32(jx.model_rmsnorm(sj, gj)),
                               atol=tol, rtol=tol)


FLASH_CASES = [  # B, S, H, KV, D, causal, window
    (1, 128, 4, 4, 96, True, None),      # phi3 head_dim
    (1, 128, 4, 2, 96, True, 64),        # GQA + window, D=96
    (2, 128, 4, 2, 64, True, None),      # GQA
    (1, 128, 2, 2, 32, False, None),     # non-causal
    (1, 128, 4, 4, 112, True, None),     # zamba2 head_dim
    (1, 128, 4, 4, 112, True, 48),       # D=112 + window
    # the bf16 kernel's 64 x 64 tiles: a window crossing tile borders,
    # GQA at D=112
    (1, 256, 4, 4, 96, True, 80),
    (1, 256, 4, 2, 112, True, None),
]


@pytest.mark.parametrize("B,S,H,KV,D,causal,window", FLASH_CASES)
def test_flash_plain_matches_pallas(jx, B, S, H, KV, D, causal, window):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, S, H, D), np.float32)
    k = rng.standard_normal((B, S, KV, D), np.float32)
    v = rng.standard_normal((B, S, KV, D), np.float32)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal,
                        window=window).numpy()
    jnp = jx.jnp
    pallas = jx.flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, window=window, bq=64, bk=64)
    oracle = jx.attn_ref(*(jnp.asarray(a).transpose(0, 2, 1, 3)
                           for a in (q, k, v)),
                         causal=causal, window=window).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, _f32(pallas), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, _f32(oracle), atol=2e-5, rtol=2e-5)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x = torch.randn(8, 128)
    s = torch.randn(128)
    q = torch.randn(1, 64, 2, 32)
    r0, f0, m0 = rms_ops.launches, fa_ops.launches, dispatch_ops.launches
    routes = dict(fa_ops.launches_by_route)
    forms = dict(rms_ops.launches_by_form)
    assert torch.equal(rms_ops.rmsnorm(x, s), rmsnorm_ref(x, s))
    for got, want in zip(rms_ops.add_rmsnorm(x, x.flip(0), s),
                         add_rmsnorm_ref(x, x.flip(0), s)):
        assert torch.equal(got, want)
    assert torch.equal(fa_ops.flash_attention(q, q, q),
                       attention_ref(q, q, q))
    assert torch.equal(fa_ops.flash_attention(q.bfloat16(), q.bfloat16(),
                                              q.bfloat16()),
                       attention_ref(q.bfloat16(), q.bfloat16(),
                                     q.bfloat16()))
    eidx = torch.tensor([[0, 1], [1, 0], [1, 2]])
    for got, want in zip(dispatch_ops.moe_dispatch(eidx, x[:3], 4, 2),
                         moe_dispatch_ref(eidx, x[:3], 4, 2)):
        assert torch.equal(got, want)
    assert (rms_ops.launches, fa_ops.launches, dispatch_ops.launches) \
        == (r0, f0, m0)
    assert fa_ops.launches_by_route == routes
    assert rms_ops.launches_by_form == forms


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA entry points never fall back to the plain version."""
    x = torch.randn(4, 128)
    with pytest.raises(ValueError):
        rms_ops.rmsnorm_cuda(x, torch.ones(128))
    with pytest.raises(ValueError):
        rms_ops.add_rmsnorm_cuda(x, x, torch.ones(128))
    q = torch.randn(1, 64, 2, 32)
    with pytest.raises(ValueError):
        fa_ops.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError):
        dispatch_ops.moe_dispatch_cuda(torch.zeros(4, 2, dtype=torch.long),
                                       x, 2, 4)
    cum = torch.zeros(1, 1, 8, 2)
    with pytest.raises(ValueError):
        ssd_ops.ssd_intra_cuda(cum, torch.zeros(1, 1, 8, 2, 4),
                               torch.zeros(1, 1, 8, 4),
                               torch.zeros(1, 1, 8, 4))


# the model widths (deepseek, phi3, zamba2, zamba2's inner norm) and
# edges of the kernel's thread and register plan
NORM_WIDTHS = [2048, 3072, 3584, 7168, 64, 1000, 16384]


@pytest.mark.gpu
@pytest.mark.parametrize("R", [4, 128, 256, 33])
@pytest.mark.parametrize("d", NORM_WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain(cuda, R, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    tdt = DTYPES[dtype]
    x = torch.randn(R, d, generator=g, device=cuda).to(tdt)
    s = torch.randn(d, generator=g, device=cuda).to(tdt)
    n0 = rms_ops.launches
    got = rms_ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rms_ops.launches == n0 + 1
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), rmsnorm_ref(x, s).float(),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 2, 128, 33])
@pytest.mark.parametrize("d", NORM_WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rmsnorm_kernel_matches_plain(cuda, R, d, dtype):
    """s bit-exact with torch's x + h, y within tol of the plain norm of
    it; one launch, counted on the fused form."""
    g = torch.Generator(device=cuda).manual_seed(0)
    tdt = DTYPES[dtype]
    x, h = (torch.randn(R, d, generator=g, device=cuda).to(tdt)
            for _ in range(2))
    scale = torch.randn(d, generator=g, device=cuda).to(tdt)
    before = dict(rms_ops.launches_by_form)
    s, y = rms_ops.add_rmsnorm(x, h, scale)
    torch.cuda.synchronize()
    assert rms_ops.launches_by_form == dict(
        before, add_rmsnorm=before["add_rmsnorm"] + 1)
    assert torch.equal(s, x + h)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(y.float(), rmsnorm_ref(x + h, scale).float(),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", FLASH_CASES + [
    (1, 256, 32, 32, 96, True, None), (1, 100, 4, 4, 128, True, None),
    (1, 65, 32, 32, 112, True, None), (2, 100, 4, 2, 16, True, 40),
    (1, 64, 4, 4, 48, False, None), (1, 80, 4, 4, 80, True, None),
    # edges of the bf16 kernel's tiles: ragged query and key tiles, kv
    # tiles through the ring with GQA, a window across 64-key borders;
    # the last four have enough blocks for the 128 x 128 tiles
    (1, 200, 4, 4, 112, True, None), (1, 65, 4, 4, 112, True, 40),
    (1, 256, 4, 4, 96, True, 40), (1, 1024, 32, 8, 128, True, None),
    (1, 1000, 32, 8, 112, True, None), (1, 2048, 16, 16, 96, True, 200),
    (2, 1024, 16, 4, 64, True, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain(cuda, B, S, H, KV, D, causal, window,
                                    dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    tdt = DTYPES[dtype]
    q = torch.randn(B, S, H, D, generator=g, device=cuda).to(tdt)
    k = torch.randn(B, S, KV, D, generator=g, device=cuda).to(tdt)
    v = torch.randn(B, S, KV, D, generator=g, device=cuda).to(tdt)
    n0 = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == n0 + 1
    tol = 2e-5 if dtype == "float32" else 2e-2
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_flash_routes_by_dtype(cuda):
    """bf16 runs on the tensor-core (wgmma) route, fp32 on the FMA
    route; each call counts once, on its own route."""
    for dtype, route in ((torch.bfloat16, "wgmma"), (torch.float32, "fma")):
        q = torch.randn(1, 128, 4, 64, device=cuda, dtype=dtype)
        before = dict(fa_ops.launches_by_route)
        fa_ops.flash_attention(q, q, q)
        torch.cuda.synchronize()
        after = fa_ops.launches_by_route
        assert {r: after[r] - before[r] for r in after} == {
            r: int(r == route) for r in after}


@pytest.mark.gpu
def test_cuda_wrappers_raise_on_bad_input(cuda):
    x = torch.randn(4, 3072, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        rms_ops.rmsnorm(x, torch.ones(3072, device=cuda, dtype=torch.float16))
    q = torch.randn(1, 64, 2, 72, device=cuda)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q, q)
    wide = torch.randn(2, 32768 + 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # over-wide row
        rms_ops.add_rmsnorm(wide, wide, wide[0].contiguous())
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(wide.float(), wide[0].float().contiguous())
    with pytest.raises(TypeError):                      # mixed dtypes
        rms_ops.add_rmsnorm(wide[:, :64], wide[:, :64].float(),
                            wide[0, :64].contiguous())
    x = torch.randn(8, 4, device=cuda)       # a row of 16 bytes is fine
    eidx = torch.zeros(8, 2, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):                      # eidx not int64
        dispatch_ops.moe_dispatch(eidx.int(), x, 2, 4)
    with pytest.raises(ValueError):                     # 24-byte rows
        dispatch_ops.moe_dispatch(eidx, torch.randn(8, 6, device=cuda), 2, 4)
    with pytest.raises(ValueError):                     # T differs
        dispatch_ops.moe_dispatch(eidx[:4], x, 2, 4)
    cum = torch.zeros(1, 1, 8, 2, device=cuda)
    with pytest.raises(ValueError):                          # P = 6
        ssd_ops.ssd_intra(cum, torch.zeros(1, 1, 8, 2, 6, device=cuda),
                          torch.zeros(1, 1, 8, 4, device=cuda),
                          torch.zeros(1, 1, 8, 4, device=cuda))


DISPATCH_CASES = [  # T, d, E, k, C: deepseek-moe-16b's decode, chunk and
    # prefill capacities (8, 8, 16), an ample C (no drops), a long
    # prefill of N = 24576 pairs, small edges
    (1, 2048, 64, 6, 8), (2, 2048, 64, 6, 8), (64, 2048, 64, 6, 8),
    (128, 2048, 64, 6, 16), (128, 2048, 64, 6, 128),
    (4096, 2048, 64, 6, 480), (33, 128, 8, 2, 3), (200, 64, 4, 3, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("T,d,E,k,C", DISPATCH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_kernel_bit_exact(cuda, T, d, E, k, C, dtype):
    """The fused dispatch (sort + capacity cut + gather, the kernel that
    replaced the standalone gather) against the plain version: buf,
    dest_tk and counts bit-exact, empty slots zero, one launch.  Routing
    is top-k of skewed random scores, so popular experts overflow C."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(T, d, generator=g, device=cuda).to(DTYPES[dtype])
    bias = torch.linspace(2, 0, E, device=cuda)
    eidx = torch.topk(torch.rand(T, E, generator=g, device=cuda) + bias, k,
                      dim=-1).indices
    n0 = dispatch_ops.launches
    got = dispatch_ops.moe_dispatch(eidx, x, E, C)
    torch.cuda.synchronize()
    assert dispatch_ops.launches == n0 + 1
    want = moe_dispatch_ref(eidx, x, E, C)
    for name, a, b in zip(("buf", "dest_tk", "counts"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


SSD_CASES = [  # B, nc, Q, H, P, N: zamba2-7b's prefill chunks and edges
    (1, 1, 64, 112, 64, 64), (1, 1, 65, 112, 64, 64),
    (1, 1, 128, 112, 64, 64), (1, 2, 256, 112, 64, 64),
    (2, 3, 13, 3, 8, 4), (1, 2, 16, 8, 32, 16), (1, 1, 40, 2, 128, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,nc,Q,H,P,N", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, B, nc, Q, H, P, N):
    g = torch.Generator(device=cuda).manual_seed(0)
    cum = torch.cumsum(-torch.rand(B, nc, Q, H, generator=g, device=cuda),
                       dim=2)
    xdt = torch.randn(B, nc, Q, H, P, generator=g, device=cuda)
    Bc = torch.randn(B, nc, Q, N, generator=g, device=cuda)
    Cc = torch.randn(B, nc, Q, N, generator=g, device=cuda)
    n0 = ssd_ops.launches
    y, s = ssd_ops.ssd_intra(cum, xdt, Bc, Cc)
    torch.cuda.synchronize()
    assert ssd_ops.launches == n0 + 1
    yr, sr = ssd_intra_ref(cum, xdt, Bc, Cc)
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, sr, atol=1e-4, rtol=1e-4)
