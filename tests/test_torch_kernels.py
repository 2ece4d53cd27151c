"""The port's kernels: plain versions against the JAX package's Pallas
kernels (interpret mode) and oracles on the CPU; the CUDA kernels
(RMSNorm, flash attention, MoE gather, SSD intra-chunk) against the
plain versions on a card (``gpu`` marker, skipped here).  The MoE and
SSD plain versions' CPU parity tests are in ``test_torch_moe.py`` and
``test_torch_hybrid.py``.

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
from repro_torch.kernels.moe_dispatch import ops as gather_ops  # noqa: E402
from repro_torch.kernels.moe_dispatch.ref import moe_gather_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
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
    return types.SimpleNamespace(jnp=jnp, flash=flash_attention,
                                 attn_ref=attn_ref, rmsnorm=rmsnorm,
                                 rms_ref=rms_ref)


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


FLASH_CASES = [  # B, S, H, KV, D, causal, window
    (1, 128, 4, 4, 96, True, None),      # phi3 head_dim
    (1, 128, 4, 2, 96, True, 64),        # GQA + window, D=96
    (2, 128, 4, 2, 64, True, None),      # GQA
    (1, 128, 2, 2, 32, False, None),     # non-causal
    (1, 128, 4, 4, 112, True, None),     # zamba2 head_dim
    (1, 128, 4, 4, 112, True, 48),       # D=112 + window
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
    r0, f0 = rms_ops.launches, fa_ops.launches
    assert torch.equal(rms_ops.rmsnorm(x, s), rmsnorm_ref(x, s))
    assert torch.equal(fa_ops.flash_attention(q, q, q),
                       attention_ref(q, q, q))
    assert (rms_ops.launches, fa_ops.launches) == (r0, f0)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA entry points never fall back to the plain version."""
    x = torch.randn(4, 128)
    with pytest.raises(ValueError):
        rms_ops.rmsnorm_cuda(x, torch.ones(128))
    q = torch.randn(1, 64, 2, 32)
    with pytest.raises(ValueError):
        fa_ops.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError):
        gather_ops.moe_gather_cuda(x, torch.zeros(8, dtype=torch.int32), 2,
                                   4)
    cum = torch.zeros(1, 1, 8, 2)
    with pytest.raises(ValueError):
        ssd_ops.ssd_intra_cuda(cum, torch.zeros(1, 1, 8, 2, 4),
                               torch.zeros(1, 1, 8, 4),
                               torch.zeros(1, 1, 8, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("R", [4, 128, 256, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain(cuda, R, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    tdt = DTYPES[dtype]
    x = torch.randn(R, 3072, generator=g, device=cuda).to(tdt)
    s = torch.randn(3072, generator=g, device=cuda).to(tdt)
    n0 = rms_ops.launches
    got = rms_ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rms_ops.launches == n0 + 1
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), rmsnorm_ref(x, s).float(),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", FLASH_CASES + [
    (1, 256, 32, 32, 96, True, None), (1, 100, 4, 4, 128, True, None),
    (1, 65, 32, 32, 112, True, None), (2, 100, 4, 2, 16, True, 40),
    (1, 64, 4, 4, 48, False, None), (1, 80, 4, 4, 80, True, None)])
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
def test_cuda_wrappers_raise_on_bad_input(cuda):
    x = torch.randn(4, 3072, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        rms_ops.rmsnorm(x, torch.ones(3072, device=cuda, dtype=torch.float16))
    q = torch.randn(1, 64, 2, 72, device=cuda)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q, q)
    x = torch.randn(8, 4, device=cuda)       # a row of 16 bytes is fine
    st = torch.zeros(8, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        gather_ops.moe_gather(x, st, 2, 4)
    with pytest.raises(ValueError):
        gather_ops.moe_gather(torch.randn(8, 6, device=cuda),
                              st.int(), 2, 4)
    cum = torch.zeros(1, 1, 8, 2, device=cuda)
    with pytest.raises(ValueError):                          # P = 6
        ssd_ops.ssd_intra(cum, torch.zeros(1, 1, 8, 2, 6, device=cuda),
                          torch.zeros(1, 1, 8, 4, device=cuda),
                          torch.zeros(1, 1, 8, 4, device=cuda))


GATHER_CASES = [  # T, d, E, C: deepseek-moe-16b's decode, chunk, prefill
    (2, 2048, 64, 8), (64, 2048, 64, 8), (128, 2048, 64, 16),
    (33, 128, 8, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("T,d,E,C", GATHER_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_kernel_bit_exact(cuda, T, d, E, C, dtype):
    """Empty (-1), out-of-range (>= T) and duplicate slot indices."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(T, d, generator=g, device=cuda).to(DTYPES[dtype])
    st = torch.full((E * C,), -1, dtype=torch.int32)
    n = min(E * C - 2, T * 3)
    st[:n] = torch.randint(0, T, (n,), generator=torch.Generator()
                           .manual_seed(1), dtype=torch.int32)
    st[n:n + 2] = torch.tensor([T, T + 7], dtype=torch.int32)
    st = st[torch.randperm(E * C, generator=torch.Generator()
                           .manual_seed(2))].to(cuda)
    n0 = gather_ops.launches
    got = gather_ops.moe_gather(x, st, E, C)
    torch.cuda.synchronize()
    assert gather_ops.launches == n0 + 1
    assert torch.equal(got, moe_gather_ref(x, st, E, C))


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
