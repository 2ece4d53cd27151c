"""The port's kernels: plain versions against the JAX package's Pallas
kernels (interpret mode) and oracles on the CPU; the CUDA kernels
(RMSNorm plain and fused with the residual add, flash attention, the
MoE dispatch, SSD intra-chunk, and the backward kernels of RMSNorm,
flash attention, the MoE dispatch and SSD) against the plain versions
on a card (``gpu`` marker, skipped here).  The MoE and SSD plain versions' CPU
parity tests are in ``test_torch_moe.py`` and ``test_torch_hybrid.py``.

JAX is imported inside the CPU parity tests only, so the ``gpu`` tests
also run on a machine without JAX:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py``.
"""
import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref, flash_bwd_ref, flash_fwd_ref)
from repro_torch.kernels.moe_dispatch import ops as dispatch_ops  # noqa: E402
from repro_torch.kernels.moe_dispatch.ref import (  # noqa: E402
    moe_dispatch_bwd_ref, moe_dispatch_ref)
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import (  # noqa: E402
    add_rmsnorm_bwd_ref, add_rmsnorm_ref, rmsnorm_bwd_ref, rmsnorm_ref)
from repro_torch.kernels.ssm_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import (  # noqa: E402
    ssd_intra_bwd_ref, ssd_intra_ref)

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


def test_lib_path_covers_included_headers(tmp_path, monkeypatch):
    """Both flash sources include csrc/hopper.cuh: an edit of that header,
    or of a header it includes, changes both libraries' paths (so a
    stale library is never loaded) and leaves a source that includes
    neither alone."""
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = ("flash_attention", "flash_attention_bwd", "rmsnorm")
    assert [p.name for p in build.sources("flash_attention_bwd")] == [
        "flash_attention_bwd.cu", "hopper.cuh"]

    def paths():
        return [build.lib_path(n) for n in names]

    hdr, inner = csrc / "hopper.cuh", csrc / "inner.cuh"
    first = paths()
    hdr.write_text(hdr.read_text() + '\n#include "inner.cuh"\n')
    inner.write_text("// one\n")
    second = paths()
    inner.write_text("// two\n")
    third = paths()
    for a, b in ((first, second), (second, third)):
        assert a[0] != b[0] and a[1] != b[1] and a[2] == b[2]
    assert len({p.name for p in first + second + third}) == 7


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
    (2, 1024, 16, 4, 64, True, None),
    # a window that leaves some rows no key in their first kv tile (the
    # bf16 kernel once gave those rows NaN at D = 16, 64, 80)
    (1, 256, 8, 2, 64, True, 64), (1, 200, 8, 2, 80, True, 64),
    (1, 96, 2, 2, 16, True, 10), (1, 1024, 32, 8, 80, True, 256),
    # whisper's encoder: non-causal over 1500 frames (ragged tiles)
    (1, 1500, 6, 6, 64, False, None)])
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
    if not causal:
        _assert_normalized(got, want, dtype)


def _assert_normalized(got, want, dtype):
    """Non-causal rows spread their softmax over every key, so |o| is
    small and the absolute bound above is loose: hold max |got - want|
    / max |want| to 1e-2 (bf16, a few output roundings) or 1e-4 (fp32).
    The plain version without the last 28 of 1500 keys reads above 0.1."""
    g, w = got.float(), want.float()
    rel = float((g - w).abs().max() / w.abs().max())
    assert rel <= (1e-4 if dtype == "float32" else 1e-2), rel


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Sk,H,KV,D", [
    (1, 64, 1500, 6, 6, 64), (1, 65, 1500, 6, 6, 64),  # whisper's cross
    (2, 100, 333, 8, 2, 128), (1, 300, 64, 4, 4, 80)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_cross_attention_matches_plain(cuda, B, S, Sk, H, KV,
                                                    D, dtype):
    """Non-causal attention of S queries on Sk != S keys (whisper's
    cross-attention), with keys read from the front of a longer buffer
    whose tail holds NaN: a key past Sk must never be read."""
    g = torch.Generator(device=cuda).manual_seed(1)
    tdt = DTYPES[dtype]
    q = torch.randn(B, S, H, D, generator=g, device=cuda).to(tdt)
    kv = torch.full((2, B, Sk + 70, KV, D), float("nan"), device=cuda,
                    dtype=tdt)
    kv[:, :, :Sk] = torch.randn(2, B, Sk, KV, D, generator=g,
                                device=cuda).to(tdt)
    k, v = kv[0, :, :Sk], kv[1, :, :Sk]
    got = fa_ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == "float32" else 2e-2
    want = attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    _assert_normalized(got, want, dtype)


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
    with pytest.raises(ValueError):                          # Q = 257
        ssd_ops.ssd_intra(torch.zeros(1, 1, 257, 2, device=cuda),
                          torch.zeros(1, 1, 257, 2, 4, device=cuda),
                          torch.zeros(1, 1, 257, 4, device=cuda),
                          torch.zeros(1, 1, 257, 4, device=cuda))


DISPATCH_CASES = [  # T, d, E, k, C: deepseek-moe-16b's decode, chunk and
    # prefill capacities (8, 8, 16), an ample C (no drops), a long
    # prefill of N = 24576 pairs, small edges
    (1, 2048, 64, 6, 8), (2, 2048, 64, 6, 8), (64, 2048, 64, 6, 8),
    (128, 2048, 64, 6, 16), (128, 2048, 64, 6, 128),
    (4096, 2048, 64, 6, 480), (33, 128, 8, 2, 3), (200, 64, 4, 3, 1),
    # olmoe-1b-7b (top-8): its decode, chunk and prefill capacities, a
    # tight C (popular experts drop), an ample C, N = 32768 pairs
    (2, 2048, 64, 8, 8), (32, 2048, 64, 8, 8), (64, 2048, 64, 8, 16),
    (128, 2048, 64, 8, 24), (128, 2048, 64, 8, 128),
    (4096, 2048, 64, 8, 512), (4096, 2048, 64, 8, 640)]


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
    (2, 3, 13, 3, 8, 4), (1, 2, 16, 8, 32, 16), (1, 1, 40, 2, 128, 128),
    # one-token chunks, zamba2's 4096-token context (16 chunks of 256),
    # the narrowest state and head, and ragged shapes: P past one
    # 64-column pass, N past one 64-row pass of state, N not a multiple
    # of 8
    (1, 1, 1, 112, 64, 64), (1, 16, 256, 112, 64, 64),
    (1, 2, 70, 5, 4, 4), (1, 2, 65, 5, 64, 64), (1, 1, 40, 3, 128, 128),
    (1, 1, 130, 7, 100, 72), (1, 1, 130, 7, 100, 40),
    (1, 1, 256, 4, 64, 128)]


def _ssd_case(cuda, B, nc, Q, H, P, N, rate=1.0):
    """Seeded inputs on the card; cum steps are -rate * U(0, 1)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    cum = torch.cumsum(-rate * torch.rand(B, nc, Q, H, generator=g,
                                          device=cuda), dim=2)
    xdt = torch.randn(B, nc, Q, H, P, generator=g, device=cuda)
    Bc = torch.randn(B, nc, Q, N, generator=g, device=cuda)
    Cc = torch.randn(B, nc, Q, N, generator=g, device=cuda)
    return cum, xdt, Bc, Cc


@pytest.mark.gpu
@pytest.mark.parametrize("B,nc,Q,H,P,N", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, B, nc, Q, H, P, N):
    args = _ssd_case(cuda, B, nc, Q, H, P, N)
    n0 = ssd_ops.launches
    y, s = ssd_ops.ssd_intra(*args)
    torch.cuda.synchronize()
    assert ssd_ops.launches == n0 + 1
    yr, sr = ssd_intra_ref(*args)
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, sr, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("nc,Q", [(1, 256), (2, 65), (1, 1)])
def test_ssd_kernel_steep_decay(cuda, nc, Q):
    """cum steps of up to -10: exp(cum_t - cum_j) above the diagonal
    overflows to inf, so a mask applied after exp would give NaN."""
    args = _ssd_case(cuda, 1, nc, Q, 112, 64, 64, rate=10.0)
    y, s = ssd_ops.ssd_intra(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    yr, sr = ssd_intra_ref(*args)
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, sr, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("Q", [1, 13, 64])
def test_ssd_plain_steep_decay_matches_jax(Q):
    """The plain version (the wrapper's CPU path) against the JAX
    package's reference where exp past the diagonal overflows: finite,
    within 1e-4."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ssm_scan.ref import ssd_intra_ref as jax_ref
    rng = np.random.default_rng(7)
    cum = np.cumsum(-10 * rng.random((1, 2, Q, 3)), axis=2).astype(
        np.float32)
    xdt = rng.standard_normal((1, 2, Q, 3, 8)).astype(np.float32)
    Bc, Cc = (rng.standard_normal((1, 2, Q, 4)).astype(np.float32)
              for _ in range(2))
    args = (cum, xdt, Bc, Cc)
    y, s = ssd_ops.ssd_intra(*(torch.from_numpy(a) for a in args))
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    yj, sj = jax_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.gpu
def test_kernel_timing_never_syncs_in_graph_capture(cuda):
    """With kernel timing on, an eager call of a wrapper is counted and
    timed; a call captured in a CUDA graph is counted but not timed (a
    sync would break the capture), and the graph's replay runs it."""
    from repro_torch import obs
    x = torch.randn(64, 3072, device=cuda).to(torch.bfloat16)
    w = torch.randn(3072, device=cuda).to(torch.bfloat16)
    obs.metrics.reset()
    obs.enable_kernel_timing()
    try:
        want = rms_ops.rmsnorm(x, w)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            rms_ops.rmsnorm(x, w)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = rms_ops.rmsnorm(x, w)
        graph.replay()
        torch.cuda.synchronize()
        snap = obs.metrics.snapshot()
    finally:
        obs.disable_kernel_timing()
        obs.metrics.reset()
    assert snap["kernels.rmsnorm.launches"]["value"] == 3
    assert snap["kernels.rmsnorm.time_s"]["count"] == 2
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# backward kernels (training): FA-2 and RMSNorm, against their plain
# versions on the same inputs; fp32 at 1e-4; bf16 at 2e-2 (the flash
# kernel rounds P and dS to bf16 before the dV, dK and dQ products, as
# the tensor cores take them, where the plain version keeps them in fp32;
# both sum in fp32 and round once to bf16)
# ---------------------------------------------------------------------------

FLASH_BWD_CASES = [  # B, S, H, KV, D, causal, window
    (1, 128, 4, 2, 80, True, None),      # danube's head_dim, GQA
    (1, 200, 8, 2, 80, True, 64),        # the window binds, ragged S
    (2, 96, 4, 4, 96, True, None), (1, 130, 4, 1, 112, True, 33),
    (1, 64, 4, 4, 128, True, None), (1, 96, 2, 2, 16, True, 10),
    (1, 64, 4, 2, 32, True, None), (1, 70, 2, 2, 48, False, None),
    (1, 64, 2, 1, 64, True, 1), (1, 1024, 32, 8, 80, True, 256),
    (2, 333, 4, 2, 80, True, None),      # ragged last query and key tiles
    (1, 300, 4, 2, 80, True, 40),        # a window below 64
    (1, 384, 4, 1, 96, True, 128),       # a window of exactly 128
    (1, 40, 4, 2, 80, True, None),       # S < 64
    (2, 17, 2, 1, 128, False, 8),        # S < 64, no causal mask
    (1, 150, 4, 2, 64, False, 50),       # a window, no causal mask
    (1, 256, 32, 1, 80, True, 100)]      # KV = 1, G = 32


def _qkv(g, B, S, H, KV, D, dtype, fused, device):
    """q [B,S,H,D], k and v [B,S,KV,D]: separate contiguous tensors, or
    strided views of one fused [B, S, (H + 2 KV) D] projection."""
    if not fused:
        return tuple(torch.randn(B, S, h, D, generator=g, device=device)
                     .to(dtype) for h in (H, KV, KV))
    qkv = torch.randn(B, S, (H + 2 * KV) * D, generator=g,
                      device=device).to(dtype)
    q, k, v = qkv.split((H * D, KV * D, KV * D), dim=-1)
    return (q.unflatten(-1, (H, D)), k.unflatten(-1, (KV, D)),
            v.unflatten(-1, (KV, D)))


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_matches_plain(cuda, B, S, H, KV, D, causal,
                                        window, dtype, fused):
    """dq, dk, dv of the kernel against flash_bwd_ref on the same q, k,
    v, out, lse and dO; the forward kernel's LSE against the plain
    one; two runs give the same bits; one launch counted.  `fused`: q, k
    and v are strided views of one projection."""
    g = torch.Generator(device=cuda).manual_seed(1)
    tdt = DTYPES[dtype]
    q, k, v = _qkv(g, B, S, H, KV, D, tdt, fused, cuda)
    assert fused == (not q.is_contiguous())
    do = torch.randn(B, S, H, D, generator=g, device=cuda).to(tdt)
    out, lse = fa_ops.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, with_lse=True)
    assert torch.equal(out, fa_ops.flash_attention_cuda(
        q, k, v, causal=causal, window=window))
    _, lse_ref = flash_fwd_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)
    n0 = fa_ops.bwd_launches
    got = fa_ops.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                          causal=causal, window=window)
    again = fa_ops.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                            causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.bwd_launches == n0 + 2
    want = flash_bwd_ref(q, k, v, out, lse, do, causal=causal,
                         window=window)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for a, b, c in zip(got, again, want):
        assert a.dtype == tdt and torch.equal(a, b)
        torch.testing.assert_close(a.float(), c.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Sk,H,KV,D", [
    (1, 130, 77, 4, 2, 64),        # ragged tiles on both sides
    (1, 300, 1500, 6, 6, 64),      # whisper's cross-attention heads
    (2, 64, 1500, 6, 6, 64), (1, 100, 333, 8, 2, 128),
    (1, 1500, 1500, 6, 6, 64)])    # whisper's encoder, S = Sk
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_noncausal_matches_plain(cuda, B, S, Sk, H, KV, D,
                                                  dtype):
    """The FA-2 backward without the causal mask (whisper's encoder and
    its cross-attention on Sk != S keys), keys and values read from the
    front of a longer buffer whose tail holds NaN: dk and dv are
    [B, Sk, KV, D], within 1e-2 (bf16) or 1e-4 (fp32) of the plain
    backward relative to their largest entry (non-causal rows spread
    their softmax over every key, so entries are small), the same bits
    twice; the forward's LSE within 1e-4."""
    g = torch.Generator(device=cuda).manual_seed(3)
    tdt = DTYPES[dtype]
    q, do = (torch.randn(B, S, H, D, generator=g, device=cuda).to(tdt)
             for _ in range(2))
    kv = torch.full((2, B, Sk + 70, KV, D), float("nan"), device=cuda,
                    dtype=tdt)
    kv[:, :, :Sk] = torch.randn(2, B, Sk, KV, D, generator=g,
                                device=cuda).to(tdt)
    k, v = kv[0, :, :Sk], kv[1, :, :Sk]
    out, lse = fa_ops.flash_attention_cuda(q, k, v, causal=False,
                                           with_lse=True)
    _, lse_ref = flash_fwd_ref(q, k, v, causal=False)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)
    got = fa_ops.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                          causal=False)
    again = fa_ops.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                            causal=False)
    want = flash_bwd_ref(q, k, v, out, lse, do, causal=False)
    tol = 1e-4 if dtype == "float32" else 1e-2
    for a, b, c in zip(got, again, want):
        assert a.shape == c.shape and a.dtype == tdt and torch.equal(a, b)
        assert bool(torch.isfinite(a).all())
        rel = float((a.float() - c.float()).abs().max()
                    / c.float().abs().max())
        assert rel <= tol, rel
    assert got[1].shape == (B, Sk, KV, D)


@pytest.mark.gpu
def test_flash_autograd_on_cuda_runs_the_kernels(cuda):
    """Grads through the wrapper on CUDA: the forward writes the LSE,
    the backward kernel runs once, and the grads equal the plain
    autograd of attention_ref (fp32)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(1, 96, h, 80, generator=g, device=cuda,
                           requires_grad=True) for h in (8, 2, 2))
    do = torch.randn(1, 96, 8, 80, generator=g, device=cuda)
    n0, b0 = fa_ops.launches, fa_ops.bwd_launches
    got = torch.autograd.grad(fa_ops.flash_attention(q, k, v, window=40),
                              (q, k, v), do)
    assert (fa_ops.launches, fa_ops.bwd_launches) == (n0 + 1, b0 + 1)
    want = torch.autograd.grad(attention_ref(q, k, v, window=40),
                               (q, k, v), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_rmsnorm_autograd_on_cuda_runs_the_kernels(cuda):
    """Grads through both forms' wrappers on CUDA: each call is its
    autograd Function, the backward kernel runs once per form that took
    a gradient through y (none when only the sum did), and the grads
    equal the plain autograd of the plain versions (fp32)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x, h = (torch.randn(5, 2560, generator=g, device=cuda,
                        requires_grad=True) for _ in range(2))
    w = torch.randn(2560, generator=g, device=cuda, requires_grad=True)
    dy, ds = (torch.randn(5, 2560, generator=g, device=cuda)
              for _ in range(2))
    before = dict(rms_ops.bwd_launches_by_form)
    y = rms_ops.rmsnorm(x, w)
    s, y2 = rms_ops.add_rmsnorm(x, h, w)
    assert type(y.grad_fn).__name__ == "_RmsNormBackward"
    assert type(y2.grad_fn).__name__ == "_AddRmsNormBackward"
    got = torch.autograd.grad((y * dy).sum() + (s * ds).sum()
                              + (y2 * dy).sum(), (x, h, w))
    s_only = torch.autograd.grad((rms_ops.add_rmsnorm(x, h, w)[0]
                                  * ds).sum(), (x, h))
    assert rms_ops.bwd_launches_by_form == {
        "rmsnorm": before["rmsnorm"] + 1,
        "add_rmsnorm": before["add_rmsnorm"] + 1}
    sr, yr2 = add_rmsnorm_ref(x, h, w)
    want = torch.autograd.grad((rmsnorm_ref(x, w) * dy).sum()
                               + (sr * ds).sum() + (yr2 * dy).sum(),
                               (x, h, w))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    assert torch.equal(s_only[0], ds) and torch.equal(s_only[1], ds)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 33, 4096])
@pytest.mark.parametrize("d", [2560, 3072, 64, 1000, 16384])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, R, d, dtype, fused):
    """dx (dh of the fused form) and dscale against the plain backward;
    two runs give the same bits (no float atomics)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    tdt = DTYPES[dtype]
    x, dy, ds = (torch.randn(R, d, generator=g, device=cuda).to(tdt)
                 for _ in range(3))
    w = torch.randn(d, generator=g, device=cuda).to(tdt)
    before = dict(rms_ops.bwd_launches_by_form)
    got = rms_ops.rmsnorm_bwd_cuda(x, ds if fused else None, dy, w)
    again = rms_ops.rmsnorm_bwd_cuda(x, ds if fused else None, dy, w)
    torch.cuda.synchronize()
    form = "add_rmsnorm" if fused else "rmsnorm"
    assert rms_ops.bwd_launches_by_form[form] == before[form] + 2
    want = (add_rmsnorm_bwd_ref(x, ds, dy, w) if fused
            else rmsnorm_bwd_ref(x, w, dy))
    tol = 1e-4 if dtype == "float32" else 2e-2
    for a, b, c in zip(got, again, want):
        assert a.dtype == tdt and torch.equal(a, b)
        # dscale sums R rows: its tolerance grows with sqrt(R)
        t = tol * (1 + (R ** 0.5 if a.dim() == 1 else 0))
        torch.testing.assert_close(a.float(), c.float(), atol=t, rtol=tol)


DISPATCH_BWD_CASES = DISPATCH_CASES + [  # olmoe's and deepseek's train
    # step: 4096 tokens, the model's capacity (drops) and an ample one
    (4096, 2048, 64, 8, 640), (4096, 2048, 64, 6, 480),
    (4096, 2048, 64, 6, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("T,d,E,k,C", DISPATCH_BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dispatch_bwd_kernel_bit_exact(cuda, T, d, E, k, C, dtype):
    """The dispatch's backward (a gather-sum of each token's buffer rows)
    against its plain version, bit-exact in dx, two runs the same bits,
    one launch each."""
    g = torch.Generator(device=cuda).manual_seed(1)
    bias = torch.linspace(2, 0, E, device=cuda)
    eidx = torch.topk(torch.rand(T, E, generator=g, device=cuda) + bias, k,
                      dim=-1).indices
    _, dest_tk, _ = moe_dispatch_ref(eidx, torch.zeros(T, d, device=cuda),
                                     E, C)
    dbuf = torch.randn(E, C, d, generator=g, device=cuda).to(DTYPES[dtype])
    n0 = dispatch_ops.bwd_launches
    got = dispatch_ops.moe_dispatch_bwd_cuda(dbuf, dest_tk, T, k)
    again = dispatch_ops.moe_dispatch_bwd_cuda(dbuf, dest_tk, T, k)
    torch.cuda.synchronize()
    assert dispatch_ops.bwd_launches == n0 + 2
    want = moe_dispatch_bwd_ref(dbuf, dest_tk, T, k)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want) and torch.equal(got, again)


def _ssd_grads(cuda, B, nc, Q, H, P, N):
    g = torch.Generator(device=cuda).manual_seed(2)
    return (torch.randn(B, nc, Q, H, P, generator=g, device=cuda),
            torch.randn(B, nc, H, N, P, generator=g, device=cuda))


# the backward's structure: a keys block walks up to 16 heads of a group
# (groups of 1 to 16 heads, 113 heads in groups that do not divide it),
# the fold adds the groups' partials; Q of 1, 13, 65, 200 and 256 (one
# to four 64-row tiles, ragged last tiles); B 2 with several chunks;
# N and P at 4 and at 128 (one and two 64-column passes)
SSD_BWD_CASES = [  # B, nc, Q, H, P, N
    (1, 2, 256, 1, 64, 64), (1, 2, 256, 3, 64, 64), (2, 2, 200, 5, 64, 64),
    (1, 2, 256, 113, 64, 64), (1, 1, 13, 113, 64, 64),
    (2, 3, 65, 3, 64, 64), (2, 2, 256, 113, 64, 64), (1, 1, 1, 5, 4, 4),
    (2, 2, 200, 3, 4, 128), (1, 2, 130, 5, 128, 4),
    (1, 2, 256, 7, 128, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,nc,Q,H,P,N", SSD_CASES + SSD_BWD_CASES)
@pytest.mark.parametrize("rate,zero", [(1.0, None), (10.0, None),
                                       (1.0, "dS"), (1.0, "dy")],
                         ids=["1.0", "10.0", "1.0-dS0", "1.0-dy0"])
def test_ssd_bwd_kernel_matches_plain(cuda, B, nc, Q, H, P, N, rate, zero):
    """(dcum, dxdt, dB, dC) of the SSD backward kernel against the plain
    backward in fp64: max |got - want| <= 1e-4 max |want| for each;
    steep decay (rate 10) overflows exp past the diagonal, which the
    kernel masks first; dS all zero with dy random, and the reverse; two
    runs the same bits, one launch each."""
    args = _ssd_case(cuda, B, nc, Q, H, P, N, rate=rate)
    dy, dS = _ssd_grads(cuda, B, nc, Q, H, P, N)
    if zero == "dS":
        dS = torch.zeros_like(dS)
    elif zero == "dy":
        dy = torch.zeros_like(dy)
    n0 = ssd_ops.bwd_launches
    got = ssd_ops.ssd_intra_bwd_cuda(*args, dy, dS)
    again = ssd_ops.ssd_intra_bwd_cuda(*args, dy, dS)
    torch.cuda.synchronize()
    assert ssd_ops.bwd_launches == n0 + 2
    want = ssd_intra_bwd_ref(*(t.double() for t in (*args, dy, dS)))
    for name, a, b, w in zip(("dcum", "dxdt", "dB", "dC"), got, again, want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        assert torch.equal(a, b), name
        assert bool(torch.isfinite(a).all()), name
        err = float((a.double() - w).abs().max())
        assert err <= 1e-4 * max(float(w.abs().max()), 1e-30), (name, err)


@pytest.mark.gpu
def test_moe_and_ssd_autograd_on_cuda_run_the_kernels(cuda):
    """Under grad on CUDA the dispatch and SSD wrappers run their
    autograd Functions: one forward and one backward launch each, the
    grads equal their plain backwards (the dispatch's bit for bit, SSD's
    within 1e-4 of each grad's largest entry); an output that takes no
    gradient (SSD's S) is fed as zeros."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(64, 256, generator=g, device=cuda, requires_grad=True)
    eidx = torch.topk(torch.rand(64, 16, generator=g, device=cuda), 4,
                      dim=-1).indices
    f0, b0 = dispatch_ops.launches, dispatch_ops.bwd_launches
    buf, dest_tk, counts = dispatch_ops.moe_dispatch(eidx, x, 16, 12)
    assert not dest_tk.requires_grad and not counts.requires_grad
    dbuf = torch.randn(buf.shape, generator=g, device=cuda)
    dx, = torch.autograd.grad(buf, x, dbuf)
    assert (dispatch_ops.launches, dispatch_ops.bwd_launches) == (f0 + 1,
                                                                 b0 + 1)
    assert torch.equal(dx, moe_dispatch_bwd_ref(dbuf, dest_tk, 64, 4))
    ins = [t.requires_grad_() for t in _ssd_case(cuda, 1, 2, 65, 5, 64, 64)]
    f0, b0 = ssd_ops.launches, ssd_ops.bwd_launches
    y, _s = ssd_ops.ssd_intra(*ins)
    dy = torch.randn(y.shape, generator=g, device=cuda)
    got = torch.autograd.grad(y, ins, dy)
    assert (ssd_ops.launches, ssd_ops.bwd_launches) == (f0 + 1, b0 + 1)
    want = ssd_intra_bwd_ref(*(t.detach() for t in ins), dy,
                             torch.zeros(_s.shape, device=cuda))
    for a, w in zip(got, want):
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())
