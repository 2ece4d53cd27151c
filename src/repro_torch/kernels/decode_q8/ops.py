"""Int8 KV-cache decode attention wrapper: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors.

``decode_attention_q8(q, cache, cache_len, window=)`` takes q [B,1,Hq,D]
(bf16 or fp32), a cache of int8 ``k``, ``v`` [B,Smax,KV,D] and fp16
``k_scale``, ``v_scale`` [B,Smax,KV], and the per-slot or scalar length
including the token being decoded; it returns [B,1,Hq,D] in q's dtype,
as ``decode_attention_q8_ref`` (the twin of the JAX package's
``decode_attention_q8``).  The kernel (``csrc/decode_attention_q8.cu``)
quantizes q, forms the int32 scores, the masked softmax, the quantized
probabilities and the int32 P·V sums itself, in one launch: a
thread-block cluster a (b, kv), its blocks splitting the positions,
with the scores in shared memory.  ``plan`` picks the form, the cluster
size, the positions a block and the shared bytes from the shape; only a cache whose scores do not fit the blocks' shared
memory takes the scratch form, and only then does the wrapper allocate
more than the output.  ``launches`` counts wrapper calls that launched
the kernel.  It takes D in ``HEAD_DIMS`` and up to ``MAX_GROUP`` query
heads a kv head, and raises on anything else.  Meta tensors (the dry
run) take the plain version for their shapes; each call declares its
cost to an active op-cost walk (``roofline.op_cost.kernel``).
"""
from __future__ import annotations

import ctypes
from typing import Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import build
from repro_torch.kernels.decode_q8.ref import decode_attention_q8_ref
from repro_torch.roofline import op_cost

SOURCE = "src/repro_torch/csrc/decode_attention_q8.cu"
HEAD_DIMS = (32, 80, 96, 128)
MAX_GROUP = 8
# the int32 sums of Smax products of two int8 (|x| <= 127) stay exact
MAX_SMAX = (2 ** 31 - 1) // (127 * 127)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = ([_P, _I] + [_P] * 9 + [_I] * 6 + [ctypes.c_float]
             + [_I] * 4 + [_P])
_OCC_ARGTYPES = [_I] * 6

# the card's limits (H100): dynamic shared memory a block, and shared
# memory an SM, of which each resident block also takes 1 KB
MAX_SMEM_BLOCK = 232_448
SMEM_SM, SMEM_RESERVED = 233_472, 1_024
MAX_CLUSTER = 8            # the portable cluster size
BLOCK_POSITIONS = 512      # a cluster grows by a block for each of these

launches = 0


class Plan(NamedTuple):
    """How the kernel runs one call: ``on_chip`` (the scores in shared
    memory) or the scratch form, ``cluster`` blocks a (b, kv), each
    taking ``block_positions`` of the Smax positions, ``smem_bytes`` of
    dynamic shared memory a block, ``blocks_per_sm`` the occupancy the
    plan aims for, and the scratch the wrapper allocates (0 on chip)."""
    on_chip: bool
    cluster: int
    block_positions: int
    smem_bytes: int
    blocks_per_sm: int
    scratch_bytes: int


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(on_chip: bool, n: int, G: int, D: int) -> int:
    """Dynamic shared memory of one block: the kernel's ``layout``."""
    np_ = _up(n, 32)
    x = 8 * 128 + 2 * 8 * 8 * 4 + _up(np_ // 8, 16) + _up(2 * np_, 16)
    y = max(4 * G * D, 4 * G * (np_ + 4) if on_chip else 0)
    return x + _up(G * (np_ + 16), 16) + _up(y, 16)


def plan(B: int, Smax: int, KV: int, G: int, D: int) -> Plan:
    """A cluster of up to MAX_CLUSTER blocks a (b, kv), a block for each
    BLOCK_POSITIONS positions; the scores in shared memory wherever they
    fit a block (two blocks an SM where they fit so), else the scratch
    form."""
    if Smax > MAX_SMAX:
        raise ValueError(f"decode_attention_q8 kernel takes up to "
                         f"{MAX_SMAX} cache positions, got {Smax}")
    cluster = min(MAX_CLUSTER, -(-Smax // BLOCK_POSITIONS))
    n = -(-Smax // cluster)
    cluster = -(-Smax // n)           # every block has positions
    for on_chip in (True, False):
        smem = smem_bytes(on_chip, n, G, D)
        for per_sm in (2, 1):
            if smem <= min(MAX_SMEM_BLOCK, SMEM_SM // per_sm - SMEM_RESERVED):
                return Plan(on_chip, cluster, n, smem, per_sm,
                            0 if on_chip else 4 * B * KV * G * Smax)
    raise ValueError(f"decode_attention_q8: no plan fits "
                     f"{(B, Smax, KV, G, D)}")


def cost(q: torch.Tensor, cache: Mapping[str, torch.Tensor]
         ) -> Tuple[float, float]:
    """(flops, bytes) of one call from the shapes alone: the int8 k and
    v and their fp16 scales read over all Smax positions, q read and the
    output written once; 4·D operations a query head and position (the
    two products).  The kernel skips masked positions and v rows whose
    probability rounds to 0, which no shape shows."""
    B, _, Hq, D = q.shape
    Smax = cache["k"].shape[1]
    nbytes = op_cost.nbytes(cache["k"], cache["v"], cache["k_scale"],
                            cache["v_scale"]) + 2 * op_cost.nbytes(q)
    return 4.0 * D * Smax * Hq * B, nbytes


def _decode_attention_q8(q: torch.Tensor, cache: Mapping[str, torch.Tensor],
                         cache_len, *, window: Optional[int] = None
                         ) -> torch.Tensor:
    with op_cost.kernel("decode_attention_q8", lambda: cost(q, cache)):
        if q.device.type in ("cpu", "meta"):   # meta: the dry run's shapes
            return decode_attention_q8_ref(q, cache, cache_len,
                                           window=window).contiguous()
        return decode_attention_q8_cuda(q, cache, cache_len, window=window)


decode_attention_q8 = obs.instrument_kernel("decode_attention_q8",
                                            _decode_attention_q8)


def _check_device(*tensors: torch.Tensor) -> None:
    if any(t.device.type != "cuda" or t.device != tensors[0].device
           for t in tensors):
        raise ValueError("decode_attention_q8 kernel needs CUDA tensors on "
                         f"one device, got {[str(t.device) for t in tensors]}")


def _check_inputs(q, k, v, k_scale, v_scale, window) -> None:
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"decode_attention_q8 takes bf16 or fp32 q, got "
                        f"{q.dtype}")
    if k.dtype != torch.int8 or v.dtype != torch.int8 \
            or k_scale.dtype != torch.float16 \
            or v_scale.dtype != torch.float16:
        raise TypeError("decode_attention_q8 needs int8 k, v and fp16 "
                        f"scales, got {k.dtype}, {v.dtype}, {k_scale.dtype}, "
                        f"{v_scale.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 \
            or v.shape != k.shape or k_scale.shape != k.shape[:3] \
            or v_scale.shape != k.shape[:3] or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, k_scale "
                         f"{tuple(k_scale.shape)}, v_scale "
                         f"{tuple(v_scale.shape)}")
    D, G, Smax = q.shape[3], q.shape[2] // k.shape[2], k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention_q8 kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    if not 0 < G <= MAX_GROUP:
        raise ValueError(f"decode_attention_q8 kernel takes up to "
                         f"{MAX_GROUP} query heads a kv head, got {G}")
    if Smax > MAX_SMAX:
        raise ValueError(f"decode_attention_q8 kernel takes up to "
                         f"{MAX_SMAX} cache positions, got {Smax}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    _check_device(q, k, v, k_scale, v_scale)
    if not all(t.is_contiguous() for t in (k, v, k_scale, v_scale)) \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention_q8 kernel needs contiguous "
                         "caches and 16-byte aligned k and v")


def _launch(fn, device: torch.device, *args) -> int:
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def decode_attention_q8_cuda(q: torch.Tensor,
                             cache: Mapping[str, torch.Tensor], cache_len,
                             *, window: Optional[int] = None,
                             debug: bool = False):
    """The kernel.  With `debug`, also returns the int32 scores (0 where
    masked) and pq, [B,KV,G,Smax] each, for checks against the plain
    version."""
    global launches
    k, v = cache["k"], cache["v"]
    k_scale, v_scale = cache["k_scale"], cache["v_scale"]
    _check_inputs(q, k, v, k_scale, v_scale, window)
    B, _, Hq, D = q.shape
    Smax, KV = k.shape[1], k.shape[2]
    G = Hq // KV
    q = q.contiguous()
    lens = torch.as_tensor(cache_len, device=q.device).long().expand(B)
    lens = lens.contiguous()
    pl = plan(B, Smax, KV, G, D)
    scratch = None
    if not pl.on_chip:
        scratch = torch.empty(pl.scratch_bytes // 4, dtype=torch.float32,
                              device=q.device)
    out = torch.empty_like(q)
    dbg_s = dbg_pq = None
    if debug:
        dbg_s = torch.empty((B, KV, G, Smax), dtype=torch.int32,
                            device=q.device)
        dbg_pq = torch.empty((B, KV, G, Smax), dtype=torch.int8,
                             device=q.device)
    fn = build.function("decode_attention_q8", "decode_attention_q8",
                        _ARGTYPES)
    err = _launch(fn, q.device, q.data_ptr(), int(q.dtype == torch.bfloat16),
                  k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                  v_scale.data_ptr(), lens.data_ptr(), out.data_ptr(),
                  None if scratch is None else scratch.data_ptr(),
                  dbg_s.data_ptr() if debug else None,
                  dbg_pq.data_ptr() if debug else None, B, Smax, KV, G, D,
                  window or 0, 1.0 / (D ** 0.5), int(pl.on_chip), pl.cluster,
                  pl.block_positions, pl.smem_bytes)
    build.check(err, "decode_attention_q8")
    launches += 1
    if debug:
        return out, dbg_s, dbg_pq
    return out


def active_clusters(pl: Plan, B: int, KV: int, D: int) -> int:
    """Clusters of the plan that fit on the card at once."""
    fn = build.function("decode_attention_q8",
                        "decode_attention_q8_active_clusters", _OCC_ARGTYPES)
    return fn(D, int(pl.on_chip), pl.cluster, pl.smem_bytes, B, KV)
