"""Int8 KV-cache decode attention wrapper: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors.

``decode_attention_q8(q, cache, cache_len, window=)`` takes q [B,1,Hq,D]
(bf16 or fp32), a cache of int8 ``k``, ``v`` [B,Smax,KV,D] and fp16
``k_scale``, ``v_scale`` [B,Smax,KV], and the per-slot or scalar length
including the token being decoded; it returns [B,1,Hq,D] in q's dtype,
as ``decode_attention_q8_ref`` (the twin of the JAX package's
``decode_attention_q8``).  The kernel (``csrc/decode_attention_q8.cu``)
quantizes q, forms the int32 scores, the masked softmax, the quantized
probabilities and the int32 P·V sums itself, in four launches over one
scratch buffer; ``launches`` counts wrapper calls that launched it.
It takes D in ``HEAD_DIMS`` and up to ``MAX_GROUP`` query heads a kv
head, and raises on anything else.
"""
from __future__ import annotations

import ctypes
from typing import Mapping, Optional

import torch

from repro_torch import obs
from repro_torch.kernels import build
from repro_torch.kernels.decode_q8.ref import decode_attention_q8_ref

SOURCE = "src/repro_torch/csrc/decode_attention_q8.cu"
HEAD_DIMS = (32, 80, 96, 128)
MAX_GROUP = 8
# the int32 sums of Smax products of two int8 (|x| <= 127) stay exact
MAX_SMAX = (2 ** 31 - 1) // (127 * 127)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = ([_P, _I] + [_P] * 9 + [_I] * 6
             + [ctypes.c_float, _P])
_WS_ARGTYPES = [_I] * 5

launches = 0


def _decode_attention_q8(q: torch.Tensor, cache: Mapping[str, torch.Tensor],
                         cache_len, *, window: Optional[int] = None
                         ) -> torch.Tensor:
    if q.device.type == "cpu":
        return decode_attention_q8_ref(q, cache, cache_len, window=window)
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
    size = build.function("decode_attention_q8",
                          "decode_attention_q8_workspace", _WS_ARGTYPES,
                          ctypes.c_size_t)(B, KV, G, Smax, D)
    ws = torch.empty(size, dtype=torch.uint8, device=q.device)
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
                  ws.data_ptr(), dbg_s.data_ptr() if debug else None,
                  dbg_pq.data_ptr() if debug else None, B, Smax, KV, G, D,
                  window or 0, 1.0 / (D ** 0.5))
    build.check(err, "decode_attention_q8")
    launches += 1
    if debug:
        return out, dbg_s, dbg_pq
    return out
