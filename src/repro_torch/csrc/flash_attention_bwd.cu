// Flash-attention backward (FlashAttention-2, recompute) for Hopper
// (sm_90a), plain C interface for ctypes.
//
// No Pallas counterpart: it replaces the JAX package's jnp backward
// src/repro/models/attention.py:193 (_flash_bwd, wired through
// jax.custom_vjp at :258), which the JAX trainer runs.  Given q, k, v,
// the forward's output o and its fp32 row log-sum-exp lse (written by
// flash_attention.cu), and dO, it computes what _flash_bwd computes:
//
//   delta_i = sum_d dO[i, d] * o[i, d]
//   P_ij    = exp(scale * q_i . k_j - lse_i) on the mask, 0 off it
//   dV_j    = sum_i P_ij dO_i          dP_ij = dO_i . v_j
//   dS_ij   = P_ij (dP_ij - delta_i) scale
//   dQ_i    = sum_j dS_ij k_j          dK_j  = sum_i dS_ij q_i
//
// with the forward's mask (causal keeps j <= i, a window keeps
// i - j < window), GQA (query head h reads kv head h / G; dK and dV sum
// over the G heads of a group), fp32 accumulation and outputs in the
// input dtype.  Three kernels in one call: delta (a warp per row), dK/dV
// (one block per (b, kv head, key tile of 32); it loops over the G query
// heads and the query tiles the mask lets in and keeps dK and dV in
// registers) and dQ (one block per (b, head, query tile of 32), looping
// over the key tiles the mask lets in).  Every sum runs in a fixed order
// inside one block: no float atomics, so the result is the same bits on
// every run.
//
// What bounds it on this card: per head it does about 14 * D flops per
// unmasked (q, k) pair (S and dP are recomputed by both kernels) on
// 8 * S * D input/output elements: operations, far above the ridge at
// the training shapes.  This first kernel is simple: fp32 FMA from fp32
// tiles in shared memory (bf16 is widened on load), 2 x 4 register
// tiles for S and dP and 2 x (D / 32) float4 tiles for dK, dV and dQ.
// It runs well below the tensor cores' rate; mma/wgmma with TMA is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;        // query rows per tile
constexpr int BK = 32;        // keys per tile
constexpr int kThreads = 128;
constexpr int PP = BK + 1;    // pitch of the P and dS tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;      // contiguous [B, S, H, D]
  const void* dout;   // contiguous [B, S, H, D]
  const float* lse;   // [B, H, S]
  float* delta;       // [B, H, S] scratch
  void* dq;           // contiguous [B, S, H, D]
  void* dk;           // contiguous [B, Sk, KV, D]
  void* dv;
  int S, Sk, H, KV;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window;  // window <= 0: none
  float scale;
};

__device__ __forceinline__ bool valid(const Args& a, int i, int j) {
  bool ok = i < a.S && j < a.Sk;
  if (a.causal) ok = ok && j <= i;
  if (a.window > 0) ok = ok && i - j < a.window;
  return ok;
}

// Stage rows [r0, r0 + ROWS) of a [rows, D] slab (row stride `stride`
// elements, unit stride on D) into shared memory as fp32 with row pitch
// D + 4; rows past `n` are zero.  All 16-byte loads are issued before
// any is converted.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          long long stride, int r0, int n,
                                          int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  constexpr int TOTAL = ROWS * PER_ROW;
  constexpr int PER_THREAD = (TOTAL + kThreads - 1) / kThreads;
  constexpr bool kEven = TOTAL % kThreads == 0;
  uint4 raw[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC;
    raw[i] = (kEven || idx < TOTAL) && r0 + r < n
                 ? __ldg(reinterpret_cast<const uint4*>(
                       src + (r0 + r) * stride + c))
                 : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int idx = tid + i * kThreads;
    if (!kEven && idx >= TOTAL) continue;
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC;
    const T* e = reinterpret_cast<const T*>(&raw[i]);
#pragma unroll
    for (int x = 0; x < VEC; ++x) dst[r * (D + 4) + c + x] = to_f(e[x]);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ void fma4(float4& acc, float s, float4 b) {
  acc.x += s * b.x;
  acc.y += s * b.y;
  acc.z += s * b.z;
  acc.w += s * b.w;
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 4 consecutive elements of a row, from fp32
template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&lo);
  w.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = w;
}

// S = Q K^T and dP = dO V^T of one 32 x 32 tile pair, then P and dS on
// the mask.  Thread tid holds rows ti, ti + 16 (ti = tid / 8) and keys
// tj, tj + 8, tj + 16, tj + 24 (tj = tid % 8); the P and dS tiles go to
// shared memory ([BQ][PP]; ps may be null when only dS is needed).
template <int D>
__device__ __forceinline__ void scores(const Args& a, const float* qs,
                                       const float* dos, const float* ks,
                                       const float* vs, const float* lse_s,
                                       const float* del_s, float* ps,
                                       float* dss, int i0, int j0, int tid) {
  constexpr int P = D + 4;
  const int ti = tid / 8, tj = tid % 8;
  float sacc[2][4], pacc[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) sacc[r][c] = pacc[r][c] = 0.f;
#pragma unroll 2
  for (int dd = 0; dd < D; dd += 4) {
    const float4 q0 = ld4(qs + ti * P + dd), q1 = ld4(qs + (ti + 16) * P + dd);
    const float4 o0 = ld4(dos + ti * P + dd),
                 o1 = ld4(dos + (ti + 16) * P + dd);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 kk = ld4(ks + (tj + 8 * c) * P + dd);
      const float4 vv = ld4(vs + (tj + 8 * c) * P + dd);
      sacc[0][c] += dot4(q0, kk);
      sacc[1][c] += dot4(q1, kk);
      pacc[0][c] += dot4(o0, vv);
      pacc[1][c] += dot4(o1, vv);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ti + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = tj + 8 * c;
      const float p = valid(a, i0 + row, j0 + col)
                          ? expf(sacc[r][c] * a.scale - lse_s[row])
                          : 0.f;
      if (ps != nullptr) ps[row * PP + col] = p;
      dss[row * PP + col] = p * (pacc[r][c] - del_s[row]) * a.scale;
    }
  }
}

// delta[b, h, i] = sum_d dO * o: a warp per (b, i, h) row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(
    Args a, int rows) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = static_cast<const T*>(a.o) + (size_t)row * D;
  const T* g = static_cast<const T*>(a.dout) + (size_t)row * D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc += to_f(g[c]) * to_f(o[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % a.H, bi = row / a.H;   // bi = b * S + i
    const int b = bi / a.S, i = bi % a.S;
    a.delta[((size_t)b * a.H + h) * a.S + i] = acc;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * 32 * (D + 4) + 2 * BQ * PP + 2 * BQ);
}

// One block per (key tile, kv head, b): dK and dV of 32 keys, summed
// over the G query heads of the group and every query tile the mask
// lets in.  Thread tid accumulates keys tk, tk + 16 (tk = tid % 16) and
// the 4-column groups td, td + 8, ... (td = tid / 16).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Args a) {
  constexpr int P = D + 4;
  constexpr int NG = (D / 4 + 7) / 8;   // column groups per thread
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [BK][P]
  float* vs = ks + BK * P;                       // [BK][P]
  float* qs = vs + BK * P;                       // [BQ][P]
  float* dos = qs + BQ * P;                      // [BQ][P]
  float* ps = dos + BQ * P;                      // [BQ][PP]
  float* dss = ps + BQ * PP;                     // [BQ][PP]
  float* lse_s = dss + BQ * PP;                  // [BQ]
  float* del_s = lse_s + BQ;                     // [BQ]
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int tid = threadIdx.x, tk = tid % 16, td = tid / 16;

  load_tile<T, D, BK>(ks, k + b * a.ksb + kvh * a.ksh, a.kss, k0, a.Sk, tid);
  load_tile<T, D, BK>(vs, v + b * a.vsb + kvh * a.vsh, a.vss, k0, a.Sk, tid);

  // query rows whose mask can hold one of these keys: [i_lo, i_hi)
  const int i_lo = a.causal ? k0 / BQ * BQ : 0;
  const int i_hi = a.window > 0 ? min(a.S, k0 + BK - 1 + a.window) : a.S;

  float4 dk[2][NG], dv[2][NG];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int m = 0; m < NG; ++m)
      dk[r][m] = dv[r][m] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lse = a.lse + ((size_t)b * a.H + h) * a.S;
    const float* del = a.delta + ((size_t)b * a.H + h) * a.S;
    for (int i0 = i_lo; i0 < i_hi; i0 += BQ) {
      __syncthreads();   // the previous tile is consumed
      load_tile<T, D, BQ>(qs, q + b * a.qsb + h * a.qsh, a.qss, i0, a.S,
                          tid);
      load_tile<T, D, BQ>(dos, dout + (size_t)b * a.S * a.H * D + h * D,
                          (long long)a.H * D, i0, a.S, tid);
      if (tid < BQ) {
        const int i = i0 + tid;
        lse_s[tid] = i < a.S ? lse[i] : 0.f;
        del_s[tid] = i < a.S ? del[i] : 0.f;
      }
      __syncthreads();
      scores<D>(a, qs, dos, ks, vs, lse_s, del_s, ps, dss, i0, k0, tid);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        const float p0 = ps[i * PP + tk], p1 = ps[i * PP + tk + 16];
        const float s0 = dss[i * PP + tk], s1 = dss[i * PP + tk + 16];
#pragma unroll
        for (int m = 0; m < NG; ++m) {
          const int c = 4 * (td + 8 * m);
          if (c < D) {
            const float4 o4 = ld4(dos + i * P + c);
            const float4 q4 = ld4(qs + i * P + c);
            fma4(dv[0][m], p0, o4);
            fma4(dv[1][m], p1, o4);
            fma4(dk[0][m], s0, q4);
            fma4(dk[1][m], s1, q4);
          }
        }
      }
    }
  }
  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + tk + 16 * r;
    if (j >= a.Sk) continue;
    const size_t base = (((size_t)b * a.Sk + j) * a.KV + kvh) * D;
#pragma unroll
    for (int m = 0; m < NG; ++m) {
      const int c = 4 * (td + 8 * m);
      if (c < D) {
        store4<T>(dkp + base + c, dk[r][m]);
        store4<T>(dvp + base + c, dv[r][m]);
      }
    }
  }
}

// One block per (query tile, head, b): dQ of 32 query rows over every
// key tile the mask lets in.  Thread tid accumulates rows tq, tq + 16
// (tq = tid % 16) and the 4-column groups td, td + 8, ... (td = tid / 16).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int P = D + 4;
  constexpr int NG = (D / 4 + 7) / 8;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + BK * P;
  float* qs = vs + BK * P;
  float* dos = qs + BQ * P;
  float* dss = dos + BQ * P + BQ * PP;   // the P tile is not needed
  float* lse_s = dss + BQ * PP;
  float* del_s = lse_s + BQ;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  const int i0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x, tq = tid % 16, td = tid / 16;

  load_tile<T, D, BQ>(qs, q + b * a.qsb + h * a.qsh, a.qss, i0, a.S, tid);
  load_tile<T, D, BQ>(dos, dout + (size_t)b * a.S * a.H * D + h * D,
                      (long long)a.H * D, i0, a.S, tid);
  if (tid < BQ) {
    const int i = i0 + tid;
    const size_t row = ((size_t)b * a.H + h) * a.S;
    lse_s[tid] = i < a.S ? a.lse[row + i] : 0.f;
    del_s[tid] = i < a.S ? a.delta[row + i] : 0.f;
  }

  // key tiles this block needs: [j_lo, j_hi)
  const int i_last = min(i0 + BQ, a.S) - 1;
  const int j_hi = a.causal ? min(a.Sk, i_last + 1) : a.Sk;
  int j_lo = a.window > 0 ? max(0, i0 - a.window + 1) : 0;
  j_lo = j_lo / BK * BK;

  float4 dq[2][NG];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int m = 0; m < NG; ++m) dq[r][m] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int j0 = j_lo; j0 < j_hi; j0 += BK) {
    __syncthreads();   // the previous tile is consumed (and qs is stored)
    load_tile<T, D, BK>(ks, k + b * a.ksb + kvh * a.ksh, a.kss, j0, a.Sk,
                        tid);
    load_tile<T, D, BK>(vs, v + b * a.vsb + kvh * a.vsh, a.vss, j0, a.Sk,
                        tid);
    __syncthreads();
    scores<D>(a, qs, dos, ks, vs, lse_s, del_s, nullptr, dss, i0, j0, tid);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float s0 = dss[tq * PP + j], s1 = dss[(tq + 16) * PP + j];
#pragma unroll
      for (int m = 0; m < NG; ++m) {
        const int c = 4 * (td + 8 * m);
        if (c < D) {
          const float4 k4 = ld4(ks + j * P + c);
          fma4(dq[0][m], s0, k4);
          fma4(dq[1][m], s1, k4);
        }
      }
    }
  }
  T* dqp = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + tq + 16 * r;
    if (i >= a.S) continue;
    const size_t base = (((size_t)b * a.S + i) * a.H + h) * D;
#pragma unroll
    for (int m = 0; m < NG; ++m) {
      const int c = 4 * (td + 8 * m);
      if (c < D) store4<T>(dqp + base + c, dq[r][m]);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int rows = B * a.S * a.H;
  flash_bwd_delta_kernel<T, D>
      <<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
         stream>>>(a, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<T, D>
      <<<dim3((a.Sk + BK - 1) / BK, a.KV, B), kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<T, D>
      <<<dim3((a.S + BQ - 1) / BQ, a.H, B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, s);
    case 32: return launch<T, 32>(a, B, s);
    case 48: return launch<T, 48>(a, B, s);
    case 64: return launch<T, 64>(a, B, s);
    case 80: return launch<T, 80>(a, B, s);
    case 96: return launch<T, 96>(a, B, s);
    case 112: return launch<T, 112>(a, B, s);
    case 128: return launch<T, 128>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, S, H, D], k/v: [B, Sk, KV, D] with unit stride on D and the
// given element strides on (B, seq, head), 16-byte aligned; o and dout:
// contiguous [B, S, H, D]; lse: fp32 [B, H, S] from flash_attention_fwd;
// delta: fp32 [B, H, S] scratch; dq: contiguous [B, S, H, D]; dk, dv:
// contiguous [B, Sk, KV, D].  D a multiple of 16 up to 128, H % KV == 0.
// dtype: 0 fp32, 1 bf16.  window <= 0 means no window.  Returns
// cudaGetLastError() after the last launch (or the first failed one).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int S, int Sk, int H, int KV, int D, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal,
    int window, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Sk <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, static_cast<const float*>(lse),
         static_cast<float*>(delta), dq, dk, dv, S, Sk, H, KV,
         qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal, window,
         scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, D, s);
  return cudaErrorInvalidValue;
}
