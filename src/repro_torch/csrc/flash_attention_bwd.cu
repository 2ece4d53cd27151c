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
// (one block per (b, kv head, key tile); it loops over the G query heads
// and the query tiles the mask lets in and keeps dK and dV in registers)
// and dQ (one block per (b, head, query tile), looping over the key
// tiles the mask lets in).  S and dP are computed by both (14 D flops a
// pair and head against the necessary 10 D) so that every sum runs in a
// fixed order inside one block: no float atomics, the same bits on
// every run.
//
// What bounds it on this card: about 10 D flops per unmasked (q, k)
// pair and head on 8 S D input/output elements: operations, far above
// the ridge at the training shapes.  Two routes, chosen by dtype:
//
// bf16: tensor cores fed by TMA (flash_bwd_dkdv_wgmma, flash_bwd_dq_wgmma;
// the helpers are the forward's, hopper.cuh).  Each block holds two
// consumer warpgroups (64 rows each: wgmma's M) and a producer warpgroup
// whose one issuing thread loads tiles through 4-D tensor maps over the
// strided [B, seq, heads, D] layouts (boxes of 64 columns, 128-byte
// swizzle, zeros past D and seq: D is padded to 64 or 128 in shared
// memory only, and the zero k-steps are skipped) and which gives its
// registers to the consumers (setmaxnreg).  The block's resident tiles
// (K and V of 128 keys, or Q and dO of 128 rows) load once; the streamed
// ones (64 rows) go through a 2-stage ring with full/empty mbarriers, so
// the next tile loads while this one computes.  The dK/dV kernel works
// on transposed scores, S^T = K Q^T, so that P^T and dS^T come out of
// the accumulators in the layout of wgmma's register A operand: dV +=
// P^T dO and dK += dS^T Q take them, rounded to bf16, straight from the
// registers, with dO and Q read MN-major (the forward reads V the same
// way).  The dQ kernel is the forward's structure plus one product:
// S = Q K^T, dP = dO V^T, dQ += dS K.  P is zeroed by a select off the
// mask, only on tiles that hold a masked pair.  Blocks with the most
// tiles under a causal mask start first.
//
// fp32 (the 1e-4 tolerance rules out TF32): the first kernels of the
// port, fp32 FMA from fp32 tiles in shared memory (32-row tiles, 2 x 4
// register tiles for S and dP, 2 x (D / 32) float4 tiles for dK, dV and
// dQ).
#include "hopper.cuh"   // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

using namespace hopper;

constexpr int BQ = 32;        // query rows per tile
constexpr int BK = 32;        // keys per tile
constexpr int kThreads = 128;
constexpr int PP = BK + 1;    // pitch of the P and dS tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

int dispatch_fp32(const Args& a, int B, int D, cudaStream_t s) {
  using T = float;
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

// ---------------------------------------------------------------------------
// bf16 route: wgmma tiles fed by TMA
// ---------------------------------------------------------------------------

constexpr int kRing = 2;            // stages of the streamed tiles
constexpr int kWgThreads = 384;     // 2 consumer warpgroups + a producer one
constexpr int kBig = 128;           // rows of a resident tile (2 x 64)
constexpr int kSmall = 64;          // rows of a streamed tile

struct WgArgs {
  __nv_bfloat16* dq;   // contiguous [B, S, H, D]
  __nv_bfloat16* dk;   // contiguous [B, Sk, KV, D]
  __nv_bfloat16* dv;
  const float* lse;    // [B, H, S]
  const float* delta;  // [B, H, S]
  int S, Sk, H, KV, D, causal, window;
  float scale;         // 1/sqrt(D)
  float scale_log2;    // scale * log2(e): P in base 2
};

// the resident tiles' barrier (TMA bytes landed) and, per ring stage,
// full (bytes landed) and empty (every consumer warp done reading)
struct RingBars {
  uint64_t fixed;
  uint64_t full[kRing], empty[kRing];
};

__device__ __forceinline__ bool on_mask(const WgArgs& a, int i, int j) {
  bool ok = i < a.S && j < a.Sk;
  if (a.causal) ok = ok && j <= i;
  if (a.window > 0) ok = ok && i - j < a.window;
  return ok;
}

// true when a [64 rows of queries from i0] x [64 keys from j0] tile
// holds a pair off the mask (the causal diagonal, a window's edge, rows
// past S or keys past Sk); the other tiles skip the per-pair test
__device__ __forceinline__ bool needs_mask(const WgArgs& a, int i0, int j0) {
  return i0 + 64 > a.S || j0 + 64 > a.Sk || (a.causal && j0 + 63 > i0) ||
         (a.window > 0 && i0 + 63 - j0 >= a.window);
}

// d[64 x 64] = A[64 x 16 KD] B[64 x 16 KD]^T, both K-major (rows
// contiguous along D) in 128-byte-swizzled boxes of 64 columns, `a_box` /
// `b_box` bytes apart; KD = D / 16 k-steps (the zero padding is skipped)
template <int KD>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a_rows,
                                         int a_box, uint32_t b_rows,
                                         int b_box) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n64(d, sw128_desc(a_rows + (kk / 4) * a_box + off, 16),
                 sw128_desc(b_rows + (kk / 4) * b_box + off, 16), kk > 0);
  }
}

// acc[64 x DN] += A[64 x 64] B[64 x DN]: A from registers (bf16 pairs in
// wgmma's fragment order, 4 k-steps of 16), B a 64-row tile read
// MN-major (its rows, contiguous along D, are the k index: the
// transpose bit); a k-step moves 16 rows (2048 bytes), the boxes of B
// are `box` bytes apart.  DN: D rounded up to 64, or D itself above 64
template <int DN>
__device__ __forceinline__ void issue_rs(float (&acc)[DN / 2],
                                         const uint32_t (&fa)[16],
                                         uint32_t b_tile, int box) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t frag[4] = {fa[4 * kk], fa[4 * kk + 1], fa[4 * kk + 2],
                              fa[4 * kk + 3]};
    const uint64_t bd = sw128_desc(b_tile + kk * 16 * 128, box);
    if constexpr (DN == 64)
      wgmma_rs_n64(acc, frag, bd);
    else if constexpr (DN == 80)
      wgmma_rs_n80(acc, frag, bd);
    else if constexpr (DN == 96)
      wgmma_rs_n96(acc, frag, bd);
    else if constexpr (DN == 112)
      wgmma_rs_n112(acc, frag, bd);
    else
      wgmma_rs_n128(acc, frag, bd);
  }
}

// keeps a register operand of an issued wgmma live (and unmoved) up to
// this point of the program: place it after the wait that ends the read
template <int N>
__device__ __forceinline__ void keep_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// fp32 accumulator (wgmma layout) -> bf16 pairs in A-fragment order
__device__ __forceinline__ void pack(const float (&x)[32],
                                     uint32_t (&fa)[16]) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) fa[i / 2] = pack_bf16(x[i], x[i + 1]);
}

// rows r0 and r0 + 8 of a [64 x DN] fp32 accumulator -> bf16 at
// `out` + row * pitch, columns < D, rows < n
template <int DN>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[DN / 2],
                                           size_t pitch, int row0, int r0,
                                           int c0, int n, int D) {
#pragma unroll
  for (int i = 0; i < DN / 2; i += 2) {
    const int row = row0 + r0 + 8 * ((i / 2) % 2), col = 8 * (i / 4) + c0;
    if (row < n && col < D)
      *reinterpret_cast<__nv_bfloat162*>(out + row * pitch + col) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

__device__ __forceinline__ void init_bars(RingBars& bars, uint32_t full) {
  mbar_init(smem_addr(&bars.fixed), 1);
  for (int s = 0; s < kRing; ++s) {
    mbar_init(smem_addr(&bars.full[s]), full);
    mbar_init(smem_addr(&bars.empty[s]), 8);   // the 8 consumer warps
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Accumulator layout of wgmma m64nN (fp32): thread t of a warpgroup
// holds rows r0 = 16 * (t / 32) + (t % 32) / 4 and r0 + 8; register i
// sits at row r0 + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (t % 4) +
// i % 2.  That is also the A-fragment layout of wgmma's register
// operand, so P^T and dS^T go from the score products into the next
// products without leaving the registers.
//
// dK/dV: one block per (kv head, key tile of 128, b); two consumer
// warpgroups of 64 keys each (warps 0-7) and a producer warpgroup (warp 8
// issues, warps 9-11 leave) that hands its registers to them.  K and V
// are loaded once; Q and dO tiles of 64 rows with their 64 lse and delta
// values stream through a 2-stage ring, over the G query heads of the
// group and the query tiles the mask lets in.  Per tile and warpgroup:
// S^T = K Q^T and dP^T = V dO^T (SS), P^T = exp2(S^T scale log2e - lse
// log2e) (0 off the mask), dV += P^T dO (RS, P^T in bf16), dS^T = P^T
// (dP^T - delta) scale, dK += dS^T Q (RS, dS^T in bf16).  dK and dV stay
// in fp32 registers and are written once.
template <int NB, int KD, int DN>
__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dkdv_wgmma(
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap dmap, const WgArgs a) {
  static_assert(KD <= 4 * NB && DN <= 64 * NB, "inside the padded D");
  constexpr int kKeyBox = kBig * kBox * 2;     // one box of K or V
  constexpr int kRowBox = kSmall * kBox * 2;   // one box of a Q or dO tile
  constexpr int kRowTile = NB * kRowBox;
  extern __shared__ uint8_t smem_raw[];
  __shared__ RingBars bars;
  __shared__ float2 lse_s[kRing][32], del_s[kRing][32];   // 64 rows each
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ks = raw + ((1024 - (raw & 1023)) & 1023);   // K tile
  const uint32_t vs = ks + NB * kKeyBox;                      // V tile
  const uint32_t qs = vs + NB * kKeyBox;                      // Q ring
  const uint32_t ds = qs + kRing * kRowTile;                  // dO ring

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // key tiles in order: with a causal mask the first have the most
  // query tiles, so the heavy blocks start first
  const int kvh = blockIdx.x, k0 = blockIdx.y * kBig, b = blockIdx.z;
  const int G = a.H / a.KV;
  // query rows whose mask can hold one of these keys: [i_lo, i_hi), in
  // n tiles of 64 for each of the G heads
  const int i_lo = a.causal ? k0 : 0;
  const int i_hi = a.window > 0 ? min(a.S, k0 + kBig - 1 + a.window) : a.S;
  const int n = i_hi > i_lo ? (i_hi - i_lo + kSmall - 1) / kSmall : 0;
  const int T = G * n;

  if (tid == 0) init_bars(bars, 32);   // full: the producer warp's lanes
  __syncthreads();

  if (warp >= 8) {
    setmaxnreg_dec<40>();
    if (warp != 8 || T == 0) return;
    if (lane == 0) {
      const uint32_t fb = smem_addr(&bars.fixed);
      mbar_expect_tx(fb, 2 * NB * kKeyBox);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        tma_load(ks + c * kKeyBox, &kmap, fb, c * kBox, kvh, k0, b);
        tma_load(vs + c * kKeyBox, &vmap, fb, c * kBox, kvh, k0, b);
      }
    }
    for (int t = 0; t < T; ++t) {
      const int s = t % kRing, u = t / kRing;
      const int h = kvh * G + t / n, i0 = i_lo + (t % n) * kSmall;
      if (u > 0) mbar_wait(smem_addr(&bars.empty[s]), (u - 1) & 1);
      // this tile's lse (times log2 e) and delta, rows past S zero; each
      // lane arrives on `full` after its own stores
      const size_t row = (static_cast<size_t>(b) * a.H + h) * a.S;
      const int i = i0 + 2 * lane;
      float2 l2 = make_float2(0.f, 0.f), d2 = make_float2(0.f, 0.f);
      if (i < a.S) {
        l2.x = a.lse[row + i] * kLog2e;
        d2.x = a.delta[row + i];
      }
      if (i + 1 < a.S) {
        l2.y = a.lse[row + i + 1] * kLog2e;
        d2.y = a.delta[row + i + 1];
      }
      lse_s[s][lane] = l2;
      del_s[s][lane] = d2;
      const uint32_t fb = smem_addr(&bars.full[s]);
      if (lane == 0) {
        mbar_expect_tx(fb, 2 * kRowTile);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load(qs + s * kRowTile + c * kRowBox, &qmap, fb, c * kBox, h,
                   i0, b);
          tma_load(ds + s * kRowTile + c * kRowBox, &dmap, fb, c * kBox, h,
                   i0, b);
        }
      } else {
        mbar_arrive(fb);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4, c0 = 2 * (lane % 4);
  const int kw = k0 + 64 * wg;   // this warpgroup's keys: kw .. kw + 63
  const uint32_t k_rows = ks + 64 * wg * 128, v_rows = vs + 64 * wg * 128;
  float dk[DN / 2], dv[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) dk[i] = dv[i] = 0.f;
  if (T > 0) mbar_wait(smem_addr(&bars.fixed), 0);
  for (int t = 0; t < T; ++t) {
    const int s = t % kRing;
    const int i0 = i_lo + (t % n) * kSmall;
    const uint32_t qt = qs + s * kRowTile, dt = ds + s * kRowTile;
    mbar_wait(smem_addr(&bars.full[s]), (t / kRing) & 1);
    float st[32], dp[32];
    fence_regs(st);
    fence_regs(dp);
    wgmma_fence();
    issue_ss<KD>(st, k_rows, kKeyBox, qt, kRowBox);
    wgmma_commit();
    issue_ss<KD>(dp, v_rows, kKeyBox, dt, kRowBox);
    wgmma_commit();
    wgmma_wait<1>();   // S^T is done; dP^T may still run
    fence_regs(st);
    // P^T: column c of the tile is query i0 + c; this thread's columns
    // are 8 g + c0 and 8 g + c0 + 1
    const bool masked = needs_mask(a, i0, kw);
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const float2 l2 = lse_s[s][4 * g + c0 / 2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * g + e;
        const float p =
            fast_exp2(fmaf(st[x], a.scale_log2, e % 2 ? -l2.y : -l2.x));
        st[x] = !masked || on_mask(a, i0 + 8 * g + c0 + e % 2,
                                   kw + r0 + 8 * (e / 2))
                    ? p
                    : 0.f;
      }
    }
    uint32_t fa[16];
    pack(st, fa);
    fence_regs(dv);
    wgmma_fence();
    issue_rs<DN>(dv, fa, dt, kRowBox);   // dV += P^T dO
    wgmma_commit();
    wgmma_wait<1>();   // dP^T is done; dV may still run
    fence_regs(dp);
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const float2 d2 = del_s[s][4 * g + c0 / 2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * g + e;
        dp[x] = st[x] * (dp[x] - (e % 2 ? d2.y : d2.x)) * a.scale;
      }
    }
    uint32_t fs[16];
    pack(dp, fs);
    fence_regs(dk);
    wgmma_fence();
    issue_rs<DN>(dk, fs, qt, kRowBox);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    keep_regs(fa);
    keep_regs(fs);
    if (lane == 0) mbar_arrive(smem_addr(&bars.empty[s]));
  }
  const size_t base = (static_cast<size_t>(b) * a.Sk * a.KV + kvh) * a.D;
  const size_t pitch = static_cast<size_t>(a.KV) * a.D;
  store_rows<DN>(a.dk + base, dk, pitch, kw, r0, c0, a.Sk, a.D);
  store_rows<DN>(a.dv + base, dv, pitch, kw, r0, c0, a.Sk, a.D);
}

// dQ: one block per (head, query tile of 128, b); two consumer
// warpgroups of 64 query rows each and a producer warpgroup, as above.
// Q and dO are loaded once; K and V tiles of 64 keys stream through a
// 2-stage ring over the key tiles the mask lets in.  Per tile and
// warpgroup: S = Q K^T and dP = dO V^T (SS), P and dS in registers
// (each thread's two rows' lse and delta held in registers), dQ += dS K
// (RS, K read MN-major).
template <int NB, int KD, int DN>
__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap dmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const WgArgs a) {
  static_assert(KD <= 4 * NB && DN <= 64 * NB, "inside the padded D");
  constexpr int kRowBox = kBig * kBox * 2;     // one box of Q or dO
  constexpr int kKeyBox = kSmall * kBox * 2;   // one box of a K or V tile
  constexpr int kKeyTile = NB * kKeyBox;
  extern __shared__ uint8_t smem_raw[];
  __shared__ RingBars bars;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t qs = raw + ((1024 - (raw & 1023)) & 1023);   // Q tile
  const uint32_t ds = qs + NB * kRowBox;                      // dO tile
  const uint32_t ks = ds + NB * kRowBox;                      // K ring
  const uint32_t vs = ks + kRing * kKeyTile;                  // V ring

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // query tiles from the last: with a causal mask they read the most
  // key tiles, so the heavy blocks start first
  const int h = blockIdx.x, b = blockIdx.z;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kBig;
  const int kvh = h / (a.H / a.KV);
  // key tiles this block needs: n tiles of 64 from j_lo
  const int i_last = min(i0 + kBig, a.S) - 1;
  const int j_hi = a.causal ? min(a.Sk, i_last + 1) : a.Sk;
  const int j_lo =
      (a.window > 0 ? max(0, i0 - a.window + 1) : 0) / kSmall * kSmall;
  const int n = j_hi > j_lo ? (j_hi - j_lo + kSmall - 1) / kSmall : 0;

  if (tid == 0) init_bars(bars, 1);
  __syncthreads();

  if (warp >= 8) {
    setmaxnreg_dec<40>();
    if (tid != 256 || n == 0) return;
    const uint32_t fb = smem_addr(&bars.fixed);
    mbar_expect_tx(fb, 2 * NB * kRowBox);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load(qs + c * kRowBox, &qmap, fb, c * kBox, h, i0, b);
      tma_load(ds + c * kRowBox, &dmap, fb, c * kBox, h, i0, b);
    }
    for (int t = 0; t < n; ++t) {
      const int s = t % kRing, u = t / kRing, jt = j_lo + t * kSmall;
      if (u > 0) mbar_wait(smem_addr(&bars.empty[s]), (u - 1) & 1);
      const uint32_t full = smem_addr(&bars.full[s]);
      mbar_expect_tx(full, 2 * kKeyTile);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        tma_load(ks + s * kKeyTile + c * kKeyBox, &kmap, full, c * kBox,
                 kvh, jt, b);
        tma_load(vs + s * kKeyTile + c * kKeyBox, &vmap, full, c * kBox,
                 kvh, jt, b);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4, c0 = 2 * (lane % 4);
  const int qw = i0 + 64 * wg;   // this warpgroup's rows: qw .. qw + 63
  const uint32_t q_rows = qs + 64 * wg * 128, d_rows = ds + 64 * wg * 128;
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = qw + r0 + 8 * r;
    const size_t row = (static_cast<size_t>(b) * a.H + h) * a.S;
    lse2[r] = i < a.S ? a.lse[row + i] * kLog2e : 0.f;
    del[r] = i < a.S ? a.delta[row + i] : 0.f;
  }
  float dq[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) dq[i] = 0.f;
  if (n > 0) mbar_wait(smem_addr(&bars.fixed), 0);
  for (int t = 0; t < n; ++t) {
    const int s = t % kRing, jt = j_lo + t * kSmall;
    const uint32_t kt = ks + s * kKeyTile, vt = vs + s * kKeyTile;
    mbar_wait(smem_addr(&bars.full[s]), (t / kRing) & 1);
    float sc[32], dp[32];
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    issue_ss<KD>(sc, q_rows, kRowBox, kt, kKeyBox);   // S = Q K^T
    wgmma_commit();
    issue_ss<KD>(dp, d_rows, kRowBox, vt, kKeyBox);   // dP = dO V^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    const bool masked = needs_mask(a, qw, jt);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x / 2) % 2;
      const float p = fast_exp2(fmaf(sc[x], a.scale_log2, -lse2[r]));
      sc[x] = !masked || on_mask(a, qw + r0 + 8 * r,
                                 jt + 8 * (x / 4) + c0 + x % 2)
                  ? p
                  : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x)
      dp[x] = sc[x] * (dp[x] - del[(x / 2) % 2]) * a.scale;
    uint32_t fs[16];
    pack(dp, fs);
    fence_regs(dq);
    wgmma_fence();
    issue_rs<DN>(dq, fs, kt, kKeyBox);   // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    keep_regs(fs);
    if (lane == 0) mbar_arrive(smem_addr(&bars.empty[s]));
  }
  store_rows<DN>(a.dq + (static_cast<size_t>(b) * a.S * a.H + h) * a.D, dq,
                 static_cast<size_t>(a.H) * a.D, qw, r0, c0, a.S, a.D);
}

template <int NB, int KD, int DN>
int launch_wgmma(const Args& a, int B, int D, cudaStream_t stream) {
  constexpr int smem = 1024 + NB * (2 * kBig + 2 * kRing * kSmall) * kBox * 2;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_wgmma<NB, KD, DN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(flash_bwd_dq_wgmma<NB, KD, DN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // q, k, v through their strides; dO contiguous; boxes of 128 rows for
  // the resident tiles, 64 for the streamed ones
  const long long dsh = D, dss = (long long)a.H * D, dsb = dss * a.S;
  CUtensorMap k_big, v_big, q_small, d_small, q_big, d_big, k_small, v_small;
  if (!encode(&k_big, a.k, D, a.KV, a.Sk, B, a.ksh, a.kss, a.ksb, kBig) ||
      !encode(&v_big, a.v, D, a.KV, a.Sk, B, a.vsh, a.vss, a.vsb, kBig) ||
      !encode(&q_small, a.q, D, a.H, a.S, B, a.qsh, a.qss, a.qsb, kSmall) ||
      !encode(&d_small, a.dout, D, a.H, a.S, B, dsh, dss, dsb, kSmall) ||
      !encode(&q_big, a.q, D, a.H, a.S, B, a.qsh, a.qss, a.qsb, kBig) ||
      !encode(&d_big, a.dout, D, a.H, a.S, B, dsh, dss, dsb, kBig) ||
      !encode(&k_small, a.k, D, a.KV, a.Sk, B, a.ksh, a.kss, a.ksb,
              kSmall) ||
      !encode(&v_small, a.v, D, a.KV, a.Sk, B, a.vsh, a.vss, a.vsb, kSmall))
    return cudaErrorInvalidValue;
  const WgArgs w{static_cast<__nv_bfloat16*>(a.dq),
                 static_cast<__nv_bfloat16*>(a.dk),
                 static_cast<__nv_bfloat16*>(a.dv), a.lse, a.delta, a.S,
                 a.Sk, a.H, a.KV, D, a.causal, a.window, a.scale,
                 a.scale * kLog2e};
  const int rows = B * a.S * a.H;
  flash_bwd_delta_kernel<__nv_bfloat16, 16 * KD>
      <<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
         stream>>>(a, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_wgmma<NB, KD, DN>
      <<<dim3(a.KV, (a.Sk + kBig - 1) / kBig, B), kWgThreads, smem,
         stream>>>(k_big, v_big, q_small, d_small, w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_wgmma<NB, KD, DN>
      <<<dim3(a.H, (a.S + kBig - 1) / kBig, B), kWgThreads, smem,
         stream>>>(q_big, d_big, k_small, v_small, w);
  return cudaGetLastError();
}

int dispatch_bf16(const Args& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch_wgmma<1, 1, 64>(a, B, D, s);
    case 32: return launch_wgmma<1, 2, 64>(a, B, D, s);
    case 48: return launch_wgmma<1, 3, 64>(a, B, D, s);
    case 64: return launch_wgmma<1, 4, 64>(a, B, D, s);
    case 80: return launch_wgmma<2, 5, 80>(a, B, D, s);
    case 96: return launch_wgmma<2, 6, 96>(a, B, D, s);
    case 112: return launch_wgmma<2, 7, 112>(a, B, D, s);
    case 128: return launch_wgmma<2, 8, 128>(a, B, D, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, S, H, D], k/v: [B, Sk, KV, D] with unit stride on D and the
// given element strides on (B, seq, head), 16-byte aligned; o and dout:
// contiguous [B, S, H, D]; lse: fp32 [B, H, S] from flash_attention_fwd;
// delta: fp32 [B, H, S] scratch; dq: contiguous [B, S, H, D]; dk, dv:
// contiguous [B, Sk, KV, D].  D a multiple of 16 up to 128, H % KV == 0.
// dtype: 0 fp32 (FMA route), 1 bf16 (wgmma/TMA route).  window <= 0
// means no window.  Returns cudaGetLastError() after the last launch (or
// the first failed one), or an error without launching when a tensor map
// is refused.
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
  if (dtype == 0) return dispatch_fp32(a, B, D, s);
  if (dtype == 1) return dispatch_bf16(a, B, D, s);
  return cudaErrorInvalidValue;
}
