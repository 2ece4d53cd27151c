// Flash-attention forward for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py (_fwd_kernel /
// flash_attention_fwd): FlashAttention-2 forward, causal and/or
// sliding-window, GQA (query head h reads kv head h / G), online softmax
// with fp32 running max m, denominator l and accumulator.
//
// The TPU grid (B, H, nq, nk) runs its last axis in order on one core
// and carries m, l and acc across it in VMEM scratch.  CUDA blocks run
// in no order, so here one block owns one (b, h, 32-query tile) and
// walks the kv tiles itself, in a loop bounded by the causal and window
// limits: masked kv tiles are never loaded (the Pallas kernel still
// DMAs them and only skips their compute).  Each kv tile (32 keys) is
// staged in shared memory as fp32, K with a padded row stride so the 32
// lanes reading 32 different keys hit 32 different banks.  Each warp
// owns 8 query rows; lane j scores key j of the tile for all 8 rows at
// once (one K load feeds 8 independent FMA chains; q is a broadcast
// float4), the row max and sum are warp shuffles, and each lane
// accumulates ceil(D/32) output columns of P @ V, loading each V element
// once for all 8 rows.  m, l and acc stay in registers across the kv
// loop.  D is any multiple of 16 up to 128 (a bf16 row is whole 16-byte
// words); where 32 does not divide D (zamba2's 112) the upper lanes'
// last column and the last round of tile loads are guarded.
//
// Inputs are read through their strides in the model's [B, S, H, D]
// layout, so no transposes are made (the JAX ops.py transposes to
// [B, H, S, D]), with 16-byte loads (the wrapper checks alignment); the
// output is written contiguous [B, S, H, D].
//
// What bounds it on this card: at the prefill shapes of the main path
// (S <= 256, D = 96, 112, 128) the kernel does 4 * S^2 * D / 2 flops per head on
// 4 * S * D input/output elements, i.e. about S / 4 flops per byte in
// bf16: below the H100's ~295 flops/byte ridge, so the bound is bytes.
// This first kernel computes with plain fp32 FMAs from shared memory
// (no tensor cores, no cp.async/TMA, no warp specialisation); it is
// bounded in practice by shared-memory bandwidth and launch latency.
// mma.sync/wgmma tiles are the later, faster design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;              // query rows per block
constexpr int BK = 32;              // keys per kv tile (one per lane)
constexpr int kWarps = 4;
constexpr int kRows = BQ / kWarps;  // query rows per warp
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, Sk, H, KV;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window;  // window <= 0: none
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * D + BK * (D + 1) + BK * D);
}

// Stage rows [r0, r0 + ROWS) of a [rows, D] slab (row stride `stride`
// elements, unit stride on D) into shared memory as fp32 with row pitch
// `pitch`; rows past `n` are zero.  Every thread issues all of its
// 16-byte loads before converting any, so one block waits for one
// round trip to memory per tile, not one per element.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const T* __restrict__ src,
                                          long long stride, int r0, int n,
                                          int tid) {
  constexpr int VEC = 16 / sizeof(T);          // elements per 16 bytes
  static_assert(D % VEC == 0, "a row is whole 16-byte words");
  constexpr int PER_ROW = D / VEC;
  constexpr int TOTAL = ROWS * PER_ROW;
  constexpr int PER_THREAD = (TOTAL + kWarps * 32 - 1) / (kWarps * 32);
  // when the words do not split evenly over the threads (D = 112 in
  // bf16: 448 words over 128 threads), the last round is guarded
  constexpr bool kEven = TOTAL % (kWarps * 32) == 0;
  uint4 raw[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int idx = tid + i * kWarps * 32;
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC;
    raw[i] = (kEven || idx < TOTAL) && r0 + r < n
                 ? __ldg(reinterpret_cast<const uint4*>(
                       src + (r0 + r) * stride + c))
                 : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int idx = tid + i * kWarps * 32;
    if (!kEven && idx >= TOTAL) continue;
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC;
    const T* e = reinterpret_cast<const T*>(&raw[i]);
#pragma unroll
    for (int x = 0; x < VEC; ++x) dst[r * pitch + c + x] = to_f(e[x]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_kernel(Args a) {
  // output columns per lane; when 32 does not divide D (D = 112) the
  // last column of the upper lanes is past D and is guarded
  constexpr int NV = (D + 31) / 32;
  constexpr bool kFull = D % 32 == 0;
  constexpr int KP = D + 1;   // padded K row stride (bank-conflict free)
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][D]
  float* ks = qs + BQ * D;       // [BK][KP]
  float* vs = ks + BK * KP;      // [BK][D]
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  T* __restrict__ o = static_cast<T*>(a.o);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  load_tile<T, D, BQ>(qs, D, q + b * a.qsb + h * a.qsh, a.qss, q0, a.S, tid);

  // kv tiles this block needs: [k_lo, k_hi)
  const int q_last = min(q0 + BQ, a.S) - 1;
  const int k_hi = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  k_lo = (k_lo / BK) * BK;

  float m[kRows], l[kRows], acc[kRows][NV];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[rr][i] = 0.f;
  }

  for (int kt = k_lo; kt < k_hi; kt += BK) {
    __syncthreads();  // the previous tile is consumed (and qs is stored)
    load_tile<T, D, BK>(ks, KP, k + b * a.ksb + kvh * a.ksh, a.kss, kt, a.Sk,
                        tid);
    load_tile<T, D, BK>(vs, D, v + b * a.vsb + kvh * a.vsh, a.vss, kt, a.Sk,
                        tid);
    __syncthreads();
    // scores of this warp's rows against key `lane`: one K load feeds
    // kRows independent FMA chains, q arrives as broadcast float4s
    const int kp = kt + lane;
    const float* krow = ks + lane * KP;
    const float* qw = qs + warp * kRows * D;
    float sc[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) sc[rr] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < D; dd += 4) {
      const float k0 = krow[dd], k1 = krow[dd + 1], k2 = krow[dd + 2],
                  k3 = krow[dd + 3];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + rr * D + dd);
        sc[rr] += qv.x * k0 + qv.y * k1 + qv.z * k2 + qv.w * k3;
      }
    }
    // online softmax, one row at a time (the shuffles are independent
    // across rows, so the compiler can overlap them)
    float p[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int qp = q0 + warp * kRows + rr;
      bool valid = kp < a.Sk;
      if (a.causal) valid = valid && kp <= qp;
      if (a.window > 0) valid = valid && (qp - kp) < a.window;
      const float s = sc[rr] * a.scale;
      const float m_new = fmaxf(m[rr], warp_max(valid ? s : kNegInf));
      p[rr] = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p[rr]);
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[rr][i] *= alpha;
    }
    // P @ V: each V element is loaded once and used by all kRows rows
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vj[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i)
        vj[i] = kFull || lane + 32 * i < D ? vs[j * D + lane + 32 * i] : 0.f;
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float pj = __shfl_sync(0xffffffffu, p[rr], j);
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[rr][i] += pj * vj[i];
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int qp = q0 + warp * kRows + rr;
    if (qp >= a.S) continue;
    const float denom = fmaxf(l[rr], 1e-30f);
    T* orow = o + (((size_t)b * a.S + qp) * a.H + h) * D;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (kFull || lane + 32 * i < D)
        orow[lane + 32 * i] = from_f<T>(acc[rr][i] / denom);
  }
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  flash_fwd_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(const Args& a, int B, int D, cudaStream_t s) {
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

// q: [B, S, H, D], k/v: [B, Sk, KV, D], each with unit stride on D and
// the given element strides on (B, seq, head), 16-byte aligned base
// pointers and strides; o: contiguous
// [B, S, H, D].  D a multiple of 16 up to 128; H % KV == 0.  dtype: 0 fp32,
// 1 bf16.  window <= 0 means no window.  Returns cudaGetLastError().
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int Sk, int H, int KV, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || Sk <= 0) return cudaErrorInvalidValue;
  Args a{q, k, v, o, S, Sk, H, KV, qsb, qss, qsh, ksb, kss, ksh,
         vsb, vss, vsh, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(a, B, D, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(a, B, D, s);
  return cudaErrorInvalidValue;
}
