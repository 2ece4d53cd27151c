// RMSNorm forward for Hopper (sm_90a), plain and fused with the residual
// add before it; plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (_kernel / rmsnorm_fwd): y = x * rsqrt(mean(x^2) + eps) * scale with
// fp32 statistics, written in x's dtype.  The fused form also takes the
// residual branch h, writes s = x + h (added in fp32, rounded to x's
// dtype, bit-exact with torch's x + h) and normalises the rounded s, so
// the add that comes before every pre-norm is not a launch of its own.
//
// What bounds it on this card: memory, and at the model's row counts
// the latency of one round trip to it.  Each element is read once and
// written once with a few flops between, far below the ~295 flops per
// byte at which an H100 stops waiting on HBM; a [128, 3072] bf16 row
// block is 0.8 MB, under a microsecond of bandwidth.  So the design
// spreads rows over SMs and keeps one round trip per row: one block
// owns one row (128 prefill rows are one wave of 128 blocks, a 2-row
// decode step uses 2 SMs), every thread issues all its 16-byte loads of
// x, h and scale before any arithmetic, keeps them in registers (128
// threads of at most kVec words each up to 4096 bf16 or 2048 fp32
// elements, more threads for wider rows), reduces with warp shuffles and
// one pass through shared memory, and writes s and y from the
// registers: the second pass reads no memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMinThreads = 128;
constexpr int kMaxThreads = 512;  // 128 registers a thread at most
constexpr int kVec = 4;     // 16-byte words a thread holds, up to the widest
constexpr int kMaxVec = 8;  // rows (at 8 the plain form spills a little)

template <typename T> struct Pack;  // elements in one 16-byte word
template <> struct Pack<float> { static constexpr int N = 4; };
template <> struct Pack<__nv_bfloat16> { static constexpr int N = 8; };

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

// The row of block blockIdx.x; word i of it is held by thread
// i % blockDim, slot i / blockDim, so a warp's loads are 512
// neighbouring bytes.
template <typename T, int VEC, bool RESID>
__device__ __forceinline__ void norm_row(
    const uint4* __restrict__ x, const uint4* __restrict__ h,
    const uint4* __restrict__ scale, uint4* __restrict__ s,
    uint4* __restrict__ y, int nvec, int d, float eps) {
  constexpr int N = Pack<T>::N;
  const size_t base = (size_t)blockIdx.x * nvec;
  uint4 xv[VEC], hv[VEC], gv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      xv[j] = __ldg(x + base + i);
      if (RESID) hv[j] = __ldg(h + base + i);
      gv[j] = __ldg(scale + i);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      T* e = reinterpret_cast<T*>(&xv[j]);
      if (RESID) {
        const T* r = reinterpret_cast<const T*>(&hv[j]);
#pragma unroll
        for (int k = 0; k < N; ++k) e[k] = from_f<T>(to_f(e[k]) + to_f(r[k]));
        s[base + i] = xv[j];
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float v = to_f(e[k]);
        ss += v * v;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  __shared__ float part[kMaxThreads / 32];
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  float tot = 0.f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) tot += part[w];
  const float inv = rsqrtf(tot / (float)d + eps);

#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      uint4 out;
      const T* e = reinterpret_cast<const T*>(&xv[j]);
      const T* g = reinterpret_cast<const T*>(&gv[j]);
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < N; ++k)
        o[k] = from_f<T>(to_f(e[k]) * inv * to_f(g[k]));
      y[base + i] = out;
    }
  }
}

// Two entry points, so a profile tells the forms apart.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const uint4* __restrict__ x, const uint4* __restrict__ scale,
               uint4* __restrict__ y, int nvec, int d, float eps) {
  norm_row<T, VEC, false>(x, nullptr, scale, nullptr, y, nvec, d, eps);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
add_rmsnorm_kernel(const uint4* __restrict__ x, const uint4* __restrict__ h,
                   const uint4* __restrict__ scale, uint4* __restrict__ s,
                   uint4* __restrict__ y, int nvec, int d, float eps) {
  norm_row<T, VEC, true>(x, h, scale, s, y, nvec, d, eps);
}

template <typename T, int VEC>
void launch_vec(const void* x, const void* h, const void* scale, void* s,
                void* y, int rows, int nvec, int d, float eps, int threads,
                cudaStream_t stream) {
  const uint4* xp = static_cast<const uint4*>(x);
  const uint4* gp = static_cast<const uint4*>(scale);
  uint4* yp = static_cast<uint4*>(y);
  if (h != nullptr) {
    add_rmsnorm_kernel<T, VEC><<<rows, threads, 0, stream>>>(
        xp, static_cast<const uint4*>(h), gp, static_cast<uint4*>(s), yp,
        nvec, d, eps);
  } else {
    rmsnorm_kernel<T, VEC><<<rows, threads, 0, stream>>>(xp, gp, yp, nvec,
                                                          d, eps);
  }
}

template <typename T>
int launch(const void* x, const void* h, const void* scale, void* s,
           void* y, int rows, int d, float eps, cudaStream_t stream) {
  const int nvec = d / Pack<T>::N;
  int threads = kMinThreads;
  while (threads < kMaxThreads && nvec > kVec * threads) threads *= 2;
  const int per = (nvec + threads - 1) / threads;
  if (per > kMaxVec) return cudaErrorInvalidValue;
  if (per <= 1) {
    launch_vec<T, 1>(x, h, scale, s, y, rows, nvec, d, eps, threads, stream);
  } else if (per <= 2) {
    launch_vec<T, 2>(x, h, scale, s, y, rows, nvec, d, eps, threads, stream);
  } else if (per <= 4) {
    launch_vec<T, 4>(x, h, scale, s, y, rows, nvec, d, eps, threads, stream);
  } else {
    launch_vec<T, 8>(x, h, scale, s, y, rows, nvec, d, eps, threads, stream);
  }
  return cudaGetLastError();
}

}  // namespace

// x, h, s, y: [rows, d] contiguous; scale: [d]; all 16-byte aligned with
// d * sizeof(T) a multiple of 16 and at most kMaxThreads * kMaxVec
// 16-byte words (the wrapper checks; a wider row returns
// cudaErrorInvalidValue).  h == nullptr: plain RMSNorm of x, s unused.
// Otherwise s = x + h and y = rmsnorm(s).  dtype: 0 fp32, 1 bf16.
// Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_fwd(const void* x, const void* h, const void* scale,
                           void* s, void* y, int rows, int d, float eps,
                           int dtype, void* stream) {
  if (rows <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, h, scale, s, y, rows, d, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, h, scale, s, y, rows, d, eps, st);
  return cudaErrorInvalidValue;
}
