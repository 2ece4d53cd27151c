// RMSNorm forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (_kernel / rmsnorm_fwd): y = x * rsqrt(mean(x^2) + eps) * scale with
// fp32 statistics, written in x's dtype.
//
// What bounds it on this card: memory.  Each element is read once and
// written once with about three flops between, far below the ~295
// flops per byte at which an H100 stops waiting on HBM.  The Pallas
// kernel keeps whole [rows, d] blocks in VMEM; here one warp owns one
// row and moves it with 16-byte vector loads (8 bf16 or 4 fp32 per
// lane), neighbouring lanes on neighbouring addresses.  The sum of
// squares stays in fp32 registers and is reduced with warp shuffles, so
// nothing but x, scale and y touches device memory.  The second pass
// over the row (scale and write) re-reads x from L1/L2: a row is at
// most a few kilobytes, and a block holds four rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // rows per block

template <typename T> struct Pack;  // elements in one 16-byte load
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

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ y, int rows, int d, float eps) {
  constexpr int N = Pack<T>::N;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;
  const int nvec = d / N;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * d);

  float ss = 0.f;
  for (int i = lane; i < nvec; i += 32) {
    const uint4 raw = __ldg(xr + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float v = to_f(e[k]);
      ss += v * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / (float)d + eps);

  for (int i = lane; i < nvec; i += 32) {
    const uint4 raw = __ldg(xr + i);
    const uint4 sraw = __ldg(sr + i);
    uint4 out;
    const T* e = reinterpret_cast<const T*>(&raw);
    const T* s = reinterpret_cast<const T*>(&sraw);
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int k = 0; k < N; ++k) o[k] = from_f<T>(to_f(e[k]) * inv * to_f(s[k]));
    yr[i] = out;
  }
}

template <typename T>
void launch(const void* x, const void* scale, void* y, int rows, int d,
            float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  rmsnorm_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(y), rows, d, eps);
}

}  // namespace

// x, y: [rows, d] contiguous; scale: [d]; all 16-byte aligned with
// d * sizeof(T) a multiple of 16 (the wrapper checks).  dtype: 0 fp32,
// 1 bf16.  Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* y,
                           int rows, int d, float eps, int dtype,
                           void* stream) {
  if (rows <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, scale, y, rows, d, eps, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, scale, y, rows, d, eps, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
