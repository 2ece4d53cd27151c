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
//
// Backward (rmsnorm_bwd_kernel + rmsnorm_dscale_kernel; no Pallas
// counterpart: it replaces JAX's autodiff of
// src/repro/models/common.py:65 rmsnorm, which the JAX trainer
// differentiates): dx = r * (dy*g - x * r^2 * sum(dy*g*x) / d) with
// r = rsqrt(mean(x^2) + eps) recomputed from the saved input (s for
// the fused form, whose dx = dh is ds plus that, the norm's part
// rounded to the dtype first as autograd of the plain version rounds
// it), and dscale = sum over rows of dy * x * r in fp32.  Bound by
// memory like the forward (x, dy, ds read once, dx written once).  A
// row is still one block's, held in registers; each block walks a
// strided set of rows and keeps its columns' dscale sums in registers,
// then writes them as one fp32 partial row; a second kernel adds the
// partial rows column by column in a fixed order.  No float atomics:
// the result is the same bits on every run.
//
// Rows split over ranks (rmsnorm_row_*; no Pallas counterpart: GSPMD's
// partition of the JAX norm over a sharded d_inner, the gated norm of
// src/repro/models/ssm.py:233): the statistics of a rank's columns in
// one launch, normalisation (or dx) from the all-reduced statistics in
// another.  Bound by memory as the whole-row kernels are.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// The threads of a row's block for a row of nvec 16-byte words, and the
// words each holds (`per`); every kernel here lays a row out alike.
inline int row_threads(int nvec, int* per) {
  int threads = kMinThreads;
  while (threads < kMaxThreads && nvec > kVec * threads) threads *= 2;
  *per = (nvec + threads - 1) / threads;
  return threads;
}

template <typename T>
int launch(const void* x, const void* h, const void* scale, void* s,
           void* y, int rows, int d, float eps, cudaStream_t stream) {
  const int nvec = d / Pack<T>::N;
  int per;
  const int threads = row_threads(nvec, &per);
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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Rows blockIdx.x, blockIdx.x + gridDim.x, ... of dx; this block's
// partial dscale sums go to part[blockIdx.x * d ...] (fp32).  ds may be
// null (plain form).
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_bwd_kernel(const uint4* __restrict__ x, const uint4* __restrict__ dy,
                   const uint4* __restrict__ ds,
                   const uint4* __restrict__ scale, uint4* __restrict__ dx,
                   float* __restrict__ part, int rows, int nvec, int d,
                   float eps) {
  constexpr int N = Pack<T>::N;
  uint4 gv[VEC];
  float acc[VEC][N];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) gv[j] = __ldg(scale + i);
#pragma unroll
    for (int k = 0; k < N; ++k) acc[j][k] = 0.f;
  }
  // two reduction buffers, by row parity: a thread writes one row's
  // partials only after every thread has read the row before's
  __shared__ float red[2][2][kMaxThreads / 32];
  int parity = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
    const size_t base = (size_t)row * nvec;
    uint4 xv[VEC], dv[VEC], sv[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i < nvec) {
        xv[j] = __ldg(x + base + i);
        dv[j] = __ldg(dy + base + i);
        if (ds != nullptr) sv[j] = __ldg(ds + base + i);
      }
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i < nvec) {
        const T* e = reinterpret_cast<const T*>(&xv[j]);
        const T* o = reinterpret_cast<const T*>(&dv[j]);
        const T* g = reinterpret_cast<const T*>(&gv[j]);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float v = to_f(e[k]);
          ss += v * v;
          dot += to_f(o[k]) * to_f(g[k]) * v;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    if (threadIdx.x % 32 == 0) {
      red[parity][0][threadIdx.x / 32] = ss;
      red[parity][1][threadIdx.x / 32] = dot;
    }
    __syncthreads();
    float tss = 0.f, tdot = 0.f;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) {
      tss += red[parity][0][w];
      tdot += red[parity][1][w];
    }
    const float r = rsqrtf(tss / (float)d + eps);
    const float c = r * r * tdot / (float)d;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i < nvec) {
        uint4 out;
        const T* e = reinterpret_cast<const T*>(&xv[j]);
        const T* o = reinterpret_cast<const T*>(&dv[j]);
        const T* g = reinterpret_cast<const T*>(&gv[j]);
        const T* a = reinterpret_cast<const T*>(&sv[j]);
        T* res = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float v = to_f(e[k]), dyv = to_f(o[k]);
          acc[j][k] += dyv * (v * r);
          const T dn = from_f<T>(r * (dyv * to_f(g[k]) - v * c));
          res[k] = ds != nullptr ? from_f<T>(to_f(dn) + to_f(a[k])) : dn;
        }
        dx[base + i] = out;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      float* p = part + (size_t)blockIdx.x * d + (size_t)i * N;
#pragma unroll
      for (int k = 0; k < N; k += 4)
        *reinterpret_cast<float4*>(p + k) =
            make_float4(acc[j][k], acc[j][k + 1], acc[j][k + 2],
                        acc[j][k + 3]);
    }
  }
}

// dscale[c] = sum over b of part[b][c], in a fixed order: a block holds
// 32 columns x 8 row groups; group ty adds rows ty, ty + 8, ... and the
// 8 group sums are added in order.
template <typename T>
__global__ void __launch_bounds__(256)
rmsnorm_dscale_kernel(const float* __restrict__ part, T* __restrict__ dscale,
                      int nb, int d) {
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + tx;
  float sum = 0.f;
  if (c < d)
    for (int b = ty; b < nb; b += 8) sum += part[(size_t)b * d + c];
  __shared__ float grp[8][32];
  grp[ty][tx] = sum;
  __syncthreads();
  if (ty == 0 && c < d) {
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) tot += grp[k][tx];
    dscale[c] = from_f<T>(tot);
  }
}

template <typename T, int VEC>
void launch_bwd_vec(const void* x, const void* dy, const void* ds,
                    const void* scale, void* dx, float* part, int rows,
                    int nvec, int d, int nb, float eps, int threads,
                    cudaStream_t stream) {
  rmsnorm_bwd_kernel<T, VEC><<<nb, threads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(dy),
      static_cast<const uint4*>(ds), static_cast<const uint4*>(scale),
      static_cast<uint4*>(dx), part, rows, nvec, d, eps);
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* ds,
               const void* scale, void* dx, float* part, void* dscale,
               int rows, int d, int nb, float eps, cudaStream_t stream) {
  const int nvec = d / Pack<T>::N;
  int per;
  const int threads = row_threads(nvec, &per);
  if (per > kMaxVec) return cudaErrorInvalidValue;
  if (per <= 1) {
    launch_bwd_vec<T, 1>(x, dy, ds, scale, dx, part, rows, nvec, d, nb, eps,
                         threads, stream);
  } else if (per <= 2) {
    launch_bwd_vec<T, 2>(x, dy, ds, scale, dx, part, rows, nvec, d, nb, eps,
                         threads, stream);
  } else if (per <= 4) {
    launch_bwd_vec<T, 4>(x, dy, ds, scale, dx, part, rows, nvec, d, nb, eps,
                         threads, stream);
  } else {
    launch_bwd_vec<T, 8>(x, dy, ds, scale, dx, part, rows, nvec, d, nb, eps,
                         threads, stream);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rmsnorm_dscale_kernel<T><<<(d + 31) / 32, 256, 0, stream>>>(
      part, static_cast<T*>(dscale), nb, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// rows split over ranks (the gated norm of a partitioned Mamba2 mixer)
// ---------------------------------------------------------------------------
//
// A rank holds d of a row's d_total columns and normalises them without
// gathering the row, as GSPMD partitions the JAX norm: the forward is two
// launches around the caller's all-reduce of one fp32 statistic a row.
// rmsnorm_row_stat_kernel writes sum(x^2) over the rank's columns, and
// rmsnorm_row_apply_kernel writes y = x * rsqrt(sum / d_total + eps) *
// scale from the reduced sums.  The backward likewise: the stat kernel
// writes sum(dy * scale * x), and rmsnorm_row_bwd_kernel takes both
// reduced sums, writes dx on the rank's columns and the dscale partial
// rows, which rmsnorm_dscale_kernel adds.  Every sum and element is
// formed as the whole-row kernels form it (the same threads, words,
// order of additions and expressions), so with d == d_total (one rank)
// they give the whole-row kernels' bits.

// One fp32 per row: sum(x^2) (BWD false) or sum(dy * scale * x).
template <typename T, int VEC, bool BWD>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_row_stat_kernel(const uint4* __restrict__ x,
                        const uint4* __restrict__ dy,
                        const uint4* __restrict__ scale,
                        float* __restrict__ out, int nvec) {
  constexpr int N = Pack<T>::N;
  const size_t base = (size_t)blockIdx.x * nvec;
  uint4 xv[VEC], dv[VEC], gv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      xv[j] = __ldg(x + base + i);
      if (BWD) {
        dv[j] = __ldg(dy + base + i);
        gv[j] = __ldg(scale + i);
      }
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      const T* e = reinterpret_cast<const T*>(&xv[j]);
      const T* o = reinterpret_cast<const T*>(&dv[j]);
      const T* g = reinterpret_cast<const T*>(&gv[j]);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float v = to_f(e[k]);
        if (BWD) {
          acc += to_f(o[k]) * to_f(g[k]) * v;
        } else {
          acc += v * v;
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ float part[kMaxThreads / 32];
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) tot += part[w];
    out[blockIdx.x] = tot;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_row_apply_kernel(const uint4* __restrict__ x,
                         const float* __restrict__ ss,
                         const uint4* __restrict__ scale,
                         uint4* __restrict__ y, int nvec, int d_total,
                         float eps) {
  constexpr int N = Pack<T>::N;
  const size_t base = (size_t)blockIdx.x * nvec;
  const float inv = rsqrtf(ss[blockIdx.x] / (float)d_total + eps);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      const uint4 xv = __ldg(x + base + i), gv = __ldg(scale + i);
      uint4 out;
      const T* e = reinterpret_cast<const T*>(&xv);
      const T* g = reinterpret_cast<const T*>(&gv);
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < N; ++k)
        o[k] = from_f<T>(to_f(e[k]) * inv * to_f(g[k]));
      y[base + i] = out;
    }
  }
}

// dx of rows blockIdx.x, blockIdx.x + gridDim.x, ... from the reduced
// sums; this block's dscale partial sums go to part[blockIdx.x * d ...],
// as rmsnorm_bwd_kernel writes them.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_row_bwd_kernel(const uint4* __restrict__ x,
                       const uint4* __restrict__ dy,
                       const uint4* __restrict__ scale,
                       const float* __restrict__ ss,
                       const float* __restrict__ dot, uint4* __restrict__ dx,
                       float* __restrict__ part, int rows, int nvec, int d,
                       int d_total, float eps) {
  constexpr int N = Pack<T>::N;
  uint4 gv[VEC];
  float acc[VEC][N];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) gv[j] = __ldg(scale + i);
#pragma unroll
    for (int k = 0; k < N; ++k) acc[j][k] = 0.f;
  }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t base = (size_t)row * nvec;
    const float r = rsqrtf(ss[row] / (float)d_total + eps);
    const float c = r * r * dot[row] / (float)d_total;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i < nvec) {
        const uint4 xv = __ldg(x + base + i), dv = __ldg(dy + base + i);
        uint4 out;
        const T* e = reinterpret_cast<const T*>(&xv);
        const T* o = reinterpret_cast<const T*>(&dv);
        const T* g = reinterpret_cast<const T*>(&gv[j]);
        T* res = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float v = to_f(e[k]), dyv = to_f(o[k]);
          acc[j][k] += dyv * (v * r);
          res[k] = from_f<T>(r * (dyv * to_f(g[k]) - v * c));
        }
        dx[base + i] = out;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      float* p = part + (size_t)blockIdx.x * d + (size_t)i * N;
#pragma unroll
      for (int k = 0; k < N; k += 4)
        *reinterpret_cast<float4*>(p + k) =
            make_float4(acc[j][k], acc[j][k + 1], acc[j][k + 2],
                        acc[j][k + 3]);
    }
  }
}

// f(std::integral_constant<int, VEC>) for the words a thread holds.
template <typename F>
int by_vec(int per, F&& f) {
  if (per > kMaxVec) return cudaErrorInvalidValue;
  if (per <= 1) {
    f(std::integral_constant<int, 1>());
  } else if (per <= 2) {
    f(std::integral_constant<int, 2>());
  } else if (per <= 4) {
    f(std::integral_constant<int, 4>());
  } else {
    f(std::integral_constant<int, 8>());
  }
  return cudaGetLastError();
}

template <typename T>
int launch_row_stat(const void* x, const void* dy, const void* scale,
                    float* out, int rows, int d, cudaStream_t stream) {
  const int nvec = d / Pack<T>::N;
  int per;
  const int threads = row_threads(nvec, &per);
  const uint4* xp = static_cast<const uint4*>(x);
  const uint4* dp = static_cast<const uint4*>(dy);
  const uint4* gp = static_cast<const uint4*>(scale);
  return by_vec(per, [&](auto vec) {
    constexpr int VEC = decltype(vec)::value;
    if (dy != nullptr) {
      rmsnorm_row_stat_kernel<T, VEC, true>
          <<<rows, threads, 0, stream>>>(xp, dp, gp, out, nvec);
    } else {
      rmsnorm_row_stat_kernel<T, VEC, false>
          <<<rows, threads, 0, stream>>>(xp, dp, gp, out, nvec);
    }
  });
}

template <typename T>
int launch_row_apply(const void* x, const float* ss, const void* scale,
                     void* y, int rows, int d, int d_total, float eps,
                     cudaStream_t stream) {
  const int nvec = d / Pack<T>::N;
  int per;
  const int threads = row_threads(nvec, &per);
  return by_vec(per, [&](auto vec) {
    constexpr int VEC = decltype(vec)::value;
    rmsnorm_row_apply_kernel<T, VEC><<<rows, threads, 0, stream>>>(
        static_cast<const uint4*>(x), ss, static_cast<const uint4*>(scale),
        static_cast<uint4*>(y), nvec, d_total, eps);
  });
}

template <typename T>
int launch_row_bwd(const void* x, const void* dy, const void* scale,
                   const float* ss, const float* dot, void* dx, float* part,
                   void* dscale, int rows, int d, int d_total, int nb,
                   float eps, cudaStream_t stream) {
  const int nvec = d / Pack<T>::N;
  int per;
  const int threads = row_threads(nvec, &per);
  const int err = by_vec(per, [&](auto vec) {
    constexpr int VEC = decltype(vec)::value;
    rmsnorm_row_bwd_kernel<T, VEC><<<nb, threads, 0, stream>>>(
        static_cast<const uint4*>(x), static_cast<const uint4*>(dy),
        static_cast<const uint4*>(scale), ss, dot, static_cast<uint4*>(dx),
        part, rows, nvec, d, d_total, eps);
  });
  if (err != cudaSuccess) return err;
  rmsnorm_dscale_kernel<T><<<(d + 31) / 32, 256, 0, stream>>>(
      part, static_cast<T*>(dscale), nb, d);
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

// Backward of rmsnorm_fwd.  x: the saved input ([rows, d]; s of the
// fused form), dy: [rows, d], ds: [rows, d] or nullptr (plain form),
// scale: [d]; dx: [rows, d] (dh = dx of the fused form), dscale: [d] in
// the dtype; part: [nb, d] fp32 scratch, nb blocks (1 <= nb <= rows).
// The same layout rules as rmsnorm_fwd.  Returns cudaGetLastError().
extern "C" int rmsnorm_bwd(const void* x, const void* dy, const void* ds,
                           const void* scale, void* dx, void* part,
                           void* dscale, int rows, int d, int nb, float eps,
                           int dtype, void* stream) {
  if (rows <= 0 || nb <= 0 || nb > rows) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return launch_bwd<float>(x, dy, ds, scale, dx, p, dscale, rows, d, nb,
                             eps, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, dy, ds, scale, dx, p, dscale, rows,
                                     d, nb, eps, st);
  return cudaErrorInvalidValue;
}

// The norm of rows whose d_total columns are split over ranks; this rank
// holds d of them (the layout rules of rmsnorm_fwd, with d in place of
// the row width).  rmsnorm_row_stat writes out[row] (fp32): sum(x^2)
// when dy is null, else sum(dy * scale * x).  rmsnorm_row_fwd writes y
// from ss, the sums of x^2 over the whole rows.  rmsnorm_row_bwd writes
// dx and dscale (in the dtype; part: [nb, d] fp32 scratch, 1 <= nb <=
// rows) from ss and dot, the sums of dy * scale * x over the whole rows.
// Each returns cudaGetLastError() after its launches.
extern "C" int rmsnorm_row_stat(const void* x, const void* dy,
                                const void* scale, void* out, int rows,
                                int d, int dtype, void* stream) {
  if (rows <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch_row_stat<float>(x, dy, scale, o, rows, d, st);
  if (dtype == 1)
    return launch_row_stat<__nv_bfloat16>(x, dy, scale, o, rows, d, st);
  return cudaErrorInvalidValue;
}

extern "C" int rmsnorm_row_fwd(const void* x, const void* ss,
                               const void* scale, void* y, int rows, int d,
                               int d_total, float eps, int dtype,
                               void* stream) {
  if (rows <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(ss);
  if (dtype == 0)
    return launch_row_apply<float>(x, s, scale, y, rows, d, d_total, eps,
                                   st);
  if (dtype == 1)
    return launch_row_apply<__nv_bfloat16>(x, s, scale, y, rows, d,
                                           d_total, eps, st);
  return cudaErrorInvalidValue;
}

extern "C" int rmsnorm_row_bwd(const void* x, const void* dy,
                               const void* scale, const void* ss,
                               const void* dot, void* dx, void* part,
                               void* dscale, int rows, int d, int d_total,
                               int nb, float eps, int dtype, void* stream) {
  if (rows <= 0 || nb <= 0 || nb > rows) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(ss);
  const float* t = static_cast<const float*>(dot);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return launch_row_bwd<float>(x, dy, scale, s, t, dx, p, dscale, rows, d,
                                 d_total, nb, eps, st);
  if (dtype == 1)
    return launch_row_bwd<__nv_bfloat16>(x, dy, scale, s, t, dx, p, dscale,
                                         rows, d, d_total, nb, eps, st);
  return cudaErrorInvalidValue;
}
