// SSD (Mamba2) intra-chunk block for Hopper (sm_90a), fp32, plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan/kernel.py
// (_kernel / ssd_intra_fwd).  Per (batch*chunk bc, head h), with
// cum [Q] the chunk's log-decay cumsum, xdt [Q, P] and B, C [Q, N]:
//
//   y_intra[t] = sum_{j <= t} (C_t . B_j) exp(cum_t - cum_j) xdt_j   [Q, P]
//   S_chunk    = sum_j exp(cum_last - cum_j) B_j xdt_j^T             [N, P]
//
// The TPU kernel takes one whole chunk per grid cell into VMEM and
// builds the [Q, Q] matrix there.  A CUDA block has far less fast
// memory, so the work is tiled like the flash kernel: one block owns
// one (bc, h, 32-query tile) and walks the 32-key tiles up to its
// diagonal (tiles above it are never loaded).  Each warp owns 8 query
// rows; lane j scores key j of the tile for all 8 rows (C_t . B_j from
// shared memory, B with a padded row stride so the 32 lanes hit 32
// banks), then multiplies by the decay, and the tile's [8, 32] weights
// meet xdt through warp shuffles, each lane accumulating ceil(P/32)
// output columns in registers.
//
// Masking comes BEFORE exp: above the diagonal cum_t - cum_j > 0 and
// the exponent can overflow; the Pallas kernel zeroes those entries
// after exp (a select), but a product with a 0/1 mask would give
// inf * 0 = NaN.  Here exp is evaluated only for j <= t < Q.
//
// S_chunk is a second kernel in this file: one block per (bc, h, 32
// state rows), looping over all key tiles; B's tile is scaled by
// exp(cum_last - cum_j) (<= 1, cum is non-increasing) as it is staged.
//
// Q is any value from 1 to the chunk length (the model's chunk is any
// divisor of the sequence length up to 256, e.g. 65), so every tile is
// guarded; P and N are multiples of 4 up to 128 (16-byte loads).
//
// What bounds it on this card: at zamba2-7b's prefill shapes (Q = 64,
// H = 112, P = N = 64) the function does ~Q^2 (N + P) + 2 Q N P flops
// per head on ~Q (N + P) fp32 inputs, about 15 flops per byte at
// Q = 64: below the ridge of the fp32 FMA units (67 TFLOP/s over
// 3.35 TB/s, ~20 flops per byte), so the bound is bytes.  This first
// kernel uses plain fp32 FMAs from shared memory; TF32 tensor cores
// would change the numbers beyond the 1e-4 tolerance and are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;              // query rows per block
constexpr int BK = 32;              // keys per tile (one per lane)
constexpr int BN = 32;              // state rows per S_chunk block
constexpr int kWarps = 4;
constexpr int kRows = BQ / kWarps;  // rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDim = 128;        // largest N and P

struct Args {
  const float* cum;  // [BC, Q, H]
  const float* xdt;  // [BC, Q, H, P]
  const float* b;    // [BC, Q, N]
  const float* c;    // [BC, Q, N]
  float* y;          // [BC, Q, H, P]
  float* s;          // [BC, H, N, P]
  int Q, H, N, P;
};

__host__ __device__ constexpr size_t y_smem_floats(int N, int P) {
  return (size_t)BQ * N + (size_t)BK * (N + 1) + (size_t)BK * P + BQ + BK;
}

// Stage rows [r0, r0 + rows) of a row-major slab (row stride `stride`
// floats, `width` floats per row, width % 4 == 0) into shared memory
// with row pitch `pitch`; rows past `n` are zero.
__device__ __forceinline__ void stage(float* dst, int pitch,
                                      const float* __restrict__ src,
                                      long long stride, int r0, int rows,
                                      int n, int width, int tid) {
  const int per_row = width / 4;
#pragma unroll 4
  for (int idx = tid; idx < rows * per_row; idx += kThreads) {
    const int r = idx / per_row, c = (idx % per_row) * 4;
    const float4 v =
        r0 + r < n ? __ldg(reinterpret_cast<const float4*>(
                         src + (r0 + r) * stride + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    float* d = dst + r * pitch + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

template <int NV>
__global__ void __launch_bounds__(kThreads) ssd_y_kernel(Args a) {
  extern __shared__ float smem[];
  const int N = a.N, P = a.P, Q = a.Q, H = a.H;
  float* cs = smem;                  // [BQ][N]   C rows of the query tile
  float* bs = cs + BQ * N;           // [BK][N+1] B rows of the key tile
  float* xs = bs + BK * (N + 1);     // [BK][P]   xdt rows of the key tile
  float* cq = xs + BK * P;           // [BQ]      cum of the queries
  float* ck = cq + BQ;               // [BK]      cum of the keys

  const int bc = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* cum = a.cum + (size_t)bc * Q * H + h;  // stride H
  const float* xdt = a.xdt + ((size_t)bc * Q * H + h) * P;

  stage(cs, N, a.c + (size_t)bc * Q * N, N, t0, BQ, Q, N, tid);
  if (tid < BQ) cq[tid] = t0 + tid < Q ? cum[(size_t)(t0 + tid) * H] : 0.f;

  float acc[kRows][NV];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[rr][i] = 0.f;

  const int k_hi = min(Q, t0 + BQ);  // keys j <= t < t0 + BQ
  for (int kt = 0; kt < k_hi; kt += BK) {
    __syncthreads();  // the previous tile is consumed (and cs is stored)
    stage(bs, N + 1, a.b + (size_t)bc * Q * N, N, kt, BK, Q, N, tid);
    stage(xs, P, xdt, (long long)H * P, kt, BK, Q, P, tid);
    if (tid < BK) ck[tid] = kt + tid < Q ? cum[(size_t)(kt + tid) * H] : 0.f;
    __syncthreads();

    // C_t . B_j for this warp's rows and key `lane`
    const float* brow = bs + lane * (N + 1);
    const float* cw = cs + warp * kRows * N;
    float sc[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) sc[rr] = 0.f;
    for (int n = 0; n < N; n += 4) {
      const float b0 = brow[n], b1 = brow[n + 1], b2 = brow[n + 2],
                  b3 = brow[n + 3];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float4 cv = *reinterpret_cast<const float4*>(cw + rr * N + n);
        sc[rr] += cv.x * b0 + cv.y * b1 + cv.z * b2 + cv.w * b3;
      }
    }
    // mask first, then decay: exp only where j <= t < Q
    const int j = kt + lane;
    float m[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr, t = t0 + r;
      m[rr] = (t < Q && j <= t) ? sc[rr] * expf(cq[r] - ck[lane]) : 0.f;
    }
    // M @ xdt: each xdt element is loaded once for all kRows rows
    const int jn = min(BK, k_hi - kt);
#pragma unroll 4
    for (int jj = 0; jj < jn; ++jj) {
      float xv[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int p = lane + 32 * i;
        xv[i] = p < P ? xs[jj * P + p] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float mj = __shfl_sync(0xffffffffu, m[rr], jj);
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[rr][i] += mj * xv[i];
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int t = t0 + warp * kRows + rr;
    if (t >= Q) continue;
    float* yrow = a.y + (((size_t)bc * Q + t) * H + h) * P;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int p = lane + 32 * i;
      if (p < P) yrow[p] = acc[rr][i];
    }
  }
}

template <int NV>
__global__ void __launch_bounds__(kThreads) ssd_state_kernel(Args a) {
  __shared__ float bs[BK * BN];       // [BK][BN] decayed B, this n tile
  __shared__ float xs[BK * kMaxDim];  // [BK][P]
  const int N = a.N, P = a.P, Q = a.Q, H = a.H;
  const int bc = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* cum = a.cum + (size_t)bc * Q * H + h;  // stride H
  const float* bmat = a.b + (size_t)bc * Q * N;
  const float* xdt = a.xdt + ((size_t)bc * Q * H + h) * P;
  const float cum_last = cum[(size_t)(Q - 1) * H];

  float acc[kRows][NV];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[rr][i] = 0.f;

  for (int kt = 0; kt < Q; kt += BK) {
    __syncthreads();
#pragma unroll 4
    for (int idx = tid; idx < BK * BN; idx += kThreads) {
      const int r = idx / BN, n = n0 + idx % BN, j = kt + r;
      bs[idx] = (j < Q && n < N)
                    ? __ldg(bmat + (size_t)j * N + n) *
                          expf(cum_last - cum[(size_t)j * H])
                    : 0.f;
    }
    stage(xs, P, xdt, (long long)H * P, kt, BK, Q, P, tid);
    __syncthreads();
    const int jn = min(BK, Q - kt);
#pragma unroll 4
    for (int jj = 0; jj < jn; ++jj) {
      float xv[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int p = lane + 32 * i;
        xv[i] = p < P ? xs[jj * P + p] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float bj = bs[jj * BN + warp * kRows + rr];  // broadcast
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[rr][i] += bj * xv[i];
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int n = n0 + warp * kRows + rr;
    if (n >= N) continue;
    float* srow = a.s + (((size_t)bc * H + h) * N + n) * P;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int p = lane + 32 * i;
      if (p < P) srow[p] = acc[rr][i];
    }
  }
}

template <int NV>
int launch(const Args& a, int BC, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_y_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * y_smem_floats(kMaxDim, kMaxDim)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const size_t smem = sizeof(float) * y_smem_floats(a.N, a.P);
  const dim3 grid_y((a.Q + BQ - 1) / BQ, a.H, BC);
  ssd_y_kernel<NV><<<grid_y, kThreads, smem, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid_s((a.N + BN - 1) / BN, a.H, BC);
  ssd_state_kernel<NV><<<grid_s, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// cum: [BC, Q, H]; xdt: [BC, Q, H, P]; b, c: [BC, Q, N]; y: [BC, Q, H, P];
// s: [BC, H, N, P]; all fp32, contiguous, 16-byte aligned.  Q >= 1;
// N and P multiples of 4 in [4, 128].  Launches the y_intra and the
// S_chunk kernel; returns cudaGetLastError() after them.
extern "C" int ssd_intra_fwd(const void* cum, const void* xdt, const void* b,
                             const void* c, void* y, void* s, int BC, int Q,
                             int H, int N, int P, void* stream) {
  if (BC <= 0 || H <= 0) return cudaSuccess;
  if (Q <= 0 || N <= 0 || P <= 0 || N % 4 || P % 4 || N > kMaxDim ||
      P > kMaxDim)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(cum), static_cast<const float*>(xdt),
               static_cast<const float*>(b),   static_cast<const float*>(c),
               static_cast<float*>(y),         static_cast<float*>(s),
               Q, H, N, P};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((P + 31) / 32) {
    case 1: return launch<1>(a, BC, st);
    case 2: return launch<2>(a, BC, st);
    case 3: return launch<3>(a, BC, st);
    default: return launch<4>(a, BC, st);
  }
}
