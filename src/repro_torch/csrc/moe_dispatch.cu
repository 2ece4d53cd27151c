// MoE sort dispatch fused with the capacity-buffer gather, for Hopper
// (sm_90a); plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_dispatch/kernel.py
// (_kernel / moe_gather_fwd), buf[e, c, :] = x[slot_token[e*C + c], :]
// with zeros for empty slots, and takes in the sort that builds its
// slot map (src/repro/models/moe.py, the stable argsort by expert, the
// per-expert counts and positions, the capacity cut).  From the router's
// top-k experts eidx [T, k] (int64, as torch.topk gives them) it writes
//
//   dest_tk [T*k]  the slot e*C + rank of pair j = t*k + s, where rank is
//                  the pair's position among expert e's pairs in flat
//                  order (what a stable sort by expert gives), or the
//                  drop slot E*C when rank >= C;
//   counts  [E]    the pairs routed to each expert (for the aux loss);
//   buf  [E, C, d] the rows of x that fill each expert's first C slots,
//                  zeros after its last pair.
//
// What bounds it on this card: one launch and two round trips to memory.
// The work is a scan of T*k ids (a few KB) and a copy of at most E*C rows
// (2-4 MB on the MoE paths, about a microsecond of bandwidth).  Eager
// PyTorch spends ~20 launches on the sort and the inverse map, and its
// bincount reads its input's min and max back to the host.  Here one
// block (or a few, `splits`, so that the grid covers the SMs) owns one
// expert: it scans eidx in tiles of 1024 pairs, four per thread with all
// loads issued first, and ranks its expert's pairs in flat order with
// warp ballots and a 32-entry scan of the warp counts in shared memory,
// so no atomics are needed and every run gives the same map.  Each pair
// has one expert, so one block writes each dest_tk entry.  The tokens of
// the block's slots stay in shared memory, and after the scan each warp
// copies whole rows with 16-byte loads and stores (a bit copy, exact for
// any dtype), eight loads in flight before their stores.
//
// moe_dispatch_bwd, the gradient of the buffer in x, replaces JAX's
// autodiff of the capacity scatter buf.at[dest].set(jnp.take(xf,
// token_of)) (src/repro/models/moe.py:110).  Each filled slot holds
// exactly one pair, so
//
//   dx[t] = sum over t's pairs s with dest_tk[t*k + s] < E*C of
//           dbuf[dest_tk[t*k + s]]
//
// is a gather per token, not a scatter: no atomics, and every run gives
// the same bits.  A warp owns a token: its first k lanes read the pairs'
// slots and rank them (ballots and shuffles, no local memory), so the
// slots are added in ascending order, the order in which the buffer
// holds them; dropped pairs (slot E*C) rank last and are skipped.  The
// sum is fp32 from 16-byte loads of dbuf rows (eight bf16 or four fp32
// values a load, four loads in flight a lane), rounded once to the
// dtype as PyTorch rounds (to nearest even), so that it is bit-exact
// with moe_dispatch_bwd_ref.  What bounds it on this card: bytes, the
// kept pairs' rows of dbuf read (at most T*k*d values; dropped pairs are
// not read), the T*d values of dx written and the T*k slot ids read.  At
// olmoe's 4096-token step (k 8, d 2048, bf16) with no pair dropped that
// is 151 MB, 45 us at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                    // pairs per thread per tile
constexpr int kTile = kThreads * kPer;     // 1024 pairs
constexpr int kMaxSplitRows = 8192;        // slot tokens in shared memory
constexpr int kUnroll = 8;                 // 16-byte loads in flight a lane
static_assert(kPer * kWarps == 32, "one warp scans the warp counts");

__global__ void __launch_bounds__(kThreads)
moe_dispatch_kernel(const long long* __restrict__ eidx,
                    const uint4* __restrict__ x, uint4* __restrict__ buf,
                    int* __restrict__ dest_tk, int* __restrict__ counts,
                    int N, int k, int E, int C, int nv, int splits,
                    int split_rows) {
  extern __shared__ int slot_tok[];        // [split_rows]
  __shared__ int wcount[2][32];
  __shared__ int wbase[2][33];             // exclusive scan, then the total
  const int e = blockIdx.x / splits;
  const int c0 = (blockIdx.x % splits) * split_rows;
  const int c1 = min(C, c0 + split_rows);
  const bool writer = blockIdx.x % splits == 0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned below = (1u << lane) - 1u;

  // --- rank expert e's pairs in flat order --------------------------------
  // Double-buffered counts: tile t's buffers are rewritten in tile t + 2,
  // after two barriers that every reader of tile t has passed.
  int total = 0;
  for (int t0 = 0, tile = 0; t0 < N; t0 += kTile, ++tile) {
    const int b = tile & 1;
    long long ev[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int j = t0 + p * kThreads + threadIdx.x;
      ev[p] = j < N ? __ldg(eidx + j) : -1;
    }
    unsigned mask[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      mask[p] = __ballot_sync(0xffffffffu, ev[p] == e);
      if (lane == 0) wcount[b][p * kWarps + warp] = __popc(mask[p]);
    }
    __syncthreads();
    if (warp == 0) {   // entry p * kWarps + w precedes in flat order
      const int v = wcount[b][lane];
      int incl = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += n;
      }
      wbase[b][lane] = incl - v;
      if (lane == 31) wbase[b][32] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int j = t0 + p * kThreads + threadIdx.x;
      if (ev[p] == e) {
        const int rank = total + wbase[b][p * kWarps + warp]
                         + __popc(mask[p] & below);
        if (writer) dest_tk[j] = rank < C ? e * C + rank : E * C;
        if (rank >= c0 && rank < c1) slot_tok[rank - c0] = j / k;
      } else if (writer && e == 0 && j < N && (ev[p] < 0 || ev[p] >= E)) {
        dest_tk[j] = E * C;              // no expert: the drop slot
      }
    }
    total += wbase[b][32];
  }
  if (writer && threadIdx.x == 0) counts[e] = total;
  __syncthreads();

  // --- copy the block's slots: a warp per row -----------------------------
  for (int r = c0 + warp; r < c1; r += kWarps) {
    uint4* dst = buf + ((size_t)e * C + r) * nv;
    if (r < total) {
      const uint4* src = x + (size_t)slot_tok[r - c0] * nv;
      for (int i0 = lane; i0 < nv; i0 += 32 * kUnroll) {
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (i0 + 32 * u < nv) v[u] = __ldg(src + i0 + 32 * u);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (i0 + 32 * u < nv) dst[i0 + 32 * u] = v[u];
      }
    } else {
      for (int i = lane; i < nv; i += 32) dst[i] = make_uint4(0, 0, 0, 0);
    }
  }
}

constexpr int kMaxK = 32;                  // pairs a token: one a lane
constexpr int kBwdUnroll = 4;              // 16-byte loads in flight a lane

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
// PyTorch's float -> bfloat16: round to nearest even, NaN -> 0x7fc0
__device__ __forceinline__ uint32_t to_bf16(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

// kWords fp32 values a 16-byte word: 8 for bf16, 4 for fp32
template <bool kBf16>
__device__ __forceinline__ void add_word(float* acc, const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kBf16) {
      acc[2 * i] += bf16_lo(w[i]);
      acc[2 * i + 1] += bf16_hi(w[i]);
    } else {
      acc[i] += __uint_as_float(w[i]);
    }
  }
}

template <bool kBf16>
__device__ __forceinline__ uint4 pack_word(const float* acc) {
  if (kBf16)
    return make_uint4(to_bf16(acc[0]) | (to_bf16(acc[1]) << 16),
                      to_bf16(acc[2]) | (to_bf16(acc[3]) << 16),
                      to_bf16(acc[4]) | (to_bf16(acc[5]) << 16),
                      to_bf16(acc[6]) | (to_bf16(acc[7]) << 16));
  return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                    __float_as_uint(acc[2]), __float_as_uint(acc[3]));
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
moe_dispatch_bwd_kernel(const uint4* __restrict__ dbuf,
                        const int* __restrict__ dest_tk,
                        uint4* __restrict__ dx, int T, int k, int EC,
                        int nv) {
  constexpr int kWords = kBf16 ? 8 : 4;
  const int t = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (t >= T) return;
  // lane s < k holds pair s's slot; its rank among the token's slots
  // (ties, i.e. dropped pairs, broken by s) puts the slots in order
  const int mine = lane < k ? __ldg(dest_tk + (size_t)t * k + lane) : EC;
  int rank = 0;
  for (int j = 0; j < k; ++j) {
    const int other = __shfl_sync(0xffffffffu, mine, j);
    rank += other < mine || (other == mine && j < lane);
  }
  if (lane >= k) rank = 32;
  int sorted = EC, kept = 0;
  for (int r = 0; r < k; ++r) {
    const unsigned at = __ballot_sync(0xffffffffu, rank == r);
    const int slot = __shfl_sync(0xffffffffu, mine, __ffs(at) - 1);
    if (lane == r) sorted = slot;
    kept += slot < EC;
  }
  uint4* out = dx + (size_t)t * nv;
  // the loop is warp-uniform, so every lane reaches the shuffles
  for (int base = 0; base < nv; base += 32 * kBwdUnroll) {
    const int i0 = base + lane;
    float acc[kBwdUnroll][kWords];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u)
#pragma unroll
      for (int w = 0; w < kWords; ++w) acc[u][w] = 0.0f;
    for (int r = 0; r < kept; ++r) {           // ascending slots
      const uint4* row =
          dbuf + (size_t)__shfl_sync(0xffffffffu, sorted, r) * nv;
      uint4 v[kBwdUnroll];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u)
        if (i0 + 32 * u < nv) v[u] = __ldg(row + i0 + 32 * u);
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u)
        if (i0 + 32 * u < nv) add_word<kBf16>(acc[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u)
      if (i0 + 32 * u < nv) out[i0 + 32 * u] = pack_word<kBf16>(acc[u]);
  }
}

}  // namespace

// eidx: [T, k] int64, each id in [0, E) (an id outside it goes to the
// drop slot and to no count); x: [T, nv] and buf: [E, C, nv] 16-byte
// words, contiguous and 16-byte aligned; dest_tk: [T*k] int32; counts:
// [E] int32.  Every output element is written.  Returns
// cudaGetLastError() after the launch.
extern "C" int moe_dispatch_fwd(const void* eidx, const void* x, void* buf,
                                void* dest_tk, void* counts, int T, int k,
                                int E, int C, int nv, void* stream) {
  if (E <= 0 || C <= 0 || nv <= 0 || k <= 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess)
    return cudaGetLastError();
  // about two blocks an SM, at least 4 slots a block, at most
  // kMaxSplitRows slot tokens in a block's shared memory
  int splits = std::max(1, 2 * sms / E);
  splits = std::min(splits, std::max(1, C / 4));
  splits = std::max(splits, (C + kMaxSplitRows - 1) / kMaxSplitRows);
  const int split_rows = (C + splits - 1) / splits;
  splits = (C + split_rows - 1) / split_rows;
  moe_dispatch_kernel<<<E * splits, kThreads, split_rows * sizeof(int),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(eidx), static_cast<const uint4*>(x),
      static_cast<uint4*>(buf), static_cast<int*>(dest_tk),
      static_cast<int*>(counts), T * k, k, E, C, nv, splits, split_rows);
  return cudaGetLastError();
}

// dbuf: [E*C, nv] 16-byte words (bf16 when is_bf16, else fp32),
// contiguous and 16-byte aligned; dest_tk: [T*k] int32, each in [0,
// E*C] (E*C: dropped); dx: [T, nv] words of the same dtype, every one
// written.  Returns cudaGetLastError() after the launch.
extern "C" int moe_dispatch_bwd(const void* dbuf, const void* dest_tk,
                                void* dx, int T, int k, int EC, int nv,
                                int is_bf16, void* stream) {
  if (T < 0 || k <= 0 || k > kMaxK || EC <= 0 || nv <= 0)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  const int blocks = (T + kWarps - 1) / kWarps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* src = static_cast<const uint4*>(dbuf);
  const int* dest = static_cast<const int*>(dest_tk);
  uint4* out = static_cast<uint4*>(dx);
  if (is_bf16)
    moe_dispatch_bwd_kernel<true><<<blocks, kThreads, 0, st>>>(
        src, dest, out, T, k, EC, nv);
  else
    moe_dispatch_bwd_kernel<false><<<blocks, kThreads, 0, st>>>(
        src, dest, out, T, k, EC, nv);
  return cudaGetLastError();
}
