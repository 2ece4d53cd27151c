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
