// Flash-attention forward for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:101 (_fwd_kernel /
// flash_attention_fwd): FlashAttention-2 forward, causal and/or
// sliding-window, GQA (query head h reads kv head h / G), scale
// 1/sqrt(D), online softmax with fp32 running max m, denominator l
// (clamped at 1e-30) and accumulator.  The TPU grid (B, H, nq, nk) runs
// its last axis in order and carries m, l and acc across it in VMEM
// scratch; CUDA blocks run in no order, so here one block owns one
// (b, h, query tile) and walks its kv tiles itself, in a loop bounded by
// the causal and window limits (masked tiles are never loaded).  Inputs
// are read through their strides in the model's [B, S, H, D] layout (no
// transposes); the output is contiguous [B, S, H, D].
//
// What bounds it on this card: per head the kernel does 4 * S^2 * D / 2
// flops (causal) on 4 * S * D input/output elements, about S / 4 flops
// per byte in bf16.  The H100's ridge is ~295 flops/byte, so at the
// prefill buckets of the main path (S <= 256) the bound is bytes (and,
// at ~1 us of work, launch latency), and from S ~ 1200 up it is
// operations: 0.104 ms of tensor-core work for phi3's [1, 4096, 32, 96].
//
// Two routes, chosen by dtype:
//
// bf16: tensor cores, loads overlapped with compute.  A block holds one
// or two consumer warpgroups (128 threads each; wgmma's M is 64, so each
// owns 64 query rows) and a producer that only issues TMA loads: 64 x 64
// tiles (one warpgroup, one producer warp) for short prompts, 128 x 128
// tiles (two warpgroups, a producer warpgroup that gives its registers
// to them with setmaxnreg) where those fill every SM.  Q, K and V are
// read through one 4-D tensor map each over the strided layout (dims D,
// heads, seq, B; a box of 64 columns x 64 or 128 rows, 128-byte swizzle),
// so no consumer spends registers or instructions on addresses.  D is
// padded to 64 or 128 in shared memory only: the map's dim-0 extent
// stays D and TMA writes zeros past it (and past seq, so ragged query
// and key tiles need no guards on the loads).  Q is loaded once; K and
// V go through 2-stage rings with full/empty mbarriers per stage
// (expect-tx bytes): the producer refills a stage as soon as every
// consumer warp has read it, so the next tiles load while this one
// computes.  S = Q K^T is wgmma m64n{64,128}k16 with both operands
// K-major in shared memory, over D / 16 k-steps (the zero padding is
// skipped).  The online softmax runs on the accumulator fragments in
// registers (a row lives in the 4 threads of a quad: max by two
// shuffles; l is summed per thread and reduced once at the end); scores
// are masked with -1e30 before exp on the tiles that hold a masked pair
// only (the diagonal tile, the first tiles of a window, keys past Sk).
// P is rounded to bf16 in registers and is wgmma's A operand from
// registers (the score fragment is the A fragment, no shuffles); O += P V
// is wgmma m64n{64,96,112,128}k16 (D rounded up to a width) with V read
// MN-major (transpose bit set on B).  What keeps the tensor cores busy:
// each warpgroup issues P_{j-1} V_{j-1} right behind S_j = Q K_j^T and
// runs the softmax of tile j while that product runs, and the two
// warpgroups take turns on the tensor cores (named barriers), so one's
// softmax overlaps the other's products.  The epilogue divides by l and
// stores 16-byte words of the rows < S and columns < D through shared
// memory.
//
// Both routes write the fp32 row log-sum-exp of the scaled scores,
// lse[b, h, i] = m_i + log(l_i) (natural log), when the caller passes a
// buffer (training: the backward in flash_attention_bwd.cu recomputes P
// from it); with a null pointer nothing else changes, so the serve
// paths' outputs are the same bits with and without it.
//
// fp32: the first kernel of the port (no tensor cores: TF32 would break
// the 2e-5 tolerance of the fp32 route).  One block per (b, h, 32-query
// tile); each kv tile (32 keys) staged in shared memory as fp32; each
// warp owns 8 query rows, lane j scores key j, row max and sum by warp
// shuffles, P @ V with each V element loaded once for all 8 rows.  It is
// bounded by shared-memory bandwidth and launch latency.
#include "hopper.cuh"   // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

using namespace hopper;

constexpr int BQ = 32;              // query rows per block
constexpr int BK = 32;              // keys per kv tile (one per lane)
constexpr int kWarps = 4;
constexpr int kRows = BQ / kWarps;  // query rows per warp
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
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
  float* lse;         // [B, H, S] or nullptr
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
  // when the words do not split evenly over the threads the last round
  // is guarded (never in fp32, where a tile is D / 16 rounds)
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
    if (a.lse != nullptr && lane == 0)
      a.lse[((size_t)b * a.H + h) * a.S + qp] = m[rr] + logf(denom);
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

// A block holds WG consumer warpgroups of 64 query rows each and walks
// kv tiles of 64 * WG keys: WG = 2 (128 x 128 tiles) where that fills the
// card, WG = 1 (64 x 64) for short prompts.  TMA boxes are 64 head-dim
// columns (128 bytes, the swizzle span) by 64 * WG rows.
constexpr int kStages = 2;     // K/V ring depth

// Turns of the two consumer warpgroups on the tensor cores (WG = 2):
// warpgroup w waits for its turn (named barrier 2 + w) before it issues
// its wgmma, and passes the turn on once they are issued, so one
// warpgroup's softmax runs while the other's products do
template <int WG>
__device__ __forceinline__ void turn_wait(int wg) {
  if constexpr (WG == 2)
    asm volatile("bar.sync %0, 256;" ::"r"(2 + wg) : "memory");
}
template <int WG>
__device__ __forceinline__ void turn_pass(int wg) {
  if constexpr (WG == 2)
    asm volatile("bar.arrive %0, 256;" ::"r"(3 - wg) : "memory");
}

// threads of a block: WG consumer warpgroups and a producer warp (WG = 1)
// or warpgroup (WG = 2)
template <int WG>
constexpr int kThreads = 128 * WG + (WG == 2 ? 128 : 32);

struct TileArgs {
  __nv_bfloat16* o;
  float* lse;         // [B, H, S] or nullptr
  int S, Sk, H, KV, D, causal, window;
  float scale_log2;   // 1/sqrt(D) * log2(e): softmax in base 2
};

// the block's mbarriers: Q, and per stage of the rings K and V full
// (TMA bytes landed) and empty (every consumer warp done reading)
struct Barriers {
  uint64_t q;
  uint64_t k_full[kStages], v_full[kStages];
  uint64_t k_empty[kStages], v_empty[kStages];
};

// S = Q K^T for one kv tile of N keys: KD k-steps of 16 head-dim columns
// (D / 16: the zero columns of the padding are skipped); a step inside
// a swizzled 128-byte row moves the start address by 32 bytes.  q_rows
// is this warpgroup's first row of the Q tile, `box` the bytes of one
// 64-column box
template <int KD, int N>
__device__ __forceinline__ void issue_qk(float (&sc)[N / 2], uint32_t q_rows,
                                         uint32_t k_tile, int box) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const uint32_t off = (kk / 4) * box + (kk % 4) * 32;
    const uint64_t qd = sw128_desc(q_rows + off, 16);
    const uint64_t kd = sw128_desc(k_tile + off, 16);
    if constexpr (N == 64)
      wgmma_ss_n64(sc, qd, kd, kk > 0);
    else
      wgmma_ss_n128(sc, qd, kd, kk > 0);
  }
}

// O += P V for one kv tile of N keys: N / 16 k-steps, P from registers;
// a step moves 16 rows of V (2048 bytes), the boxes of V are `box` apart.
// DN output columns: D rounded up to 64, 96, 112 or 128
template <int DN, int N>
__device__ __forceinline__ void issue_pv(float (&acc)[DN / 2],
                                         const uint32_t (&pa)[N / 4],
                                         uint32_t v_tile, int box) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t frag[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                              pa[4 * kk + 3]};
    const uint64_t vd = sw128_desc(v_tile + kk * 16 * 128, box);
    if constexpr (DN == 64)
      wgmma_rs_n64(acc, frag, vd);
    else if constexpr (DN == 96)
      wgmma_rs_n96(acc, frag, vd);
    else if constexpr (DN == 112)
      wgmma_rs_n112(acc, frag, vd);
    else
      wgmma_rs_n128(acc, frag, vd);
  }
}

// Online softmax of one [64 x N] score tile in registers.  Masks with
// -1e30 before exp, only on tiles that hold a masked pair (the diagonal
// tile, the first tiles of a window, keys past Sk); each row lives in
// the 4 threads of a quad (max by two shuffles; l stays per thread and
// is reduced once at the end).  Leaves P (fp32) in sc and the factor
// that rescales the accumulator in alpha.  q0: the warpgroup's first
// query row.
template <int N>
__device__ __forceinline__ void online_softmax(float (&sc)[N / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               const TileArgs& a, int q0,
                                               int kt, int r0, int c0) {
  const bool masked = kt + N > a.Sk || (a.causal && kt + N - 1 > q0) ||
                      (a.window > 0 && q0 + 63 - kt >= a.window);
  if (masked) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int qp = q0 + r0 + 8 * ((i / 2) % 2);
      const int kp = kt + 8 * (i / 4) + c0 + i % 2;
      bool ok = kp < a.Sk;
      if (a.causal) ok = ok && kp <= qp;
      if (a.window > 0) ok = ok && qp - kp < a.window;
      if (!ok) sc[i] = kNegInf;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = fast_exp2((m[r] - mx[r]) * a.scale_log2);
    m[r] = mx[r];
    // a row with no key on the mask yet (a window's first tiles): its
    // masked scores must give p = 0.  With mb = -1e30 * scale_log2 the
    // fma below leaves that product's rounding error, up to ~1e21, and
    // exp2 of it is inf (then inf * 0 = NaN at the next rescale)
    mb[r] = mx[r] == kNegInf ? 0.f : mx[r] * a.scale_log2;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    sc[i] = fast_exp2(fmaf(sc[i], a.scale_log2, -mb[(i / 2) % 2]));
    l[(i / 2) % 2] += sc[i];
  }
}

// P (fp32, score layout) -> bf16 pairs in wgmma's A-fragment order: for
// k-step kk the pairs (i, i + 1), i = 8 kk, 8 kk + 2, 8 kk + 4, 8 kk + 6
template <int N>
__device__ __forceinline__ void pack_p(const float (&sc)[N / 2],
                                       uint32_t (&pa)[N / 4]) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) pa[i / 2] = pack_bf16(sc[i], sc[i + 1]);
}

// The producer: Q once, then K and V of every kv tile, each into its
// ring stage as soon as the consumers have released it.  One thread.
template <int NB, int WG>
__device__ __forceinline__ void produce(
    const CUtensorMap* qmap, const CUtensorMap* kmap, const CUtensorMap* vmap,
    Barriers& bars, uint32_t qs, uint32_t ks, uint32_t vs, int q0, int h,
    int kvh, int b, int k_lo, int n) {
  constexpr int kTile = 64 * WG;
  constexpr int kBoxBytes = kTile * kBox * 2;
  constexpr int kTileBytes = NB * kBoxBytes;
  const uint32_t qbar = smem_addr(&bars.q);
  mbar_expect_tx(qbar, kTileBytes);
#pragma unroll
  for (int c = 0; c < NB; ++c)
    tma_load(qs + c * kBoxBytes, qmap, qbar, c * kBox, h, q0, b);
  for (int t = 0; t < n; ++t) {
    const int s = t % kStages, u = t / kStages, kt = k_lo + t * kTile;
    const uint32_t kf = smem_addr(&bars.k_full[s]);
    const uint32_t vf = smem_addr(&bars.v_full[s]);
    if (u > 0) mbar_wait(smem_addr(&bars.k_empty[s]), (u - 1) & 1);
    mbar_expect_tx(kf, kTileBytes);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tma_load(ks + s * kTileBytes + c * kBoxBytes, kmap, kf, c * kBox,
               kvh, kt, b);
    if (u > 0) mbar_wait(smem_addr(&bars.v_empty[s]), (u - 1) & 1);
    mbar_expect_tx(vf, kTileBytes);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tma_load(vs + s * kTileBytes + c * kBoxBytes, vmap, vf, c * kBox,
               kvh, kt, b);
  }
}

// A consumer warpgroup: S = Q K^T, softmax and O += P V over the kv
// tiles, then the epilogue, for query rows 64 wg .. 64 wg + 63 of the
// block's tile.  `tile_mem` is the generic address of the Q tile.
template <int NB, int KD, int WG>
__device__ __forceinline__ void consume(const TileArgs& a, Barriers& bars,
                                        uint8_t* tile_mem, uint32_t qs,
                                        uint32_t ks, uint32_t vs, int q0,
                                        int h, int b, int k_lo, int n,
                                        int tid) {
  constexpr int kTile = 64 * WG;
  constexpr int kBoxBytes = kTile * kBox * 2;
  constexpr int kTileBytes = NB * kBoxBytes;
  // output columns of P V: D rounded up to a wgmma width (80 -> 96)
  constexpr int DN = KD <= 4 ? 64 : KD <= 6 ? 96 : 16 * KD;
  const int warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;               // this consumer's query rows:
  const int qw = q0 + 64 * wg;           // qw .. qw + 63, in the Q tile
  const uint32_t q_rows = qs + 64 * wg * 128;   // from row 64 wg on
  const int r0 = 16 * (warp % 4) + lane / 4;    // this thread's rows: r0,
  const int c0 = 2 * (lane % 4);         // r0 + 8; first column in 8
  float acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // running max of raw scores
  float l[2] = {0.f, 0.f};           // this thread's part of the row sum
  float sc[kTile / 2], alpha[2];
  uint32_t pa[kTile / 4];            // P of the previous tile, bf16 pairs

  if (n > 0) {
    if (wg == 1) turn_pass<WG>(1);   // warpgroup 0 goes first
    mbar_wait(smem_addr(&bars.q), 0);
    mbar_wait(smem_addr(&bars.k_full[0]), 0);
    fence_regs(sc);
    turn_wait<WG>(wg);
    wgmma_fence();
    issue_qk<KD, kTile>(sc, q_rows, ks, kBoxBytes);
    wgmma_commit();
    turn_pass<WG>(wg);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(smem_addr(&bars.k_empty[0]));
    online_softmax<kTile>(sc, m, l, alpha, a, qw, k_lo, r0, c0);
    pack_p<kTile>(sc, pa);
  }
  for (int j = 1; j < n; ++j) {
    const int s = j % kStages, sp = (j - 1) % kStages;
    mbar_wait(smem_addr(&bars.k_full[s]), (j / kStages) & 1);
    mbar_wait(smem_addr(&bars.v_full[sp]), ((j - 1) / kStages) & 1);
    fence_regs(sc);
    fence_regs(acc);
    turn_wait<WG>(wg);
    wgmma_fence();
    issue_qk<KD, kTile>(sc, q_rows, ks + s * kTileBytes, kBoxBytes);
    wgmma_commit();
    issue_pv<DN, kTile>(acc, pa, vs + sp * kTileBytes, kBoxBytes);
    wgmma_commit();
    turn_pass<WG>(wg);
    wgmma_wait<1>();   // S_j is done; P_{j-1} V_{j-1} may still run
    fence_regs(sc);
    if (lane == 0) mbar_arrive(smem_addr(&bars.k_empty[s]));
    online_softmax<kTile>(sc, m, l, alpha, a, qw, k_lo + j * kTile, r0, c0);
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(smem_addr(&bars.v_empty[sp]));
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
    pack_p<kTile>(sc, pa);
  }
  if (n > 0) {   // P V of the last tile
    const int sp = (n - 1) % kStages;
    mbar_wait(smem_addr(&bars.v_full[sp]), ((n - 1) / kStages) & 1);
    fence_regs(acc);
    turn_wait<WG>(wg);
    wgmma_fence();
    issue_pv<DN, kTile>(acc, pa, vs + sp * kTileBytes, kBoxBytes);
    wgmma_commit();
    if (wg == 0) turn_pass<WG>(0);   // 1 passes its last turn to no one
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // epilogue: divide by l, stage the bf16 tile in shared memory (the K
  // ring is free now), store whole 16-byte words of the rows < S and
  // the columns < D into contiguous [B, S, H, D]
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  // the row LSE in natural-log units of the scaled scores: m is the
  // raw-score max, l sums exp2((s - m) * scale_log2); only real rows
  // (< S) are stored, not TMA's zero-filled padding
  if (a.lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = qw + r0 + 8 * r;
      if (qp < a.S)
        a.lse[(static_cast<size_t>(b) * a.H + h) * a.S + qp] =
            m[r] * a.scale_log2 * 0.6931471805599453f +
            logf(fmaxf(l[r], 1e-30f));
    }
  }
  constexpr int kPitch = NB * kBox + 8;   // elements; against conflicts
  static_assert(kTile * kPitch * 2 <= kStages * kTileBytes,
                "the output tile fits in the K ring");
  __nv_bfloat16* ot = reinterpret_cast<__nv_bfloat16*>(
      tile_mem + kTileBytes);
  consumer_sync<128 * WG>();   // every warp is done with the rings
#pragma unroll
  for (int i = 0; i < DN / 2; i += 2) {
    const int r = 64 * wg + r0 + 8 * ((i / 2) % 2);
    *reinterpret_cast<__nv_bfloat162*>(ot + r * kPitch + 8 * (i / 4) + c0) =
        __floats2bfloat162_rn(acc[i] * inv[(i / 2) % 2],
                              acc[i + 1] * inv[(i / 2) % 2]);
  }
  consumer_sync<128 * WG>();
  const int words = a.D / 8;
  for (int idx = tid; idx < kTile * words; idx += 128 * WG) {
    const int row = idx / words, w = idx % words, qp = q0 + row;
    if (qp < a.S)
      *reinterpret_cast<uint4*>(
          a.o + ((static_cast<size_t>(b) * a.S + qp) * a.H + h) * a.D +
          8 * w) = *reinterpret_cast<const uint4*>(ot + row * kPitch + 8 * w);
  }
}

// One block per (b, h, tile of 64 * WG queries): WG consumer warpgroups
// (warps 0 .. 4 WG - 1: wgmma, softmax, epilogue), each owning 64 query
// rows, and a producer (warps from 4 WG on; one thread issues TMA) that
// feeds them all the same kv tiles of 64 * WG keys.  NB is the number of
// 64-column boxes D is padded to in shared memory (1: D <= 64, 2: D <=
// 128; TMA fills the columns past D with zeros); KD = D / 16 is the
// k-steps of Q K^T.
//
// Each consumer's loop is software-pipelined, so the tensor cores work
// while the warpgroup runs the softmax: in iteration j it issues
// S_j = Q K_j^T and then O += P_{j-1} V_{j-1}, waits for S_j only, runs
// the softmax of tile j while the P V product runs, then waits for it,
// rescales O and packs P_j.  Each finished read releases its ring
// stage to the producer through that stage's empty barrier.
//
// Accumulator layout of wgmma m64nN (fp32): thread t of a warpgroup
// holds rows r0 = 16 * (t / 32) + (t % 32) / 4 and r0 + 8; register i
// sits at row r0 + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (t % 4) +
// i % 2.  That is also the A-fragment layout of wgmma's register
// operand, so P never leaves the registers.
template <int NB, int KD, int WG>
__global__ void __launch_bounds__(kThreads<WG>, 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const TileArgs a) {
  static_assert(KD <= 4 * NB, "Q K^T stays inside the padded head dim");
  constexpr int kTile = 64 * WG;                   // query rows = keys
  constexpr int kTileBytes = NB * kTile * kBox * 2;  // one Q, K or V tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ Barriers bars;
  // 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t qs = raw + pad;                   // Q tile
  const uint32_t ks = qs + kTileBytes;             // K ring
  const uint32_t vs = ks + kStages * kTileBytes;   // V ring

  const int tid = threadIdx.x, warp = tid / 32;
  // blocks start in order of x fastest: every head's query tiles with
  // the most keys (causal) go first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int h = blockIdx.x, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);

  // kv tiles this block needs: [k_lo, k_hi), n tiles
  const int q_last = min(q0 + kTile, a.S) - 1;
  const int k_hi = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  k_lo = k_lo / kTile * kTile;
  const int n = k_hi > k_lo ? (k_hi - k_lo + kTile - 1) / kTile : 0;

  if (tid == 0) {
    mbar_init(smem_addr(&bars.q), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&bars.k_full[s]), 1);
      mbar_init(smem_addr(&bars.v_full[s]), 1);
      mbar_init(smem_addr(&bars.k_empty[s]), 4 * WG);
      mbar_init(smem_addr(&bars.v_empty[s]), 4 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WG) {
    // the producer: one thread issues every load.  With two consumer
    // warpgroups the producer is a whole warpgroup, so that it can hand
    // its registers to them (an SM sub-partition holds one producer warp
    // and two consumer warps: 24 + 2 x 240 registers a lane)
    if constexpr (WG == 2) setmaxnreg_dec<24>();
    if (tid == 128 * WG && n > 0)
      produce<NB, WG>(&qmap, &kmap, &vmap, bars, qs, ks, vs, q0, h, kvh, b,
                      k_lo, n);
  } else {
    if constexpr (WG == 2) setmaxnreg_inc<240>();
    consume<NB, KD, WG>(a, bars, smem_raw + pad, qs, ks, vs, q0, h, b, k_lo,
                        n, tid);
  }
}

template <int NB, int KD, int WG>
int launch_wgmma(const CUtensorMap& qm, const CUtensorMap& km,
                 const CUtensorMap& vm, const TileArgs& t, int B,
                 cudaStream_t stream) {
  constexpr int smem = 1024 + (1 + 2 * kStages) * NB * 64 * WG * kBox * 2;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma<NB, KD, WG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(t.H, (t.S + 64 * WG - 1) / (64 * WG), B);
  flash_fwd_wgmma<NB, KD, WG><<<grid, kThreads<WG>, smem, stream>>>(
      qm, km, vm, t);
  return cudaGetLastError();
}

template <int WG>
int dispatch_bf16_tiles(const Args& a, int B, int D, cudaStream_t s) {
  const int rows = 64 * WG;
  CUtensorMap qm, km, vm;
  if (!encode(&qm, a.q, D, a.H, a.S, B, a.qsh, a.qss, a.qsb, rows) ||
      !encode(&km, a.k, D, a.KV, a.Sk, B, a.ksh, a.kss, a.ksb, rows) ||
      !encode(&vm, a.v, D, a.KV, a.Sk, B, a.vsh, a.vss, a.vsb, rows))
    return cudaErrorInvalidValue;
  const TileArgs t{static_cast<__nv_bfloat16*>(a.o), a.lse, a.S, a.Sk, a.H,
                   a.KV, D, a.causal, a.window, a.scale * kLog2e};
  switch (D) {
    case 16: return launch_wgmma<1, 1, WG>(qm, km, vm, t, B, s);
    case 32: return launch_wgmma<1, 2, WG>(qm, km, vm, t, B, s);
    case 48: return launch_wgmma<1, 3, WG>(qm, km, vm, t, B, s);
    case 64: return launch_wgmma<1, 4, WG>(qm, km, vm, t, B, s);
    case 80: return launch_wgmma<2, 5, WG>(qm, km, vm, t, B, s);
    case 96: return launch_wgmma<2, 6, WG>(qm, km, vm, t, B, s);
    case 112: return launch_wgmma<2, 7, WG>(qm, km, vm, t, B, s);
    case 128: return launch_wgmma<2, 8, WG>(qm, km, vm, t, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// 128 x 128 tiles where they give at least one block per SM, else 64 x 64
int dispatch_bf16(const Args& a, int B, int D, cudaStream_t s) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return cudaGetLastError();
  }
  const long long big = (long long)((a.S + 127) / 128) * a.H * B;
  return big >= sms ? dispatch_bf16_tiles<2>(a, B, D, s)
                    : dispatch_bf16_tiles<1>(a, B, D, s);
}

}  // namespace

// q: [B, S, H, D], k/v: [B, Sk, KV, D], each with unit stride on D and
// the given element strides on (B, seq, head), 16-byte aligned base
// pointers and strides; o: contiguous [B, S, H, D]; lse: contiguous fp32
// [B, H, S] or nullptr (not written).  D a multiple of 16
// up to 128; H % KV == 0.  dtype: 0 fp32 (FMA route), 1 bf16 (wgmma/TMA
// route).  window <= 0 means no window.  Returns cudaGetLastError(), or
// an error without launching when the arguments (or a tensor map) are
// refused.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int S, int Sk, int H, int KV, int D, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal,
    int window, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || Sk <= 0) return cudaErrorInvalidValue;
  Args a{q, k, v, o, static_cast<float*>(lse), S, Sk, H, KV, qsb, qss,
         qsh, ksb, kss, ksh, vsb, vss, vsh, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_fp32(a, B, D, s);
  if (dtype == 1) return dispatch_bf16(a, B, D, s);
  return cudaErrorInvalidValue;
}
