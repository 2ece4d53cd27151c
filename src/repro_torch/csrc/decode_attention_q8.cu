// Decode attention over an int8-quantized KV cache, for Hopper (sm_90a);
// plain C interface for ctypes.
//
// Replaces src/repro/models/attention.py:396 decode_attention_q8, which
// the JAX package writes in jnp (int8 x int8 dots with int32 sums): it
// is not a Pallas kernel there, but PyTorch has no integer batched
// product on CUDA to stand in for it.  One query token per slot, q
// [B,1,Hq,D] (bf16 or fp32) with Hq = KV*G; the cache holds int8 k, v
// [B,Smax,KV,D] and fp16 per-(token, head) scales k_scale, v_scale
// [B,Smax,KV].  For each (b, kv) and each of its G query rows:
//
//   qq, qs = quantize(q row)        qs = max(max|q|/127, 1e-8) in fp32,
//                                   qq = clip(rint(q/qs)); qs kept as fp16
//   s_i32[s] = sum_d qq[d]*k[s,d]   int32
//   s[s]  = ((s_i32*qs)*ks[s])*(1/sqrt(D)), NEG_INF where masked
//   p     = exp(s - max s) / sum exp(s - max s)
//   pv    = p*vs[s]; ps = max(max|pv|/127, 1e-20); pq = clip(rint(pv/ps))
//   o[d]  = (sum_s pq[s]*v[s,d]) * ps     int32 sums, then fp32
//
// in JAX's order of operations, so that only the exponentials and the
// order of the softmax sum differ from the reference.  The masks are
// those of the JAX function: a ring when Smax == window (every slot
// below min(len, Smax)), a window that is not a ring (len - window <= s
// < len), or s < len; len is per slot.
//
// What bounds it on this card: bytes.  Every int8 of k is read once,
// the fp16 scales, and the v rows whose pq is not 0 for some query row:
// at qwen2.5-32b's decode over 16 slots of 32768 tokens (8 kv heads, D
// 128) about 1.0 GB, 0.30 ms at 3.35 TB/s.  pq needs the softmax of the
// whole row first; four launches over an fp32 scratch [B,KV,G,Smax]
// (this kernel's first form) moved a third as much again, and spent its
// time in the passes between them.
//
// The design: one launch, nothing in device memory but the output.  A
// thread-block cluster per (b, kv) (cudaLaunchKernelEx, at most 8 blocks:
// the portable size), its C blocks splitting the Smax positions into
// slices of ops.py's `block_positions`; (b, kv) is the cluster's index,
// so the clusters in flight read every kv head of the same positions,
// whole records of KV*D bytes.  Each block, 256 threads:
//
//   A. quantizes the G query rows into shared memory; then each warp
//      streams its own 16-row m-tiles of k through registers (16-byte
//      loads, two m-tiles in flight, masked rows not read, no block
//      barrier) into mma.sync m16n8k32 s8, the G <= 8 query rows the N
//      of 8 (zero past G and past D), and writes the fp32 scores into
//      the block's shared memory (or, for caches too large, a global
//      scratch: the kOnChip flag), keeping the row maxima in registers
//      and the rows' v scales in shared memory;
//   B. the cluster's softmax statistics through distributed shared
//      memory, behind cluster barriers: the row max over the C blocks;
//      each block's sum of exp(s - m) (each thread in order, then a fixed
//      tree), the C partial sums added in rank order, so every run gives
//      the same bits; pv = p*vs in place and the cluster-wide max |pv|,
//      so ps is JAX's; then pq, laid out for the mma below, and a bit a
//      position that says whether any query row's pq is not 0;
//   C. each warp streams 32-position groups of v rows, 64 columns wide,
//      through registers (8-byte loads, two groups in flight), reading
//      only rows whose live bit is set, transposes them by byte permutes
//      into the A operand (columns by positions) and takes mma.sync
//      m16n8k32 s8 against pq with int32 sums;
//   D. the warps' sums into shared memory (integer atomics: exact), one
//      cluster barrier, and rank 0 adds the C blocks' sums and writes
//      o = float(sum)*ps in q's dtype.
//
// Why registers and not a ring of shared-memory stages: the scores take
// most of a block's shared memory (82,000 of 112,800 bytes at the timing
// shape), so a ring had room for two or three stages in flight, and its
// barrier a stage put each stage's mma and score stores on the path of
// the next load: the k pass alone took 0.48–0.66 ms that way, 0.21 ms
// through registers.  A block's shared memory (ops.py's `smem_bytes`
// mirrors `layout` below) is then the scores, pq and the v scales; at
// the timing shape two blocks share an SM (the occupancy the plan aims
// for: 30 clusters of 8 in flight), and one takes the other's barriers
// and softmax passes with its loads.  Shapes whose scores do not fit two
// to an SM run one block an SM; shapes whose scores do not fit one take
// the scratch form.  Registers are capped at 128 for two blocks of 256
// threads an SM.
//
// The split form: a context-parallel decode holds each slot's positions
// in blocks, one a rank, of a cache of `smax` positions.  The row's max,
// its sum of exp(s - m) and its max |pv| are each reduced over every
// block, and the int32 P·V sums summed, between ranks (ops.py
// all-reduces them).  So it runs as four launches a block, around those
// exchanges, over a global scratch [B,KV,G,Sl] of fp32 scores:
//   stage 0  the scores into the scratch, the row max to `stat_out`
//            (`q8_scores_kernel`);
//   stage 1  exp(s - m) in place with m from `stat_in`, the cluster's
//            sum to `stat_out` (`q8_decode_kernel<D, false, 1>`: the
//            cluster kernel's code);
//   stage 2  pv = (e / l) * vs in place, the cluster's max |pv|
//            (`q8_decode_kernel<D, false, 2>`);
//   stage 3  pq with ps from `stat_in`, P·V, the int32 sums [B,KV,G,D]
//            added into `out` (`q8_pq_kernel`).
// One C entry, `decode_attention_q8_stage`, launches any of them.
// Stages 1 and 2 are the cluster code: they add fp32 partial sums, so
// they keep the cluster plan and its rank order, and one block a row
// gives the one launch's bits.  Stages 0 and 3 are kernels of their own
// and need no cluster: a max and int32 sums are exact in any order, so
// their blocks combine by atomics (a float max on the ordered-int
// encoding; red.global.add.s32) and their bits do not depend on the
// grid.  Both are bound by bytes: stage 0 reads k and its scales once
// and writes the scores (at a rank's [16,2048,8,G 5,128] 39 MB, 0.0118
// ms at 3.35 TB/s), stage 3 reads the scores and the v rows whose pq is
// not 0.  They run persistent blocks, two an SM, each walking a
// contiguous run of work items through a ring of slots in shared
// memory, several items in flight (below): stage 0's k by the bulk-copy
// engine, stage 3's scores and v rows by cp.async.  A ring pays here
// though it did not in the one launch: there the scores took most of a
// block's shared memory, here they live in the global scratch, so a
// block has room for several 16 KB items in flight, and one barrier an
// item is all the ring costs.  k is read once (stage 0) and v once
// (stage 3); the scores cross device memory three times more, as the
// scratch form's do.  Masks take the block's global positions (`start`)
// and the whole cache's `smax`.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"   // mbarriers (the ring kernels' bulk copies)

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}
__host__ __device__ constexpr size_t larger(size_t a, size_t b) {
  return a > b ? a : b;
}

// Byte offsets in dynamic shared memory.  `np`: the block's positions
// rounded up to whole groups of 32.
//   qq    int8 [8][128]     the quantized query rows, zero past G and D
//   stat  float [8][8]      per row: qs, m, l, ps and this block's
//                           partials of m, l and max |pv|
//   red   float [8][8]      a partial a warp
//   live  u32 [np/32]       a bit a position: some pq is not 0
//   vs    fp16 [np]         the v scales, stored in phase A
//   x     pq [G][np + 16] (bytes, mma order)
//   y     the fp32 scores [G][np + 4] (on chip), then the block's int32
//         sums [G][D]
struct Layout {
  int np;
  size_t stat, red, live, vs, x, y, total;
};

__host__ __device__ Layout layout(bool on_chip, int n, int G, int D) {
  Layout L;
  L.np = (n + 31) / 32 * 32;
  L.stat = 8 * 128;
  L.red = L.stat + 8 * 8 * 4;
  L.live = L.red + 8 * 8 * 4;
  L.vs = L.live + round16(L.np / 8);
  L.x = L.vs + round16((size_t)2 * L.np);
  L.y = L.x + round16((size_t)G * (L.np + 16));
  size_t y = (size_t)4 * G * D;
  if (on_chip) y = larger(y, (size_t)4 * G * (L.np + 4));
  L.total = L.y + round16(y);
  return L;
}

enum Stat { kQs = 0, kM = 1, kL = 2, kPs = 3, kMPart = 4, kLPart = 5,
            kPPart = 6 };

struct Params {
  const void* q;
  const int8_t* k;
  const int8_t* v;
  const __half* k_scale;
  const __half* v_scale;
  const long long* lens;
  void* out;
  float* scratch;     // [B,KV,G,Smax] fp32, the scratch form only
  int* dbg_s;
  int8_t* dbg_pq;
  const float* stat_in;   // the split form: [B,KV,G], the exchange's
  float* stat_out;        // [B,KV,G], this launch's cluster part
  int q_bf16, Smax, KV, G, window, n;
  int pad[2];             // padding, read by nothing: the layout the
                          // one launch was tuned on (ptxas gives it 116 /
                          // 117 registers with it, 120 / 121 without)
  float scale;
};

constexpr int kWhole = -1;   // kStage of the one launch

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x / scale), -127.f), 127.f));
}

__device__ __forceinline__ bool attended(int s, long long len, int Smax,
                                         int window) {
  if (window > 0 && Smax == window) return s < min(len, (long long)Smax);
  return s < len && (window <= 0 || s >= len - window);
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a·b, a 16x32 s8 (row), b 32x8 s8 (col), d 16x8 s32
__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows w[0..3] (4 positions, 4 columns each) -> t[c] = column c at the
// 4 positions
__device__ __forceinline__ void transpose4(const uint32_t w[4],
                                           uint32_t t[4]) {
  const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t x1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t y0 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t y1 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(x0, y0, 0x5410);
  t[1] = __byte_perm(x0, y0, 0x7632);
  t[2] = __byte_perm(x1, y1, 0x5410);
  t[3] = __byte_perm(x1, y1, 0x7632);
}

// kAhead m-tiles of k rows in flight a warp: a lane's chunks of its two
// rows, and their fp16 scales of k and v
constexpr int kAhead = 2;
template <int kCh>
struct KTile {
  int4 r[2][kCh];
  unsigned short ks[2], vs[2];
};

// kVAhead groups of v rows in flight a warp: a lane's 8 bytes of its 8
// rows, [h][i] at position 8i + 2tig + h of the group
constexpr int kVAhead = 2;
struct VTile {
  uint2 w[2][4];
};

__device__ __forceinline__ uint32_t word(const int4& v, int i) {
  return static_cast<uint32_t>(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z
                                                                    : v.w);
}

// Position p (0..31) of a group of 32 sits at k = 16h + 4kq + i of the
// P·V mma (p = 8i + 2kq + h): lane (gid, kq) holds the rows of its k
// quads, and one load of the warp reads four whole row segments.
__device__ __forceinline__ int mma_order(int p) {
  return 16 * (p & 1) + 4 * ((p & 7) >> 1) + (p >> 3);
}

template <int D, bool kOnChip, int kStage>
__global__ void __launch_bounds__(kThreads, 2) q8_decode_kernel(Params p) {
  constexpr bool kOne = kStage == kWhole;
  constexpr int kChunks = D / 16;             // 16-byte chunks a row
  constexpr int kCh = (kChunks + 3) / 4;      // of them a lane, a k row
  constexpr int kStepsK = 2 * kCh;            // k-steps of the scores mma
  constexpr int kHalves = (D + 63) / 64;      // 64-column halves of v
  constexpr int kGroupStride = kWarps / kHalves;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)gridDim.x;
  const int bk = blockIdx.y, b = bk / p.KV, kv = bk % p.KV, G = p.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int t0 = rank * p.n;
  const int nv = max(0, min(p.n, p.Smax - t0));  // this block's positions
  const Layout L = layout(kOnChip, p.n, G, D);
  int8_t* qq = reinterpret_cast<int8_t*>(smem);
  float* stat = reinterpret_cast<float*>(smem + L.stat);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint32_t* live = reinterpret_cast<uint32_t*>(smem + L.live);
  unsigned short* vss = reinterpret_cast<unsigned short*>(smem + L.vs);
  unsigned char* xr = smem + L.x;
  unsigned char* yr = smem + L.y;
  int8_t* pqs = reinterpret_cast<int8_t*>(xr);
  const int pq_stride = L.np + 16;
  float* sc;                 // scores, row g at sc + g * ss
  size_t ss;
  if (kOnChip) {
    sc = reinterpret_cast<float*>(yr);
    ss = L.np + 4;
  } else {
    sc = p.scratch + (size_t)bk * G * p.Smax + t0;
    ss = p.Smax;
  }
  const long long len = p.lens[b];
  const size_t pos0 = (size_t)b * p.Smax + t0;   // cache position of j = 0

  if constexpr (kOne) {
    // ---- A. the query rows, then the scores ------------------------------
    {
      float x[4];
      float amax = 0.f;
      const size_t off = ((size_t)bk * G + warp) * D;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = lane + 32 * i;
        x[i] = 0.f;
        if (warp < G && d < D)
          x[i] = p.q_bf16 ? __bfloat162float(
                                static_cast<const __nv_bfloat16*>(p.q)[off + d])
                          : static_cast<const float*>(p.q)[off + d];
        amax = fmaxf(amax, fabsf(x[i]));
      }
      amax = warp_max(amax);
      const float qs = fmaxf(amax / 127.f, 1e-8f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = lane + 32 * i;
        qq[warp * 128 + d] = (warp < G && d < D) ? quantize(x[i], qs) : 0;
      }
      if (lane == 0)
        stat[kQs * 8 + warp] =
            warp < G ? __half2float(__float2half_rn(qs)) : 0.f;
    }
    __syncthreads();

    // A lane takes, of rows gid and gid + 8 of a 16-row m-tile, the 16-byte
    // chunks tig + 4i of D; its words 2s and 2s + 1 are its A operand of
    // k-step s.  The B operand takes the same bytes of qq, so the int32
    // sums are those of d in order.  Each warp streams its own m-tiles
    // through registers, kAhead in flight, with no block barrier.
    uint32_t qb[kStepsK][2];
#pragma unroll
    for (int s = 0; s < kStepsK; ++s) {
      const int c = tig + 4 * (s / 2), at = gid * 128 + 16 * c + 8 * (s % 2);
      qb[s][0] = c < kChunks ? ld32(reinterpret_cast<unsigned char*>(qq) + at)
                             : 0u;
      qb[s][1] = c < kChunks ? ld32(reinterpret_cast<unsigned char*>(qq) + at +
                                    4)
                             : 0u;
    }
    const float qs_e[2] = {stat[kQs * 8 + 2 * tig],
                           stat[kQs * 8 + 2 * tig + 1]};
    float mx[2] = {kNegInf, kNegInf};   // rows 2tig, 2tig+1
    const int m_tiles = (nv + 15) / 16;
    KTile<kCh> buf[kAhead];
    auto load_k = [&](KTile<kCh>& t, int mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 16 * mt + gid + 8 * h;
        const bool on = mt < m_tiles && j < nv &&
                        attended(t0 + j, len, p.Smax, p.window);
        const size_t row = (pos0 + j) * p.KV + kv;
#pragma unroll
        for (int i = 0; i < kCh; ++i) {
          const int c = tig + 4 * i;
          t.r[h][i] = on && c < kChunks
                          ? __ldg(reinterpret_cast<const int4*>(p.k + row * D) +
                                  c)
                          : make_int4(0, 0, 0, 0);
        }
        t.ks[h] = on ? __ldg(reinterpret_cast<const unsigned short*>(
                           p.k_scale) + row)
                     : (unsigned short)0;
        t.vs[h] = mt < m_tiles && j < nv && tig == 0
                      ? __ldg(reinterpret_cast<const unsigned short*>(
                            p.v_scale) + row)
                      : (unsigned short)0;
      }
    };
    auto scores = [&](const KTile<kCh>& t, int mt) {
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int s = 0; s < kStepsK; ++s) {
        const uint32_t a[4] = {word(t.r[0][s / 2], 2 * (s % 2)),
                               word(t.r[1][s / 2], 2 * (s % 2)),
                               word(t.r[0][s / 2], 2 * (s % 2) + 1),
                               word(t.r[1][s / 2], 2 * (s % 2) + 1)};
        mma_s8(acc, a, qb[s][0], qb[s][1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 16 * mt + gid + 8 * h;
        if (j >= nv) continue;
        if (tig == 0) vss[j] = t.vs[h];
        const bool att = attended(t0 + j, len, p.Smax, p.window);
        const float ks = __half2float(__ushort_as_half(t.ks[h]));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int g = 2 * tig + e;
          if (g >= G) continue;
          const int si = acc[2 * h + e];
          const float s =
              att ? ((static_cast<float>(si) * qs_e[e]) * ks) * p.scale
                  : kNegInf;
          sc[g * ss + j] = s;
          mx[e] = fmaxf(mx[e], s);
          if (p.dbg_s != nullptr)
            p.dbg_s[((size_t)bk * G + g) * p.Smax + t0 + j] = att ? si : 0;
        }
      }
    };
#pragma unroll
    for (int u = 0; u < kAhead; ++u) load_k(buf[u], warp + kWarps * u);
    for (int base = warp; base < m_tiles; base += kWarps * kAhead) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int mt = base + kWarps * u;
        if (mt < m_tiles) scores(buf[u], mt);
        load_k(buf[u], mt + kWarps * kAhead);
      }
    }

    // ---- B. the cluster's softmax statistics -----------------------------
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], o));
    if (gid == 0) {
      red[warp * 8 + 2 * tig] = mx[0];
      red[warp * 8 + 2 * tig + 1] = mx[1];
    }
    __syncthreads();
    if (tid < G) {
      float m = red[tid];
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w * 8 + tid]);
      stat[kMPart * 8 + tid] = m;
    }
    cluster.sync();
    if (tid < G) {
      float m = kNegInf;
      for (int r = 0; r < C; ++r)
        m = fmaxf(m, cluster.map_shared_rank(stat, r)[kMPart * 8 + tid]);
      stat[kM * 8 + tid] = m;
    }
    __syncthreads();
  } else {
    // the split form's stages 1 and 2: the statistic of the exchange
    // before this one (m or l), and in stage 2 the v scales
    if (tid < G)
      stat[(kStage == 1 ? kM : kL) * 8 + tid] =
          p.stat_in[(size_t)bk * G + tid];
    if constexpr (kStage == 2)
      for (int j = tid; j < nv; j += kThreads)
        vss[j] = __ldg(reinterpret_cast<const unsigned short*>(p.v_scale) +
                       (pos0 + j) * p.KV + kv);
    __syncthreads();
  }

  if constexpr (kOne || kStage == 1) {
    // exp(s - m) in place, summed by each thread in order, then a fixed
    // tree, then the warps in order, then the blocks in rank order
    {
      float m[kMaxG], l[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        m[g] = g < G ? stat[kM * 8 + g] : 0.f;
        l[g] = 0.f;
      }
      for (int j0 = tid; j0 < nv; j0 += 2 * kThreads) {
        float x[2][kMaxG];      // two positions' scores, loaded together
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            x[u][g] = g < G && j0 + kThreads * u < nv
                          ? sc[g * ss + j0 + kThreads * u] : 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (j0 + kThreads * u >= nv) break;
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g >= G) break;
            const float e = expf(x[u][g] - m[g]);
            sc[g * ss + j0 + kThreads * u] = e;
            l[g] += e;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        l[g] = warp_sum(l[g]);
        if (lane == 0) red[warp * 8 + g] = l[g];
      }
    }
    __syncthreads();
    if (tid < G) {
      float l = red[tid];
      for (int w = 1; w < kWarps; ++w) l += red[w * 8 + tid];
      stat[kLPart * 8 + tid] = l;
    }
    cluster.sync();
    if (tid < G) {
      float l = cluster.map_shared_rank(stat, 0)[kLPart * 8 + tid];
      for (int r = 1; r < C; ++r)
        l += cluster.map_shared_rank(stat, r)[kLPart * 8 + tid];
      if constexpr (kOne)
        stat[kL * 8 + tid] = l;
      else if (rank == 0)
        p.stat_out[(size_t)bk * G + tid] = l;
    }
    if constexpr (!kOne) {
      cluster.sync();
      return;
    }
    __syncthreads();
  }

  if constexpr (kOne || kStage == 2) {
    // pv = (e / l) * vs in place, and max |pv|
    {
      float l[kMaxG], pm[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        l[g] = g < G ? stat[kL * 8 + g] : 1.f;
        pm[g] = 0.f;
      }
      auto pv_at = [&](int j, float vs) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g >= G) break;
          const float pv = (sc[g * ss + j] / l[g]) * vs;
          sc[g * ss + j] = pv;
          pm[g] = fmaxf(pm[g], fabsf(pv));
        }
      };
      for (int j = tid; j < nv; j += kThreads)
        pv_at(j, __half2float(__ushort_as_half(vss[j])));
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        pm[g] = warp_max(pm[g]);
        if (lane == 0) red[warp * 8 + g] = pm[g];
      }
    }
    __syncthreads();
    if (tid < G) {
      float pm = red[tid];
      for (int w = 1; w < kWarps; ++w) pm = fmaxf(pm, red[w * 8 + tid]);
      stat[kPPart * 8 + tid] = pm;
    }
    cluster.sync();
    if (tid < G) {
      float pm = 0.f;
      for (int r = 0; r < C; ++r)
        pm = fmaxf(pm, cluster.map_shared_rank(stat, r)[kPPart * 8 + tid]);
      if constexpr (kOne)
        stat[kPs * 8 + tid] = fmaxf(pm / 127.f, 1e-20f);
      else if (rank == 0)
        p.stat_out[(size_t)bk * G + tid] = pm;
    }
    if constexpr (!kOne) {
      cluster.sync();
      return;
    }
    __syncthreads();
  }

  if constexpr (kOne) {
    // pq in mma order, and the live bits; a warp
    // takes 32 positions, so one ballot gives a group's bits
    {
      float ps[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) ps[g] = g < G ? stat[kPs * 8 + g] : 1.f;
      for (int j = tid; j < L.np; j += kThreads) {
        const int at = (j & ~31) + mma_order(j & 31);
        bool any = false;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g >= G) break;
          int8_t v = 0;
          if (j < nv) {
            v = quantize(sc[g * ss + j], ps[g]);
            if (p.dbg_pq != nullptr)
              p.dbg_pq[((size_t)bk * G + g) * p.Smax + t0 + j] = v;
          }
          pqs[g * pq_stride + at] = v;
          any |= v != 0;
        }
        const unsigned bits = __ballot_sync(0xffffffffu, any);
        if (lane == 0) live[j >> 5] = bits;
      }
    }
    __syncthreads();
    int* sums = reinterpret_cast<int*>(yr);   // over the dead scores
    for (int i = tid; i < G * D; i += kThreads) sums[i] = 0;

    // ---- C. P·V over the live v rows -------------------------------------
    // A unit: a group of 32 positions by 64 columns of v.  Lane (gid, tig)
    // takes 8 bytes (columns 64·half + 8gid ..) of the 8 rows at positions
    // 8i + 2tig + h, so that its rows are the four positions of each k
    // half of the mma (mma_order), transposed in registers into the A
    // operand (8 columns by 4 positions); pq is the B operand.  A warp
    // keeps one half of the columns and streams its groups through
    // registers, kVAhead in flight, skipping rows whose pq are all 0.
    const int groups = (nv + 31) / 32;
    const int half = warp % kHalves, gw = warp / kHalves;
    const int col0 = 64 * half + 8 * gid;
    auto load_v = [&](VTile& t, int grp) {
      const uint32_t bits = grp < groups ? live[grp] : 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int at = 8 * i + 2 * tig + h, j = 32 * grp + at;
          t.w[h][i] = (bits >> at & 1u) && col0 < D
                          ? __ldg(reinterpret_cast<const uint2*>(
                                p.v + ((pos0 + j) * p.KV + kv) * D + col0))
                          : make_uint2(0u, 0u);
        }
    };
    int acc[4][4] = {};
    auto pv = [&](const VTile& t, int grp) {
      if (live[grp] == 0) return;
      const int8_t* pg = pqs + grp * 32 + 4 * tig + gid * pq_stride;
      const uint32_t b0 = gid < G ? ld32(reinterpret_cast<const unsigned char*>(
                                        pg)) : 0u;
      const uint32_t b1 = gid < G ? ld32(reinterpret_cast<const unsigned char*>(
                                        pg + 16)) : 0u;
      uint32_t tr[2][2][4];   // [h][4-column slice][column]: 4 positions
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t lo[4] = {t.w[h][0].x, t.w[h][1].x, t.w[h][2].x,
                                t.w[h][3].x};
        const uint32_t hi[4] = {t.w[h][0].y, t.w[h][1].y, t.w[h][2].y,
                                t.w[h][3].y};
        transpose4(lo, tr[h][0]);
        transpose4(hi, tr[h][1]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {  // rows gid, gid + 8: columns 2m, 2m + 1
        const uint32_t a[4] = {tr[0][m / 2][2 * (m % 2)],
                               tr[0][m / 2][2 * (m % 2) + 1],
                               tr[1][m / 2][2 * (m % 2)],
                               tr[1][m / 2][2 * (m % 2) + 1]};
        mma_s8(acc[m], a, b0, b1);
      }
    };
    VTile vbuf[kVAhead];
#pragma unroll
    for (int u = 0; u < kVAhead; ++u) load_v(vbuf[u], gw + kGroupStride * u);
    for (int base = gw; base < groups; base += kGroupStride * kVAhead) {
#pragma unroll
      for (int u = 0; u < kVAhead; ++u) {
        const int grp = base + kGroupStride * u;
        if (grp < groups) pv(vbuf[u], grp);
        load_v(vbuf[u], grp + kGroupStride * kVAhead);
      }
    }
    __syncthreads();

    // ---- D. the cluster's sums, and the output ---------------------------
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // row gid (+8 for e >= 2) of mma m is column col0 + 2m (+1)
        const int d = col0 + 2 * m + (e >> 1), g = 2 * tig + (e & 1);
        if (g < G && d < D && acc[m][e] != 0)
          atomicAdd(&sums[g * D + d], acc[m][e]);
      }
    cluster.sync();
    if (rank == 0) {
      for (int i = tid; i < G * D; i += kThreads) {
        int total = 0;
        for (int r = 0; r < C; ++r)
          total += cluster.map_shared_rank(sums, r)[i];
        const size_t at = (size_t)bk * G * D + i;
        const float o = static_cast<float>(total) * stat[kPs * 8 + i / D];
        if (p.q_bf16)
          static_cast<__nv_bfloat16*>(p.out)[at] = __float2bfloat16(o);
        else
          static_cast<float*>(p.out)[at] = o;
      }
    }
    cluster.sync();   // no block leaves while rank 0 reads its sums
  }
}

// ---------------------------------------------------------------------------
// The split form's stages 0 and 3: persistent blocks over a ring
// ---------------------------------------------------------------------------
//
// Both walk work items of ring_tile(D) rows of D bytes, a contiguous
// run of items a block (the plan's grid: at most one block an item),
// an item a slot of a ring in shared memory, several in flight.
//   Stage 0's item is (b, head group, tile): the H = score_heads(KV)
// heads [H·grp, H·grp + H) of the P = ring_tile(D) / H positions
// [P·tile, P·tile + P), in the order ((b·groups + grp)·tiles + tile).
// Its rows are the records' contiguous spans of H·D bytes, copied by
// the bulk-copy engine (cp.async.bulk): one copy of the item's attended
// positions where H == KV (whole records), one a position otherwise;
// the masked positions are not read.  So the grid streams k in address
// order.  One producer warp issues the copies; eight consumer warps
// compute; each slot has a full mbarrier (the copies' bytes) and an
// empty one (the consumers' release), and no block barrier stands
// between items.  (Rows by cp.async, 16 bytes a thread, ran at 1.2
// TB/s: the threads stalled at issue, their copies waiting for the SM's
// own request slots; and with the copies issued between the items'
// computations, the consumers waited on the issuing warp: see
// experiments/decode_q8_ring_probe.py and PERF.md.)
//   Stage 3's item is (b, kv, a tile of ring_tile(D) positions), and
// the grid a multiple of KV: block i takes kv head i % KV and the
// i / KV-th of grid / KV contiguous runs of the B·tiles (b, tile)
// pairs, so a block's (b, kv) changes only where its run crosses a b,
// and the KV blocks of a run step through the same tiles together.
// Its loads are cp.async, one block barrier an item.

constexpr int kScoresRing = 6;  // stage 0: k items in the ring
constexpr int kPqAhead = 3;     // stage 3: v tiles in flight ahead of P·V

__host__ __device__ constexpr int ring_tile(int D) {
  return D > 64 ? 128 : 256;    // 8 units of 32 positions by 64 columns
}

// stage 0's heads an item: the largest power of 2 up to min(KV, 8), so
// that a warp's rows of an item are one head's
__host__ __device__ constexpr int score_heads(int KV) {
  return KV >= 8 ? 8 : KV >= 4 ? 4 : KV >= 2 ? 2 : 1;
}

// Stage 0's shared memory: kScoresRing slots of the item's k rows as
// the records hold them ([P][H][D]), a 4-byte word of k scales a row,
// the slot's len and its full and empty mbarriers; then each consumer
// warp's scores [8][its rows + 4] before they are stored as vectors.
// Stage 3's: kPqAhead + 2 slots of the fp32 pv [G][T] and the G ps; then
// kPqAhead + 1 slots of v rows (as k's) and pq [G][T + 16] in mma order;
// then the block's int32 sums [G][D].
struct RingLayout {
  size_t slot, ring, total;     // stage 0: the k ring; stage 3: pv's
  size_t ks, len, bar;          // stage 0: in a slot
  size_t vslot, vring, pq;      // stage 3: the v ring, pq in a v slot
};

__host__ __device__ inline RingLayout ring_layout(int stage, int G, int D) {
  RingLayout L{};
  const size_t T = ring_tile(D), row = D + 16;
  if (stage == 0) {
    L.ks = T * D;
    L.len = L.ks + 4 * T;
    L.bar = L.len + 8;          // full, then empty
    L.slot = L.bar + 24;
    L.ring = kScoresRing * L.slot;
    L.total = L.ring + (size_t)kWarps * kMaxG * (T / kWarps + 4) * 4;
    return L;
  }
  L.slot = 4 * G * T + 32;
  L.ring = (kPqAhead + 2) * L.slot;
  L.pq = T * row;
  L.vslot = L.pq + round16((size_t)G * (T + 16));
  L.vring = (kPqAhead + 1) * L.vslot;
  L.total = L.ring + L.vring + round16((size_t)4 * G * D);
  return L;
}

struct RingParams {
  const void* q;
  const int8_t* k;
  const int8_t* v;
  const unsigned char* k_scale;   // fp16 [B,Sl,KV], 4-byte aligned
  const long long* lens;
  float* scratch;                 // [B,KV,G,Sl] fp32
  const float* stat_in;           // stage 3: ps [B,KV,G]
  float* stat_out;                // stage 0: max s [B,KV,G], from -inf
  int* out;                       // stage 3: sums [B,KV,G,D], from 0
  int8_t* dbg_pq;                 // stage 3, may be null: pq [B,KV,G,Sl]
  int q_bf16, B, Sl, KV, G, window, start, smax;
  int vec;                        // Sl % 4 == 0: scratch rows 16-byte aligned
  float scale;
};

// `bytes` (a multiple of 16) from global to shared memory by the
// bulk-copy engine, counted on mbarrier `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(hopper::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Loads that stay in program order among the asm statements around
// them (the compiler may not sink them to their first use), so that
// they go out ahead of the copies issued after them
__device__ __forceinline__ uint4 ld_early(const uint4* at) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(at));
  return v;
}
__device__ __forceinline__ long long ld_early(const long long* at) {
  long long v;
  asm volatile("ld.global.nc.s64 %0, [%1];" : "=l"(v) : "l"(at));
  return v;
}

// the positions `attended` admits, [lo, hi): one interval for every mask
__device__ __forceinline__ void attended_span(long long len, int Smax,
                                              int window, long long& lo,
                                              long long& hi) {
  if (window > 0 && Smax == window) {
    lo = 0;
    hi = min(len, (long long)Smax);
  } else {
    lo = window > 0 ? len - window : 0;
    hi = len;
  }
}

// a float max across blocks: ordered as ints where the sign bit is 0,
// as unsigned (reversed) where it is 1; exact in any order
__device__ __forceinline__ void atomic_max_float(float* at, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(at), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(at), __float_as_uint(v));
}

struct Item {
  int b, kv, bk, tile;
};

// the first (b, tile) pair of the block's run, and its length
__device__ __forceinline__ int item_run(int B, int KV, int tiles,
                                        int& count) {
  const long long pairs = (long long)B * tiles, runs = gridDim.x / KV;
  const long long j = blockIdx.x / KV;
  const int lo = (int)(pairs * j / runs);
  count = (int)(pairs * (j + 1) / runs) - lo;
  return lo;
}

// stage 0: the first of the block's items, and their count
__device__ __forceinline__ int item_span(long long items, int& count) {
  const int lo = (int)(items * blockIdx.x / gridDim.x);
  count = (int)(items * (blockIdx.x + 1) / gridDim.x) - lo;
  return lo;
}

// stage 0's item `it`: its b, the group's first head (kv) and its tile
__device__ __forceinline__ Item score_item(int it, int groups, int tiles,
                                          int H) {
  Item x;
  x.tile = it % tiles;
  x.kv = it / tiles % groups * H;
  x.b = it / tiles / groups;
  x.bk = -1;
  return x;
}

// the block's n-th item, of the run from pair `lo`
__device__ __forceinline__ Item item_at(int lo, int n, int KV, int tiles) {
  Item x;
  x.kv = blockIdx.x % KV;
  x.tile = (lo + n) % tiles;
  x.b = (lo + n) / tiles;
  x.bk = x.b * KV + x.kv;
  return x;
}

// Stage 0: the scores of an item's k rows by mma.sync m16n8k32 s8
// against the G query rows of the rows' head, into the scratch as
// 16-byte vectors, and each row's max by a float atomic max into
// stat_out.  Warp kWarps is the producer (the ring's copies); consumer
// warp w takes 16·(T/128) positions of head w·H/8 of the item, one or
// two m-tiles; as in the one launch a lane reads the 16-byte chunks
// tig + 4i of its rows gid and gid + 8 (words 2s and 2s + 1 its A
// operand of k-step s) and the B operand is the same bytes of q, so the
// int32 sums are the one launch's.  A consumer keeps its head's query
// rows quantized in registers and its row maxima while its (b, kv)
// stays.
template <int D>
__global__ void __launch_bounds__(kThreads + 32, 2)
    q8_scores_kernel(RingParams p) {
  constexpr int kT = ring_tile(D), kChunks = D / 16;
  constexpr int kCh = (kChunks + 3) / 4;      // 16-byte chunks a lane, a row
  constexpr int kStepsK = 2 * kCh;            // k-steps of the mma
  constexpr int kWp = kT / kWarps;            // a warp's rows of an item
  constexpr int kSt = kWp + 4;                // its staged scores' stride
  extern __shared__ __align__(16) unsigned char smem[];
  const RingLayout L = ring_layout(0, p.G, D);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = p.G, KV = p.KV, Sl = p.Sl;
  const int H = score_heads(KV), P = kT / H;  // heads, positions an item
  const int hs = H == 8 ? 3 : H == 4 ? 2 : H == 2 ? 1 : 0;   // log2 H
  const int groups = (KV + H - 1) / H, tiles = (Sl + P - 1) / P;
  int count;
  const int lo = item_span((long long)p.B * groups * tiles, count);
  float* st = reinterpret_cast<float*>(smem + L.ring) + warp * kMaxG * kSt;
  // the warp's head in the group, and its first position in the item
  const int hw = warp * kWp / P, jw = warp * kWp - hw * P;
  auto bar = [&](int u) {
    return hopper::smem_addr(smem + u * L.slot + L.bar);
  };
  auto empty = [&](int u) { return bar(u) + 8; };
  const bool producer = warp == kWarps;
  if (tid == kThreads) {       // full: the producer's lane 0 (the bytes
    for (int u = 0; u < kScoresRing; ++u) {   // due) and its 32 lanes'
      hopper::mbar_init(bar(u), 1 + 32);      // cp.async; empty: the
      hopper::mbar_init(empty(u), kWarps);    // consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // The producer's len of b.  A read of device memory waits behind the
  // ring's copies, several microseconds at full rate, so the next b's
  // len is read one b ahead (ld_early: in program order, ahead of the
  // copies issued after it).
  int ib = -1;
  long long ilen = 0, nlen = 0;   // ib's len, and ib + 1's
  auto len_of = [&](int b) {
    if (b != ib) {
      ilen = ib >= 0 && b == ib + 1 ? nlen : ld_early(p.lens + b);
      ib = b;
      if (b + 1 < p.B) nlen = ld_early(p.lens + b + 1);
    }
    return ilen;
  };
  auto issue = [&](int n, int u) {
    const Item x = score_item(lo + n, groups, tiles, H);
    const int t0 = x.tile * P, nv = min(P, Sl - t0);
    // the item's attended positions [jlo, jhi), and its heads
    long long alo, ahi;
    attended_span(len_of(x.b), p.smax, p.window, alo, ahi);
    const long long g0 = (long long)p.start + t0;
    const int jlo = (int)max(0LL, min((long long)nv, alo - g0));
    const int jhi = (int)max((long long)jlo, min((long long)nv, ahi - g0));
    const int nh = min(H, KV - x.kv);
    unsigned char* slot = smem + u * L.slot;
    const size_t e0 = ((size_t)x.b * Sl + t0) * KV + x.kv;
    if (lane == 0)
      hopper::mbar_expect_tx(bar(u), (uint32_t)((jhi - jlo) * nh * D));
    __syncwarp();
    if (nh == KV) {           // whole records: one span
      if (lane == 0 && jhi > jlo)
        bulk_load(slot + jlo * H * D, p.k + (e0 + (size_t)jlo * KV) * D,
                  (uint32_t)((jhi - jlo) * KV * D), bar(u));
    } else {
      for (int j = jlo + lane; j < jhi; j += 32)
        bulk_load(slot + j * H * D, p.k + (e0 + (size_t)j * KV) * D,
                  (uint32_t)(nh * D), bar(u));
    }
    if (lane == 0)
      hopper::cp_async<8>(hopper::smem_addr(slot + L.len), p.lens + x.b);
    for (int r = lane; r < kT; r += 32) {   // row r's scale
      const int j = r >> hs, h = r & (H - 1);
      const bool on = j >= jlo && j < jhi && h < nh;
      const size_t e = on ? e0 + (size_t)j * KV + h : 0;
      hopper::cp_async<4>(hopper::smem_addr(slot + L.ks + 4 * r),
                          p.k_scale + 2 * (e & ~(size_t)1), on ? 4 : 0);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                     bar(u))
                 : "memory");
  };

  const float ninf = __int_as_float(0xff800000);
  int cur = -1;               // the (b, kv) of qb and mx
  uint32_t qb[kStepsK][2];    // its B operand, and its columns' scales
  float qs_e[2] = {0.f, 0.f};
  float mx[2] = {ninf, ninf};    // rows 2tig, 2tig + 1
  auto flush = [&]() {
    if (cur < 0) return;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], o));
      if (gid == 0 && 2 * tig + e < G && mx[e] != ninf)
        atomic_max_float(p.stat_out + (size_t)cur * G + 2 * tig + e, mx[e]);
      mx[e] = ninf;
    }
  };
  // q's row gid of (b, kv) `bk` as q holds it (fetch_q: this lane's
  // chunks tig + 4i, 32 bytes each in bf16, 64 in fp32), then quantized
  // as the one launch does (quant_q: word w of chunk i at qb[2i + w / 2]
  // [w % 2]).  Once the ring streams, a read of device memory waits
  // several microseconds behind its copies: so a consumer reads the q of
  // its next (b, kv) as soon as it has quantized the current one's.
  uint4 qraw[kCh][4];
  int qbk = -1;               // the (b, kv) that qraw holds
  auto fetch_q = [&](int bk) {
    qbk = bk;
    const size_t row = ((size_t)bk * G + gid) * D;
#pragma unroll
    for (int i = 0; i < kCh; ++i) {
      const int c = tig + 4 * i;
      const uint4* src =
          p.q_bf16 ? reinterpret_cast<const uint4*>(
                         static_cast<const __nv_bfloat16*>(p.q) + row + 16 * c)
                   : reinterpret_cast<const uint4*>(
                         static_cast<const float*>(p.q) + row + 16 * c);
#pragma unroll
      for (int h = 0; h < 4; ++h)
        qraw[i][h] = gid < G && c < kChunks && (h < 2 || !p.q_bf16)
                         ? ld_early(src + h)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // value e (0..15) of chunk i of qraw, read where it is needed
  auto qval = [&](int i, int e) {
    if (p.q_bf16) {
      const uint4& u = qraw[i][e / 8];
      const int c = (e % 8) / 2;
      const uint32_t w = c == 0 ? u.x : c == 1 ? u.y : c == 2 ? u.z : u.w;
      return __uint_as_float(e % 2 ? (w & 0xffff0000u) : (w << 16));
    }
    const uint4& v = qraw[i][e / 4];
    const int c = e % 4;
    return __uint_as_float(c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w);
  };
  auto quant_q = [&]() {
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kCh; ++i)
#pragma unroll
      for (int e = 0; e < 16; ++e) amax = fmaxf(amax, fabsf(qval(i, e)));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
    const float qs = fmaxf(amax / 127.f, 1e-8f);
#pragma unroll
    for (int i = 0; i < kCh; ++i)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t word = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          word |= (uint32_t)(uint8_t)quantize(qval(i, 4 * w + t), qs)
                  << (8 * t);
        qb[2 * i + w / 2][w % 2] = word;
      }
    const float qh = __half2float(__float2half_rn(qs));
    qs_e[0] = __shfl_sync(0xffffffffu, qh, 8 * tig);
    qs_e[1] = __shfl_sync(0xffffffffu, qh, 8 * tig + 4);
  };
  // the warp's (b, kv) after that of item x in the run, or -1
  auto next_bk = [&](const Item& x) {
    const int it = (x.b * groups + x.kv / H + 1) * tiles;
    if (it >= lo + count) return -1;
    const Item y = score_item(it, groups, tiles, H);
    return y.kv + hw < KV ? y.b * KV + y.kv + hw : -1;
  };

  auto compute = [&](int n, int u) {
    const Item x = score_item(lo + n, groups, tiles, H);
    const int kv = x.kv + hw, t0 = x.tile * P, nv = min(P, Sl - t0);
    if (kv >= KV || jw >= nv) return;          // warp-uniform
    const int bk = x.b * KV + kv;
    if (bk != cur) {
      flush();
      cur = bk;
      if (qbk != bk) fetch_q(bk);
      quant_q();
      const int nbk = next_bk(x);
      if (nbk >= 0) fetch_q(nbk);
    }
    const unsigned char* slot = smem + u * L.slot;
    const long long len = *reinterpret_cast<const long long*>(slot + L.len);
    const uint32_t* ksw = reinterpret_cast<const uint32_t*>(slot + L.ks);
    const size_t e0 = ((size_t)x.b * Sl + t0) * KV + kv;
#pragma unroll
    for (int mi = 0; mi < kWp / 16; ++mi) {
      const int j0 = jw + 16 * mi;
      if (j0 >= nv) break;
      int4 r[2][kCh];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int4* row = reinterpret_cast<const int4*>(
            slot + (size_t)((j0 + gid + 8 * h) * H + hw) * D);
#pragma unroll
        for (int i = 0; i < kCh; ++i)
          r[h][i] = tig + 4 * i < kChunks ? row[tig + 4 * i]
                                          : make_int4(0, 0, 0, 0);
      }
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int s = 0; s < kStepsK; ++s) {
        const uint32_t a[4] = {word(r[0][s / 2], 2 * (s % 2)),
                               word(r[1][s / 2], 2 * (s % 2)),
                               word(r[0][s / 2], 2 * (s % 2) + 1),
                               word(r[1][s / 2], 2 * (s % 2) + 1)};
        mma_s8(acc, a, qb[s][0], qb[s][1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + gid + 8 * h;
        if (j >= nv) continue;
        const bool att = attended(p.start + t0 + j, len, p.smax, p.window);
        const uint32_t w = ksw[j * H + hw];
        const float ks = __half2float(__ushort_as_half(
            (unsigned short)(((e0 + (size_t)j * KV) & 1) ? w >> 16 : w)));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s =
              att ? ((static_cast<float>(acc[2 * h + e]) * qs_e[e]) * ks) *
                        p.scale
                  : kNegInf;
          st[(2 * tig + e) * kSt + 16 * mi + gid + 8 * h] = s;
          if (2 * tig + e < G) mx[e] = fmaxf(mx[e], s);
        }
      }
    }
    __syncwarp();
    // the warp's positions of the item, a g row at a time, as 16-byte
    // vectors
    constexpr int kQuads = kWp / 4;
    for (int i = lane; i < G * kQuads; i += 32) {
      const int g = i / kQuads, jq = 4 * (i % kQuads), j = jw + jq;
      if (j >= nv) continue;
      float* dst = p.scratch + ((size_t)bk * G + g) * Sl + t0 + j;
      const float* src = st + g * kSt + jq;
      if (p.vec && j + 4 <= nv) {
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(src);
      } else {
        for (int y = 0; y < 4 && j + y < nv; ++y) dst[y] = src[y];
      }
    }
    __syncwarp();
  };

  if (!producer && count > 0) {  // q, ahead of the ring
    const Item x = score_item(lo, groups, tiles, H);
    if (x.kv + hw < KV) fetch_q(x.b * KV + x.kv + hw);
  }
  __syncthreads();
  if (producer) {
    for (int k = 0; k < count; ++k) {
      const int u = k % kScoresRing;
      if (k >= kScoresRing)
        hopper::mbar_wait(empty(u), (k / kScoresRing - 1) & 1);
      issue(k, u);
    }
    hopper::cp_async_wait<0>();
    return;
  }
  for (int k = 0; k < count; ++k) {
    const int u = k % kScoresRing;
    hopper::mbar_wait(bar(u), (k / kScoresRing) & 1);
    compute(k, u);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty(u));
  }
  flush();
}

// Stage 3: pq = clip(rint(pv / ps)) of a tile, computed by the threads
// that then ask for its v rows, kPqAhead tiles before their P·V: a
// thread (two a position at T 128) quantizes its position's G rows, and
// copies the position's v row only if some pq is not 0 (zeros
// otherwise, as the one launch skips it).  P·V as the one launch's:
// warp w takes the 32 positions 32·(w / halves) of the tile by the 64
// columns 64·(w % halves), its int32 sums in registers while the items
// keep their (b, kv); at a seam the warps add theirs in shared memory
// and the block adds the sums into `out` (red.global.add.s32: exact, in
// any order).  pv tiles arrive one ahead of their quantization.
template <int D>
__global__ void __launch_bounds__(kThreads, 2) q8_pq_kernel(RingParams p) {
  constexpr int kT = ring_tile(D), kRow = D + 16, kChunks = D / 16;
  constexpr int kHalves = (D + 63) / 64;
  constexpr int kTpp = kThreads / kT;         // threads a position
  constexpr int kPqStride = kT + 16;
  constexpr int kAhead = kPqAhead + 1;        // pv tiles ahead of P·V
  constexpr int kSRing = kPqAhead + 2, kVRing = kPqAhead + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const RingLayout L = ring_layout(3, p.G, D);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = p.G, KV = p.KV, Sl = p.Sl;
  const int tiles = (Sl + kT - 1) / kT;
  int count;
  const int lo = item_run(p.B, KV, tiles, count);
  int* sums = reinterpret_cast<int*>(smem + L.ring + L.vring);
  for (int i = tid; i < G * D; i += kThreads) sums[i] = 0;

  auto issue_pv = [&](int n, int u) {
    const Item x = item_at(lo, n, KV, tiles);
    const int bk = x.bk, t0 = x.tile * kT, nv = min(kT, Sl - t0);
    float* sc = reinterpret_cast<float*>(smem + u * L.slot);
    if (tid < G)
      hopper::cp_async<4>(hopper::smem_addr(sc + G * kT + tid),
                          p.stat_in + (size_t)bk * G + tid);
    const float* row = p.scratch + (size_t)bk * G * Sl + t0;
    if (p.vec) {
      for (int i = tid; i < G * (kT / 4); i += kThreads) {
        const int g = i / (kT / 4), j = 4 * (i % (kT / 4));
        const int in = max(0, min(4, nv - j));   // of the 4 positions
        hopper::cp_async<16>(hopper::smem_addr(sc + g * kT + j),
                             row + (size_t)g * Sl + (in ? j : 0), 4 * in);
      }
    } else {
      for (int i = tid; i < G * kT; i += kThreads) {
        const int g = i / kT, j = i % kT;
        hopper::cp_async<4>(hopper::smem_addr(sc + g * kT + j),
                            row + (size_t)g * Sl + (j < nv ? j : 0),
                            j < nv ? 4 : 0);
      }
    }
  };

  auto pq_and_v = [&](int n, int su, int vu) {
    const Item x = item_at(lo, n, KV, tiles);
    const int bk = x.bk, t0 = x.tile * kT, nv = min(kT, Sl - t0);
    const float* sc = reinterpret_cast<const float*>(smem + su * L.slot);
    unsigned char* vs = smem + L.ring + vu * L.vslot;
    int8_t* pqs = reinterpret_cast<int8_t*>(vs + L.pq);
    const int j = tid / kTpp, r = tid % kTpp;
    const int at = (j & ~31) + mma_order(j & 31);
    bool any = false;
    for (int g = 0; g < G; ++g) {
      int8_t v = 0;
      if (j < nv) {
        v = quantize(sc[g * kT + j], sc[G * kT + g]);
        if (p.dbg_pq != nullptr && r == 0)
          p.dbg_pq[((size_t)bk * G + g) * Sl + t0 + j] = v;
      }
      if (r == 0) pqs[g * kPqStride + at] = v;
      any |= v != 0;
    }
    const int8_t* src = p.v + (((size_t)x.b * Sl + t0 + (any ? j : 0)) * KV +
                               x.kv) * D;
#pragma unroll
    for (int c = r; c < kChunks; c += kTpp)
      hopper::cp_async<16>(hopper::smem_addr(vs + j * kRow + 16 * c),
                           src + 16 * c, any ? 16 : 0);
  };

  const int half = warp % kHalves, grp = warp / kHalves;
  const int col0 = 64 * half + 8 * gid;
  int acc[4][4] = {};
  int cur = -1;
  auto flush = [&]() {
    if (cur < 0) return;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // row gid (+8 for e >= 2) of mma m is column col0 + 2m (+1)
        const int d = col0 + 2 * m + (e >> 1), g = 2 * tig + (e & 1);
        if (g < G && d < D && acc[m][e] != 0)
          atomicAdd(&sums[g * D + d], acc[m][e]);
        acc[m][e] = 0;
      }
    __syncthreads();
    int* out = p.out + (size_t)cur * G * D;
    for (int i = tid; i < G * D; i += kThreads) {
      if (sums[i] != 0)
        asm volatile("red.global.add.s32 [%0], %1;\n" ::"l"(out + i),
                     "r"(sums[i]));
      sums[i] = 0;
    }
    __syncthreads();
  };

  auto pv = [&](int n, int vu) {
    const Item x = item_at(lo, n, KV, tiles);
    if (x.bk != cur) {
      flush();
      cur = x.bk;
    }
    if (32 * grp >= min(kT, Sl - x.tile * kT)) return;   // warp-uniform
    const unsigned char* vs = smem + L.ring + vu * L.vslot;
    const int8_t* pg = reinterpret_cast<const int8_t*>(vs + L.pq) +
                       grp * 32 + 4 * tig + gid * kPqStride;
    const uint32_t b0 = gid < G ? ld32(reinterpret_cast<const unsigned char*>(
                                      pg)) : 0u;
    const uint32_t b1 = gid < G ? ld32(reinterpret_cast<const unsigned char*>(
                                      pg + 16)) : 0u;
    if (__all_sync(0xffffffffu, (b0 | b1) == 0u)) return;   // pq all 0
    uint32_t tr[2][2][4];   // [h][4-column slice][column]: 4 positions
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint2 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = col0 < D ? *reinterpret_cast<const uint2*>(
                              vs + (32 * grp + 8 * i + 2 * tig + h) * kRow +
                              col0)
                        : make_uint2(0u, 0u);
      const uint32_t lo4[4] = {w[0].x, w[1].x, w[2].x, w[3].x};
      const uint32_t hi4[4] = {w[0].y, w[1].y, w[2].y, w[3].y};
      transpose4(lo4, tr[h][0]);
      transpose4(hi4, tr[h][1]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {  // rows gid, gid + 8: columns 2m, 2m + 1
      const uint32_t a[4] = {tr[0][m / 2][2 * (m % 2)],
                             tr[0][m / 2][2 * (m % 2) + 1],
                             tr[1][m / 2][2 * (m % 2)],
                             tr[1][m / 2][2 * (m % 2) + 1]};
      mma_s8(acc[m], a, b0, b1);
    }
  };

#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    if (u < count) issue_pv(u, u);
    hopper::cp_async_commit();
  }
  for (int k = 0; k < count + kPqAhead; ++k) {
    // pv of tile k and v of tile k - kPqAhead are in; the slots of the
    // tiles before them are free
    hopper::cp_async_wait<kPqAhead - 1>();
    __syncthreads();
    if (k + kAhead < count) issue_pv(k + kAhead, (k + kAhead) % kSRing);
    if (k < count) pq_and_v(k, k % kSRing, k % kVRing);
    hopper::cp_async_commit();
    if (k >= kPqAhead) pv(k - kPqAhead, (k - kPqAhead) % kVRing);
  }
  flush();
  hopper::cp_async_wait<0>();
}

// up to kMaxSmem of dynamic shared memory, and the carveout that gives
// shared memory all it can, so that two blocks of the plan fit an SM
template <int D, bool kOnChip, int kStage>
cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      q8_decode_kernel<D, kOnChip, kStage>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(q8_decode_kernel<D, kOnChip, kStage>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  done = e == cudaSuccess;
  return e;
}

// a grid of clusters of `cluster` blocks along x, one a (b, kv) along y
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int cluster, int pairs, int smem, cudaStream_t st) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(cluster, pairs);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <int D, bool kOnChip, int kStage>
cudaError_t launch(const Params& p, int B, int cluster, int smem,
                   cudaStream_t st) {
  cudaError_t e = configure<D, kOnChip, kStage>();
  if (e != cudaSuccess) return e;
  ClusterLaunch l(cluster, B * p.KV, smem, st);
  e = cudaLaunchKernelEx(&l.cfg, q8_decode_kernel<D, kOnChip, kStage>, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int D, bool kOnChip>
int active_clusters(int cluster, int pairs, int smem) {
  int n = -1;
  if (configure<D, kOnChip, kWhole>() != cudaSuccess) return -1;
  ClusterLaunch l(cluster, pairs, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(
             &n, q8_decode_kernel<D, kOnChip, kWhole>, &l.cfg) == cudaSuccess
             ? n
             : -1;
}

template <bool kOnChip, int kStage>
cudaError_t dispatch(const Params& p, int B, int D, int cluster, int smem,
                     cudaStream_t st) {
  switch (D) {
    case 32: return launch<32, kOnChip, kStage>(p, B, cluster, smem, st);
    case 80: return launch<80, kOnChip, kStage>(p, B, cluster, smem, st);
    case 96: return launch<96, kOnChip, kStage>(p, B, cluster, smem, st);
    case 128: return launch<128, kOnChip, kStage>(p, B, cluster, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kOnChip>
int occupancy(int D, int cluster, int pairs, int smem) {
  switch (D) {
    case 32: return active_clusters<32, kOnChip>(cluster, pairs, smem);
    case 80: return active_clusters<80, kOnChip>(cluster, pairs, smem);
    case 96: return active_clusters<96, kOnChip>(cluster, pairs, smem);
    case 128: return active_clusters<128, kOnChip>(cluster, pairs, smem);
    default: return -1;
  }
}

// one launch of a ring kernel: `grid` blocks, up to kMaxSmem of
// dynamic shared memory, the carveout that gives shared memory all it can
template <void (*kKernel)(RingParams)>
cudaError_t ring_configured(const RingParams& p, int grid, int smem,
                            cudaStream_t st, int threads = kThreads) {
  static bool done = false;
  if (!done) {
    cudaError_t e = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kKernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    done = true;
  }
  kKernel<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t ring_launch(bool scores, const RingParams& p, int grid, int smem,
                        cudaStream_t st) {
  return scores ? ring_configured<q8_scores_kernel<D>>(p, grid, smem, st,
                                                      kThreads + 32)
                : ring_configured<q8_pq_kernel<D>>(p, grid, smem, st);
}

// the checks both entries share: shapes, the plan's cluster and the
// shared bytes that must cover its layout
bool valid_plan(int B, int Smax, int KV, int G, int D, bool on_chip,
                int cluster, int block_positions, int smem_bytes) {
  return B > 0 && Smax > 0 && KV > 0 && G > 0 && G <= kMaxG &&
         (long long)B * KV <= 65535 && cluster >= 1 &&
         cluster <= kMaxCluster && block_positions >= 1 &&
         (long long)cluster * block_positions >= Smax &&
         (long long)(cluster - 1) * block_positions < Smax &&
         smem_bytes <= kMaxSmem &&
         layout(on_chip, block_positions, G, D).total <= (size_t)smem_bytes;
}

Params params(const void* q, int q_bf16, const void* k, const void* v,
              const void* k_scale, const void* v_scale, const void* lens,
              void* out, void* scratch, void* dbg_s, void* dbg_pq, int Smax,
              int KV, int G, int window, float scale, int block_positions) {
  Params p;
  p.q = q;
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const int8_t*>(v);
  p.k_scale = static_cast<const __half*>(k_scale);
  p.v_scale = static_cast<const __half*>(v_scale);
  p.lens = static_cast<const long long*>(lens);
  p.out = out;
  p.scratch = static_cast<float*>(scratch);
  p.dbg_s = static_cast<int*>(dbg_s);
  p.dbg_pq = static_cast<int8_t*>(dbg_pq);
  p.stat_in = nullptr;
  p.stat_out = nullptr;
  p.q_bf16 = q_bf16;
  p.Smax = Smax;
  p.KV = KV;
  p.G = G;
  p.window = window;
  p.n = block_positions;
  p.scale = scale;
  return p;
}

}  // namespace

// q: [B,1,KV*G,D] bf16 (q_bf16) or fp32, contiguous; k, v: int8
// [B,Smax,KV,D] contiguous and 16-byte aligned; k_scale, v_scale: fp16
// [B,Smax,KV]; lens: int64 [B]; out: [B,1,KV*G,D] in q's dtype.  The
// plan (ops.py `plan`): on_chip (the scores in shared memory; else
// `scratch` holds B*KV*G*Smax fp32 and must be given, and null
// otherwise), the cluster size, the positions a block and the dynamic
// shared bytes a block, which must cover the layout.  dbg_s (int32)
// and dbg_pq (int8), [B,KV,G,Smax], may be null: when given, they
// receive the int32 scores (0 where masked) and pq.  window <= 0:
// none.  One launch; returns its error, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int decode_attention_q8(
    const void* q, int q_bf16, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* lens, void* out,
    void* scratch, void* dbg_s, void* dbg_pq, int B, int Smax, int KV,
    int G, int D, int window, float scale, int on_chip, int cluster,
    int block_positions, int smem_bytes, void* stream) {
  if (!valid_plan(B, Smax, KV, G, D, on_chip != 0, cluster, block_positions,
                  smem_bytes) ||
      (on_chip != 0) != (scratch == nullptr))
    return cudaErrorInvalidValue;
  const Params p = params(q, q_bf16, k, v, k_scale, v_scale, lens, out,
                          scratch, dbg_s, dbg_pq, Smax, KV, G, window, scale,
                          block_positions);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_chip ? dispatch<true, kWhole>(p, B, D, cluster, smem_bytes, st)
                 : dispatch<false, kWhole>(p, B, D, cluster, smem_bytes, st);
}

// One stage of the split form over a block of Sl positions, [start,
// start + Sl) of a cache of `smax`: q, k, v, k_scale, v_scale and lens
// as above with Sl for Smax (q 16-byte aligned, k_scale 4); `scratch`
// B*KV*G*Sl fp32, the same buffer for the four stages of a block.
// Stage 0 (a ring kernel) writes the scores into the scratch and takes
// the max of each row into stat_out [B,KV,G] fp32, which must hold
// -inf.  Stages 1 and 2 (the cluster kernel's code between two
// exchanges) take the exchanged m (1) or l (2) from stat_in [B,KV,G]
// fp32 and write the cluster's sum of e (1) or max |pv| (2) to
// stat_out.  Stage 3 (a ring kernel) reads pv from the scratch and ps
// from stat_in and adds the P·V sums into `out` int32 [B,KV,G,D], which
// must hold 0, and with dbg_pq (may be null) writes pq [B,KV,G,Sl].
// The plan: stages 1 and 2 `cluster`, `block_positions` and the dynamic
// shared bytes as above (ops.py `plan(..., scratch=True)`); stages 0
// and 3 `grid` persistent blocks, at most one a work item (in stage 3 a
// multiple of KV), and the dynamic shared bytes, which must cover
// `ring_layout` (ops.py `stage_plan`).  A stage ignores the arguments it
// does not read.  One launch; returns its error, or
// cudaErrorInvalidValue.
extern "C" int decode_attention_q8_stage(
    int stage, const void* q, int q_bf16, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* lens,
    const void* stat_in, void* stat_out, void* out, void* scratch,
    void* dbg_pq, int B, int Sl, int KV, int G, int D, int start, int smax,
    int window, float scale, int cluster, int block_positions, int grid,
    int smem_bytes, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stage == 1 || stage == 2) {
    if (!valid_plan(B, Sl, KV, G, D, false, cluster, block_positions,
                    smem_bytes) ||
        scratch == nullptr || stat_in == nullptr || stat_out == nullptr ||
        lens == nullptr || v_scale == nullptr)
      return cudaErrorInvalidValue;
    Params p = params(nullptr, 0, nullptr, nullptr, nullptr, v_scale, lens,
                      nullptr, scratch, nullptr, nullptr, Sl, KV, G, 0, 0.f,
                      block_positions);
    p.stat_in = static_cast<const float*>(stat_in);
    p.stat_out = static_cast<float*>(stat_out);
    return stage == 1 ? dispatch<false, 1>(p, B, D, cluster, smem_bytes, st)
                      : dispatch<false, 2>(p, B, D, cluster, smem_bytes, st);
  }
  if (stage != 0 && stage != 3) return cudaErrorInvalidValue;
  const bool scores = stage == 0;
  // the items (stage 0: head groups by tiles of T / H positions; stage
  // 3: heads by tiles of T), and the blocks that may take them
  const int H = scores ? score_heads(KV) : 1, T = ring_tile(D) / H;
  const long long items =
      B > 0 && Sl > 0 && KV > 0
          ? (long long)B * ((KV + H - 1) / H) * ((Sl + T - 1) / T) : 0;
  const bool ok =
      B > 0 && Sl > 0 && KV > 0 && G > 0 && G <= kMaxG && start >= 0 &&
      (long long)start + Sl <= smax && grid > 0 && grid <= items &&
      (scores || (grid >= KV && grid % KV == 0)) &&
      items <= 0x7fffffff && smem_bytes <= kMaxSmem &&
      ring_layout(stage, G, D).total <= (size_t)smem_bytes &&
      scratch != nullptr && lens != nullptr &&
      (scores ? q != nullptr && k != nullptr && k_scale != nullptr &&
                    stat_out != nullptr &&
                    reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(k_scale) % 4 == 0
              : v != nullptr && stat_in != nullptr && out != nullptr &&
                    reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(scratch) % 16 == 0);
  if (!ok) return cudaErrorInvalidValue;
  RingParams p{};
  p.q = q;
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const int8_t*>(v);
  p.k_scale = static_cast<const unsigned char*>(k_scale);
  p.lens = static_cast<const long long*>(lens);
  p.scratch = static_cast<float*>(scratch);
  p.stat_in = static_cast<const float*>(stat_in);
  p.stat_out = static_cast<float*>(stat_out);
  p.out = static_cast<int*>(out);
  p.dbg_pq = static_cast<int8_t*>(dbg_pq);
  p.q_bf16 = q_bf16;
  p.B = B;
  p.Sl = Sl;
  p.KV = KV;
  p.G = G;
  p.window = window;
  p.start = start;
  p.smax = smax;
  p.vec = Sl % 4 == 0 && reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
  p.scale = scale;
  switch (D) {
    case 32: return ring_launch<32>(scores, p, grid, smem_bytes, st);
    case 80: return ring_launch<80>(scores, p, grid, smem_bytes, st);
    case 96: return ring_launch<96>(scores, p, grid, smem_bytes, st);
    case 128: return ring_launch<128>(scores, p, grid, smem_bytes, st);
    default: return cudaErrorInvalidValue;
  }
}

// Clusters of the plan's size that fit on the card at once
// (cudaOccupancyMaxActiveClusters), or -1 on an error.
extern "C" int decode_attention_q8_active_clusters(int D, int on_chip,
                                                   int cluster,
                                                   int smem_bytes, int B,
                                                   int KV) {
  return on_chip ? occupancy<true>(D, cluster, B * KV, smem_bytes)
                 : occupancy<false>(D, cluster, B * KV, smem_bytes);
}
