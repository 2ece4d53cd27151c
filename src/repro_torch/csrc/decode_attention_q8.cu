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
// The split form (`decode_attention_q8_stage`): a context-parallel
// decode holds each slot's positions in blocks, one a rank, of a cache
// of `smax` positions.  The row's max, its sum of exp(s - m) and its
// max |pv| are each reduced over every block, and the int32 P·V sums
// summed, between ranks (ops.py all-reduces them).  So the kernel runs
// as four launches, each the code between two of the cluster
// exchanges above (the `kStage` instances; -1 is the one launch):
//   stage 0  A and the row max: the scores into the scratch form's
//            buffer [B,KV,G,Sl], the cluster's max to `stat_out`;
//   stage 1  exp(s - m) in place with m from `stat_in`, the cluster's
//            sum to `stat_out`;
//   stage 2  pv = (e / l) * vs in place, the cluster's max |pv|;
//   stage 3  pq with ps from `stat_in`, P·V, and the cluster's int32
//            sums [B,KV,G,D] to `out`.
// Within a launch the cluster still reduces over its own blocks, in the
// same order, so one block a row gives the one launch's bits.  k is
// read once (stage 0) and v once (stage 3); the scores cross device
// memory three times more, as the scratch form's do.  Masks take the
// block's global positions (`start`) and the whole cache's `smax`.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  int start, smax;        // the block's first position, the whole cache's
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
  // a position as the masks see it: global in the split form
  const int g0 = kOne ? t0 : p.start + t0;
  const int mask_smax = kOne ? p.Smax : p.smax;

  if constexpr (kOne || kStage == 0) {
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
                        attended(g0 + j, len, mask_smax, p.window);
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
        t.vs[h] = kOne && mt < m_tiles && j < nv && tig == 0
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
        if (kOne && tig == 0) vss[j] = t.vs[h];   // stage 2 reads its own
        const bool att = attended(g0 + j, len, mask_smax, p.window);
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
      if constexpr (kOne)
        stat[kM * 8 + tid] = m;
      else if (rank == 0)
        p.stat_out[(size_t)bk * G + tid] = m;
    }
    if constexpr (!kOne) {
      cluster.sync();   // no block leaves while rank 0 reads its part
      return;
    }
    __syncthreads();
  } else {
    // the split form's later stages: the statistic of the exchange
    // before this one (m, l or ps), and in stage 2 the v scales
    if (tid < G)
      stat[(kStage == 1 ? kM : kStage == 2 ? kL : kPs) * 8 + tid] =
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

  if constexpr (kOne || kStage == 3) {
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
        if constexpr (!kOne) {     // stage 3: the int32 sums, exchanged next
          static_cast<int*>(p.out)[at] = total;
          continue;
        }
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
  p.start = 0;
  p.smax = Smax;
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

// One stage (0..3) of the split form over a block of Sl positions,
// [start, start + Sl) of a cache of `smax`: the caches, q and lens as
// above with Sl for Smax; `scratch` B*KV*G*Sl fp32, the same buffer for
// the four stages of a block (the plan's scratch form).  stat_in
// [B,KV,G] fp32: the exchanged m (stage 1), l (2) or ps (3); stat_out
// [B,KV,G] fp32: the cluster's max s (stage 0), sum of e (1) or max
// |pv| (2); `out` (stage 3) int32 [B,KV,G,D], the block's P·V sums.
// dbg_s (stage 0) and dbg_pq (stage 3) as above, [B,KV,G,Sl].  One
// launch; returns its error, or cudaErrorInvalidValue.
extern "C" int decode_attention_q8_stage(
    int stage, const void* q, int q_bf16, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* lens,
    const void* stat_in, void* stat_out, void* out, void* scratch,
    void* dbg_s, void* dbg_pq, int B, int Sl, int KV, int G, int D,
    int start, int smax, int window, float scale, int cluster,
    int block_positions, int smem_bytes, void* stream) {
  if (stage < 0 || stage > 3 || start < 0 || (long long)start + Sl > smax ||
      !valid_plan(B, Sl, KV, G, D, false, cluster, block_positions,
                  smem_bytes) ||
      scratch == nullptr || (stage > 0) != (stat_in != nullptr) ||
      (stage < 3) != (stat_out != nullptr) || (stage == 3) != (out != nullptr))
    return cudaErrorInvalidValue;
  Params p = params(q, q_bf16, k, v, k_scale, v_scale, lens, out, scratch,
                    dbg_s, dbg_pq, Sl, KV, G, window, scale,
                    block_positions);
  p.stat_in = static_cast<const float*>(stat_in);
  p.stat_out = static_cast<float*>(stat_out);
  p.start = start;
  p.smax = smax;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: return dispatch<false, 0>(p, B, D, cluster, smem_bytes, st);
    case 1: return dispatch<false, 1>(p, B, D, cluster, smem_bytes, st);
    case 2: return dispatch<false, 2>(p, B, D, cluster, smem_bytes, st);
    default: return dispatch<false, 3>(p, B, D, cluster, smem_bytes, st);
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
