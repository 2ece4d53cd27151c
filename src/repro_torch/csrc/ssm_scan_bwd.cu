// SSD (Mamba2) intra-chunk block, backward, for Hopper (sm_90a): fp32 in
// and out, every product on the tensor cores (wgmma) in 3xTF32; plain C
// interface for ctypes.
//
// Replaces JAX's autodiff of src/repro/models/ssm.py _ssd_head_group
// (:98), whose forward the Pallas TPU kernel ssd_intra_fwd
// (src/repro/kernels/ssm_scan/kernel.py:60) computes, and whose forward
// here is csrc/ssm_scan.cu.  Per (batch*chunk bc, head h), with cum [Q],
// xdt [Q, P], B, C [Q, N] (one group, shared by every head) and the
// output gradients dy [Q, P], dS [N, P]:
//
//   L  = tril(exp(cum_q - cum_k)),  G = C B^T,  M = G o L,
//   e_k = exp(cum_{Q-1} - cum_k)                     (dec_end)
//   dM = dy xdt^T                                    (on the mask)
//   dxdt = M^T dy + e o (B dS)
//   dCB = sum_h dM o L,  dC = dCB B,  dB = dCB^T C + sum_h e o (xdt dS^T)
//   dcum = rowsum(dM o M) - colsum(dM o M) - w,  w_k = e_k sum_p
//          xdt_kp (B dS)_kp,  and sum_k w_k added at Q-1.
//
// The diagonal of dM o M is left out of both sums, where it cancels.
// Masking comes BEFORE exp, as in the forward: above the diagonal the
// exponent can overflow, and inf * 0 would give NaN.
//
// Three launches, no float atomics; every sum across heads, tiles or
// blocks is taken in a fixed order, so every run gives the same bits:
//
//   1. ssd_bwd_cb_kernel: a block per (bc, 64x64 tile pair qt >= kt)
//      forms G = C B^T once per chunk into a scratch tile;
//   2. ssd_bwd_keys_kernel: a block (one warpgroup) per (64-key tile kt,
//      bc, group of up to 12 heads), the key tiles of most query tiles
//      first (kt = 0 walks every query tile, the last key tile one).  Per
//      head it writes xdt's planes once, forms (B dS)^T and xdt dS^T (the
//      dS terms; the first, times e, starts dxdt^T's accumulator, the
//      second, times e, adds into the group's dB2 tile in scratch) and
//      w; then it walks the query tiles qt >= kt: dM = dy xdt^T once per
//      (tile pair, head), M, dM o L and dM o M from it (rowsum to a
//      scratch row, colsum in registers), M into planes, and dxdt^T +=
//      dy^T M.  dM o L adds into the group's dCB tile in scratch, heads
//      in order.  At the end of a head it writes dxdt and dcum = -colsum
//      - w, and sum_k w_k by 32 keys;
//   3. ssd_bwd_fold_kernel: a block per (bc, 64-row tile j, role) folds
//      the groups' dCB (and dB2) tiles in group order, then forms dC =
//      dCB B for the queries of tile j, or dB = dCB^T C + dB2 for its
//      keys, once per chunk; more blocks add the rowsums to dcum and, at
//      Q-1, sum_k w_k, in key-tile order.
//
// Products: wgmma m64n64k8 tf32, fp32 accumulators, A from registers
// (split into hi and lo there), B from K-major planes in shared memory
// in the 128-byte swizzle, each product as lo*hi' + hi*lo' + hi*hi'
// (3xTF32, the forward's helpers in tf32x3.cuh).  tf32 wgmma reads B
// K-major only, so the orientation of each product is chosen to keep
// its B operand a row-major tile or a register tile written once:
//
//   dM [q, k]       A dy (rows q, K p)    B xdt, planes [k][p]  once a head
//   dxdt^T [p, k]   A dy^T (rows p, K q)  B M, planes [k][q]    each step
//   (B dS)^T [p, k] A dS^T (rows p, K n)  B B, planes [k][n]    once a head
//   dB2^T [n, k]    A dS (rows n, K p)    B xdt, planes [k][p]
//   G [q, k]        A C (rows q, K n)     B B, planes [k][n]
//   dC^T [n, q]     A B^T (rows n, K k)   B dCB, planes [q][k]
//   dB^T [n, k]     A C^T (rows n, K q)   B dCB^T, planes [k][q]
//
// The A operands of dM and dy^T M both come from one raw dy tile in
// shared memory (a 2-slot cp.async ring: the next step's tile loads
// while this step's products run), whose 16-byte chunks are XOR-
// swizzled by row (q & 3, q >> 2 & 1) so that both read patterns hit
// 32 distinct banks.  M's transposed store into its planes is conflict
// free as well.  G and the dCB partials travel in "fragment order"
// (each thread's 32 accumulator values in 8 float4s, so a warp reads
// 512 contiguous bytes), from L2 at the train shape.
//
// Work and scratch at zamba2's train shape [1,16,256,112,64,64]: the
// function must do 22.8 GFLOP of products and move 390 MB; this kernel
// executes 26.6 GFLOP of products (1.16x: the diagonal tile pairs are
// multiplied whole; G once a chunk 0.084, the keys pass 26.3, the fold
// 0.168).  Its scratch is 46.7 MB, each byte written once and read
// once: G 2.6 MB [bc, pair], dCB 26.2 MB and dB2 10.5 MB per (bc, group
// of 12 heads), the rowsums 7.3 MB [bc, kt, q, h], sum_k w_k 57 KB.
// (The dCB tiles are also read and written once per head in the keys
// pass, through L2.)  No [bc, h, Q, N] partial is left.  At 3xTF32
// (495/3 TFLOP/s) the products take 0.138 ms against 0.116 ms of bytes,
// so the bound is operations.
//
// What holds it back (experiments/ssd_bwd_phases.py on the H100): a 64
// x 64 x 64 product in 3xTF32 (24 wgmma m64n64k8, A from registers)
// takes ~3.6k SM clocks of a warpgroup, about 4x the tensor cores' time
// for it (the forward, ssm_scan.cu, runs its products at about the same
// rate), and a head's start (its dS terms) costs ~1.5 walk steps.  Two
// accumulation chains per product, splitting all of a product's A
// fragments before its first wgmma, and a launch of its own for the dS
// terms did not make it faster.  Groups of 12 heads: 16 left the heavy
// key tiles' blocks too long, 8 doubled the fold's reads.
//
// Q is any value from 1 to 256; N and P multiples of 4 up to 128.  Rows
// past Q and columns past N or P are zeros in every plane and A
// fragment, so k-steps past the data multiply zeros.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kTile = 64;          // query rows and keys per tile
constexpr int kThreads = 128;      // one warpgroup
constexpr int kMaxQ = 256;
constexpr int kMaxDim = 128;       // largest N and P
constexpr int kFrag = kThreads * 32;  // a 64 x 64 tile in fragment order
constexpr int kHeadsMax = 12;      // heads a group at most
constexpr int kSlots = 264;        // keys blocks resident on an H100 (2 a SM)
constexpr int kSmemMax = 232448;

struct Args {
  const float* cum;  // [BC, Q, H]
  const float* xdt;  // [BC, Q, H, P]
  const float* b;    // [BC, Q, N]
  const float* c;    // [BC, Q, N]
  const float* dy;   // [BC, Q, H, P]
  const float* ds;   // [BC, H, N, P]
  float* dcum;       // [BC, Q, H]
  float* dxdt;       // [BC, Q, H, P]
  float* db;         // [BC, Q, N]
  float* dc;         // [BC, Q, N]
  float* g;          // [BC, pairs, kFrag]            C B^T tiles
  float* dcbp;       // [BC, groups, pairs, kFrag]    sum_h dM o L
  float* db2p;       // [BC, groups, nq, NN, kFrag]   sum_h e o xdt dS^T
  float* rowp;       // [BC, nq, Q, H]                rowsums by key tile
  float* wsum;       // [BC, nq, H, 2]                sum_k w_k by 32 keys
  int BC, Q, H, N, P, nq, groups, hg;
};

// The scratch, in floats from its start, and the head groups: about
// kSlots keys blocks at least, and at most kHeadsMax heads a group
struct Layout {
  size_t g, dcbp, db2p, rowp, wsum, total;
  int nq, groups, hg;
};

Layout layout(int BC, int Q, int H, int N) {
  Layout l{};
  l.nq = (Q + kTile - 1) / kTile;
  const long long per = (long long)l.nq * BC * H / kSlots;
  int hg = per < 1 ? 1 : per > kHeadsMax ? kHeadsMax : (int)per;
  if (hg > H) hg = H;
  const int g1 = (H + hg - 1) / hg;
  l.hg = (H + g1 - 1) / g1;               // balanced
  l.groups = (H + l.hg - 1) / l.hg;       // none empty
  const size_t pairs = (size_t)l.nq * (l.nq + 1) / 2;
  const size_t nn = (N + 63) / 64;
  l.g = 0;
  l.dcbp = l.g + (size_t)BC * pairs * kFrag;
  l.db2p = l.dcbp + (size_t)BC * l.groups * pairs * kFrag;
  l.rowp = l.db2p + (size_t)BC * l.groups * l.nq * nn * kFrag;
  l.wsum = l.rowp + (size_t)BC * l.nq * Q * H;
  l.total = l.wsum + (size_t)BC * l.nq * H * 2;
  return l;
}

__device__ __forceinline__ int pair_of(int qt, int kt) {
  return qt * (qt + 1) / 2 + kt;
}

// byte offset of element (row r, K position k) in a plane of 64 rows
__device__ __forceinline__ uint32_t poff(int r, int k) {
  return (k >> 5) * kBox + swz(r, (k & 31) >> 2) + (k & 3) * 4;
}

// this thread's 32 accumulator values of a tile in fragment order:
// float4 j at (j * kThreads + tid) * 4
__device__ __forceinline__ void frag_load(float (&d)[32], const float* src) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(
        src + (j * kThreads + threadIdx.x) * 4);
    d[4 * j] = v.x;
    d[4 * j + 1] = v.y;
    d[4 * j + 2] = v.z;
    d[4 * j + 3] = v.w;
  }
}
__device__ __forceinline__ void frag_add(float (&d)[32], const float* src) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(
        src + (j * kThreads + threadIdx.x) * 4);
    d[4 * j] += v.x;
    d[4 * j + 1] += v.y;
    d[4 * j + 2] += v.z;
    d[4 * j + 3] += v.w;
  }
}
__device__ __forceinline__ void frag_store(const float (&d)[32], float* dst) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<float4*>(dst + (j * kThreads + threadIdx.x) * 4) =
        make_float4(d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3]);
}
// d = the sum of `n` fragment-order tiles `stride` floats apart, added
// in order, four tiles' loads in flight at a time
__device__ __forceinline__ void frag_fold(float (&d)[32], const float* src,
                                          size_t stride, int n) {
  frag_load(d, src);
  int i = 1;
  for (; i + 3 < n; i += 4) {
    float u[4][32];
#pragma unroll
    for (int k = 0; k < 4; ++k) frag_load(u[k], src + (i + k) * stride);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < 32; ++e) d[e] += u[k][e];
  }
  for (; i < n; ++i) frag_add(d, src + i * stride);
}

// d += old, or d as it is where `skip` (no branch)
__device__ __forceinline__ void add_unless(float (&d)[32],
                                           const float (&old)[32],
                                           bool skip) {
#pragma unroll
  for (int e = 0; e < 32; ++e) d[e] += skip ? 0.f : old[e];
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// rows [0, 64) of a row-major block at src (row stride `stride` floats)
// into a hi and a lo plane: K positions [0, 64 KH) from src columns
// [c0, c0 + 64 KH); zeros past row `rows` and past column `cols`
template <int KH>
__device__ __forceinline__ void rows_to_planes(unsigned char* hi,
                                               unsigned char* lo,
                                               const float* src,
                                               size_t stride, int rows,
                                               int c0, int cols) {
  constexpr int cpr = 16 * KH;             // 16-byte chunks a row
  constexpr int per = kTile * cpr / kThreads;  // chunks a thread
  float4 v[per];                             // every load in flight first
#pragma unroll
  for (int u = 0; u < per; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = i / cpr, c = c0 + 4 * (i % cpr);
    v[u] = r < rows && c < cols
               ? __ldg(reinterpret_cast<const float4*>(src + r * stride + c))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int u = 0; u < per; ++u) {
    const int i = threadIdx.x + u * kThreads;
    uint4 h, l;
    split(v[u].x, h.x, l.x);
    split(v[u].y, h.y, l.y);
    split(v[u].z, h.z, l.z);
    split(v[u].w, h.w, l.w);
    const uint32_t off = poff(i / cpr, 4 * (i % cpr));
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// an accumulator tile (rows r, columns c) into planes of rows c, K r
// (M, dCB^T); a warp's stores hit 32 distinct banks
__device__ __forceinline__ void acc_to_planes_t(const float (&d)[32],
                                                unsigned char* hi,
                                                unsigned char* lo) {
  const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t h, l;
      split(d[4 * i + e], h, l);
      const uint32_t off =
          poff(8 * i + 2 * t + (e & 1), 16 * warp + g + 8 * (e >> 1));
      *reinterpret_cast<uint32_t*>(hi + off) = h;
      *reinterpret_cast<uint32_t*>(lo + off) = l;
    }
}

// an accumulator tile (rows r, columns c) into planes of rows r, K c
// (dCB)
__device__ __forceinline__ void acc_to_planes(const float (&d)[32],
                                              unsigned char* hi,
                                              unsigned char* lo) {
  const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      uint2 h, l;
      split(d[4 * i + e], h.x, l.x);
      split(d[4 * i + e + 1], h.y, l.y);
      const uint32_t off = poff(16 * warp + g + 4 * e, 8 * i + 2 * t);
      *reinterpret_cast<uint2*>(hi + off) = h;
      *reinterpret_cast<uint2*>(lo + off) = l;
    }
}

// v = A[r][k], A[r + 8][k], A[r][k + 4], A[r + 8][k + 4] (wgmma's A
// fragment) with A[r][k] = src[r * rs + k * ks], zero past rows `rv` or
// K `kv`
__device__ __forceinline__ void gfrag(float (&v)[4], const float* src,
                                      size_t rs, size_t ks, int r, int k,
                                      int rv, int kv) {
  v[0] = r < rv && k < kv ? __ldg(src + r * rs + k * ks) : 0.f;
  v[1] = r + 8 < rv && k < kv ? __ldg(src + (r + 8) * rs + k * ks) : 0.f;
  v[2] = r < rv && k + 4 < kv ? __ldg(src + r * rs + (k + 4) * ks) : 0.f;
  v[3] = r + 8 < rv && k + 4 < kv ? __ldg(src + (r + 8) * rs + (k + 4) * ks)
                                  : 0.f;
}

// d (+)= A B over K = 32 KB (KB boxes of 4 k-steps) in 3xTF32: A's
// fragment of k-step kk from frag(kk, v), B K-major in the planes at
// shared addresses b_hi and b_lo; `accumulate` 0 starts d at zero.  In
// batches of 4 k-steps (12 wgmmas): each batch's A fragments are split
// while the batch before runs; tail() runs while the last batch does
// (it must not touch d).
template <int KB, class Frag, class Tail>
__device__ __forceinline__ void mma(float (&d)[32], uint32_t b_hi,
                                    uint32_t b_lo, int accumulate, Frag frag,
                                    Tail tail) {
  uint32_t ah[2][4][4], al[2][4][4];
#pragma unroll
  for (int b = 0; b < KB; ++b) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float v[4];
      frag(4 * b + s, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(v[e], ah[b & 1][s][e], al[b & 1][s][e]);
    }
    if (b == 0) pin(d);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma3(d, ah[b & 1][s], al[b & 1][s], b_hi + kstep(4 * b + s),
             b_lo + kstep(4 * b + s), b == 0 && s == 0 ? accumulate : 1);
    BATCH_ISSUED(b, ah, al);
  }
  tail();
  BATCH_DRAIN(ah, al);
  pin(d);
}
template <int KB, class Frag>
__device__ __forceinline__ void mma(float (&d)[32], uint32_t b_hi,
                                    uint32_t b_lo, int accumulate,
                                    Frag frag) {
  mma<KB>(d, b_hi, b_lo, accumulate, frag, [] {});
}

// column sums over a warpgroup's rows: part[2 i + e] is this thread's
// sum at column 8 i + 2 t + e; red[64 warp + column] gets its warp's
__device__ __forceinline__ void col_reduce(float (&part)[16], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      part[j] += __shfl_xor_sync(0xffffffffu, part[j], off);
  if (lane < 4)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      red[64 * warp + 8 * (j >> 1) + 2 * lane + (j & 1)] = part[j];
}

// The raw dy tile: row q, 64 NP floats, 16-byte chunk c stored at chunk
// c ^ dsw(q).  dM reads rows 16 w + g, columns t (+4): chunks differ by
// g; dy^T M reads rows t (+4), columns 16 w + g: chunks differ by t and
// g >> 2; both cover 32 banks.
__device__ __forceinline__ int dsw(int q) {
  return ((q & 3) << 1) | ((q >> 2) & 1);
}
template <int NP>
__device__ __forceinline__ float dyv(const float* tile, int q, int p) {
  return tile[q * 64 * NP + (((p >> 2) ^ dsw(q)) << 2) + (p & 3)];
}

// dy rows [64 qt, +64) of head h into a ring slot (zeros past Q and P)
template <int NP>
__device__ __forceinline__ void issue_dy(float* dst, const Args& a, int bc,
                                         int h, int qt) {
  constexpr int cpr = 16 * NP;
  const int rows = a.Q - qt * kTile;
  const float* src =
      a.dy + (((size_t)bc * a.Q + qt * kTile) * a.H + h) * a.P;
  const size_t stride = (size_t)a.H * a.P;
  for (int i = threadIdx.x; i < kTile * cpr; i += kThreads) {
    const int r = i / cpr, ch = i % cpr;
    const bool ok = r < rows && 4 * ch < a.P;
    hopper::cp_async<16>(smem_addr(dst + r * 64 * NP + ((ch ^ dsw(r)) << 2)),
                         ok ? src + r * stride + 4 * ch : a.dy, ok ? 16 : 0);
  }
}

// shared memory of the keys kernel: xdt's planes (hi, lo), the M planes
// (hi, lo; B's planes during a head's dS terms), the dy ring, cum and
// dec_end of the keys, and the four warps' rows of column sums and of w
template <int NP>
constexpr size_t keys_smem() {
  return 1024 + 4 * NP * kBox + 4 * kBox +
         sizeof(float) * (2 * kTile * 64 * NP + 2 * kTile + 8 * kTile);
}

// pass 1: G = C B^T for tile pair (qt, kt) of chunk bc
template <int NN>
__global__ void __launch_bounds__(kThreads) ssd_bwd_cb_kernel(const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* p = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_addr(p);
  const int Q = a.Q, N = a.N, nq = a.nq, npairs = nq * (nq + 1) / 2;
  const int bc = blockIdx.x / npairs, pr = blockIdx.x % npairs;
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= pr) ++qt;
  const int kt = pr - qt * (qt + 1) / 2;
  const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  constexpr int PB = 2 * NN * kBox;  // bytes of a plane
  rows_to_planes<NN>(p, p + PB, a.b + ((size_t)bc * Q + kt * kTile) * N, N,
                     Q - kt * kTile, 0, N);
  fence_async();
  __syncthreads();
  const float* cq = a.c + ((size_t)bc * Q + qt * kTile) * N;
  const int qv = Q - qt * kTile;
  float acc[32];
  mma<2 * NN>(acc, base, base + PB, 0, [&](int kk, float(&v)[4]) {
    gfrag(v, cq, N, 1, 16 * warp + g, 8 * kk + t, qv, N);
  });
  frag_store(acc, a.g + ((size_t)bc * npairs + pr) * kFrag);
}

// pass 2: a block per (key tile, bc, head group); NP, NN: 64-column
// passes of P and of N
template <int NP, int NN>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_keys_kernel(const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* p = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_addr(p);
  constexpr int XB = 2 * NP * kBox, MB = 2 * kBox;  // bytes of a plane
  constexpr int RING = kTile * 64 * NP;             // floats of a slot
  unsigned char* xh = p;
  unsigned char* mh = p + 2 * XB;
  float* ring = reinterpret_cast<float*>(p + 2 * XB + 2 * MB);
  float* cumk = ring + 2 * RING;
  float* dec = cumk + kTile;
  float* red = dec + kTile;   // [4][64] column sums by warp
  float* redw = red + 4 * kTile;  // [4][64] w by warp
  const uint32_t xh_a = base, xl_a = base + XB;
  const uint32_t mh_a = base + 2 * XB, ml_a = mh_a + MB;

  const int Q = a.Q, H = a.H, N = a.N, P = a.P, nq = a.nq;
  const int per = a.BC * a.groups;
  const int kt = blockIdx.x / per;
  const int bc = blockIdx.x % per / a.groups, grp = blockIdx.x % a.groups;
  const int h0 = grp * a.hg, h1 = min(H, h0 + a.hg);
  const int tid = threadIdx.x, warp = tid / 32, g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int k0 = kt * kTile, kv = min(kTile, Q - k0);
  const size_t hp = (size_t)H * P;
  const int npairs = nq * (nq + 1) / 2;
  float* dcb = a.dcbp + ((size_t)bc * a.groups + grp) * npairs * kFrag;
  float* db2 = a.db2p + (((size_t)bc * a.groups + grp) * nq + kt) * NN * kFrag;
  const float* gt = a.g + (size_t)bc * npairs * kFrag;

  issue_dy<NP>(ring, a, bc, h0, kt);
  hopper::cp_async_commit();
  int step = 0;
  for (int h = h0; h < h1; ++h) {
    const bool first = h == h0;
    __syncthreads();  // the last head's planes, w and column sums are free
    if (tid < kTile) {
      const int k = k0 + tid;
      const float last = __ldg(a.cum + ((size_t)bc * Q + Q - 1) * H + h);
      const float ck = k < Q ? __ldg(a.cum + ((size_t)bc * Q + k) * H + h)
                             : 0.f;
      cumk[tid] = ck;
      dec[tid] = k < Q ? expf(last - ck) : 0.f;
    }
    const float* dsh = a.ds + ((size_t)bc * H + h) * N * P;
    // the A fragments of (B dS)^T's first product, loaded beside the
    // planes' tiles
    float pre[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      gfrag(pre[kk], dsh, 1, P, 16 * warp + g, 8 * kk + t, P, N);
    rows_to_planes<NP>(xh, xh + XB,
                       a.xdt + (((size_t)bc * Q + k0) * H + h) * P, hp, kv,
                       0, P);

    // (B dS)^T: rows p, columns k; B's planes in the M buffer, 64
    // columns of N a pass.  The A fragments of dB2's first product load
    // while the last product runs.
    float dx[NP][32];
    float pre2[8 * NP][4];
#pragma unroll
    for (int pass = 0; pass < NN; ++pass) {
      if (pass) __syncthreads();  // the pass before is done with them
      rows_to_planes<1>(mh, mh + MB, a.b + ((size_t)bc * Q + k0) * N, N, kv,
                        64 * pass, N);
      fence_async();
      __syncthreads();
#pragma unroll
      for (int pm = 0; pm < NP; ++pm)
        mma<2>(
            dx[pm], mh_a, ml_a, pass,
            [&](int kk, float(&v)[4]) {
              if (pass == 0 && pm == 0) {
#pragma unroll
                for (int e = 0; e < 4; ++e) v[e] = pre[kk][e];
              } else {
                gfrag(v, dsh, 1, P, 64 * pm + 16 * warp + g,
                      64 * pass + 8 * kk + t, P, N);
              }
            },
            [&] {
              if (pass == NN - 1 && pm == NP - 1)
#pragma unroll
                for (int kk = 0; kk < 8 * NP; ++kk)
                  gfrag(pre2[kk], dsh, P, 1, 16 * warp + g, 8 * kk + t, N,
                        P);
            });
    }

    // w_k = e_k sum_p xdt_kp (B dS)_kp, by warp; dxdt^T starts as
    // e o (B dS)^T
    {
      float part[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) part[j] = 0.f;
#pragma unroll
      for (int pm = 0; pm < NP; ++pm)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t off = poff(8 * i + 2 * t + (e & 1),
                                      64 * pm + 16 * warp + g + 8 * (e >> 1));
            const float x =
                __uint_as_float(*reinterpret_cast<const uint32_t*>(xh + off)) +
                __uint_as_float(
                    *reinterpret_cast<const uint32_t*>(xh + XB + off));
            part[2 * i + (e & 1)] += x * dx[pm][4 * i + e];
          }
#pragma unroll
      for (int j = 0; j < 16; ++j)
        part[j] *= dec[8 * (j >> 1) + 2 * t + (j & 1)];
      col_reduce(part, redw);  // summed over the warps at the head's end
    }
#pragma unroll
    for (int pm = 0; pm < NP; ++pm)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dx[pm][4 * i + e] *= dec[8 * i + 2 * t + (e & 1)];

    // dB2^T += e o (xdt dS^T)^T: rows n, columns k
#pragma unroll
    for (int nm = 0; nm < NN; ++nm) {
      float tmp[32], old[32];  // the group's tile so far loads meanwhile
      frag_load(old, db2 + nm * kFrag);
      mma<2 * NP>(tmp, xh_a, xl_a, 0, [&](int kk, float(&v)[4]) {
        if (nm == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = pre2[kk][e];
        } else {
          gfrag(v, dsh, P, 1, 64 * nm + 16 * warp + g, 8 * kk + t, N, P);
        }
      });
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tmp[4 * i + e] *= dec[8 * i + 2 * t + (e & 1)];
      add_unless(tmp, old, first);
      frag_store(tmp, db2 + nm * kFrag);
    }

    // the walk over the query tiles at or below the keys' diagonal
    float cs[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) cs[j] = 0.f;
    for (int qt = kt; qt < nq; ++qt, ++step) {
      const float* dyt = ring + (step & 1) * RING;
      hopper::cp_async_wait<0>();
      __syncthreads();  // this tile landed; the step before is done
      {
        int nh = h, nqt = qt + 1;
        if (nqt == nq) {
          nh = h + 1;
          nqt = kt;
        }
        if (nh < h1)
          issue_dy<NP>(ring + ((step + 1) & 1) * RING, a, bc, nh, nqt);
        hopper::cp_async_commit();
      }
      if (qt == kt && h + 1 < h1) {  // the next head's xdt and dS into L2
        const int lines = (P + 31) / 32;  // 128-byte lines a row
        const float* x = a.xdt + (((size_t)bc * Q + k0) * H + h + 1) * P;
        for (int i = tid; i < kv * lines; i += kThreads)
          prefetch_l2(x + (i / lines) * hp + 32 * (i % lines));
        for (int i = 32 * tid; i < N * P; i += 32 * kThreads)
          prefetch_l2(dsh + (size_t)N * P + i);
      }
      const int qa = qt * kTile + 16 * warp + g, qb = qa + 8;
      const float cqa =
          qa < Q ? __ldg(a.cum + ((size_t)bc * Q + qa) * H + h) : 0.f;
      const float cqb =
          qb < Q ? __ldg(a.cum + ((size_t)bc * Q + qb) * H + h) : 0.f;
      const int pr = pair_of(qt, kt);
      float gm[32];
      frag_load(gm, gt + (size_t)pr * kFrag);

      // dM = dy xdt^T: rows q, columns k
      float dm[32];
      mma<2 * NP>(dm, xh_a, xl_a, 0, [&](int kk, float(&v)[4]) {
        const int r = 16 * warp + g, c = 8 * kk + t;
        v[0] = dyv<NP>(dyt, r, c);
        v[1] = dyv<NP>(dyt, r + 8, c);
        v[2] = dyv<NP>(dyt, r, c + 4);
        v[3] = dyv<NP>(dyt, r + 8, c + 4);
      });
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qg = e >> 1 ? qb : qa, c = 8 * i + 2 * t + (e & 1);
          const int kg = k0 + c;
          // mask first: exp's value only where k <= q < Q
          const float l = kg <= qg && qg < Q
                              ? __expf((e >> 1 ? cqb : cqa) - cumk[c]) : 0.f;
          const float m = gm[4 * i + e] * l, d = dm[4 * i + e];
          const float dmm = kg < qg ? d * m : 0.f;
          rs[e >> 1] += dmm;
          cs[2 * i + (e & 1)] += dmm;
          gm[4 * i + e] = m;
          dm[4 * i + e] = d * l;
        }
      acc_to_planes_t(gm, mh, mh + MB);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 1);
        rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 2);
      }
      if (t == 0) {
        float* row = a.rowp + ((size_t)bc * nq + kt) * Q * H + h;
        if (qa < Q) row[(size_t)qa * H] = rs[0];
        if (qb < Q) row[(size_t)qb * H] = rs[1];
      }
      fence_async();
      __syncthreads();  // M's planes written

      // dxdt^T += dy^T M: rows p, columns k; the group's dCB tile (loaded
      // as the product starts) takes dM o L while the last batch runs
      float* dst = dcb + (size_t)pr * kFrag;
      float old[32];
      frag_load(old, dst);
#pragma unroll
      for (int pm = 0; pm < NP; ++pm)
        mma<2>(
            dx[pm], mh_a, ml_a, 1,
            [&](int kk, float(&v)[4]) {
              const int r = 64 * pm + 16 * warp + g, q = 8 * kk + t;
              v[0] = dyv<NP>(dyt, q, r);
              v[1] = dyv<NP>(dyt, q, r + 8);
              v[2] = dyv<NP>(dyt, q + 4, r);
              v[3] = dyv<NP>(dyt, q + 4, r + 8);
            },
            [&] {
              if (pm == NP - 1) {
                add_unless(dm, old, first);
                frag_store(dm, dst);
              }
            });
    }

    // the head's end: -colsum - w into dcum, w, dxdt
    col_reduce(cs, red);
    __syncthreads();
    if (tid < kTile) {  // warps 0 and 1: a key each (w is 0 past Q)
      const float col = ((red[tid] + red[kTile + tid]) +
                         red[2 * kTile + tid]) + red[3 * kTile + tid];
      const float w = ((redw[tid] + redw[kTile + tid]) +
                       redw[2 * kTile + tid]) + redw[3 * kTile + tid];
      const int k = k0 + tid;
      if (tid < kv) a.dcum[((size_t)bc * Q + k) * H + h] = -col - w;
      float ws = w;  // sum_k w_k over the warp's 32 keys
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ws += __shfl_xor_sync(0xffffffffu, ws, off);
      if ((tid & 31) == 0)
        a.wsum[(((size_t)bc * nq + kt) * H + h) * 2 + warp] = ws;
    }
    float* dxh = a.dxdt + ((size_t)bc * Q + k0) * hp + (size_t)h * P;
#pragma unroll
    for (int pm = 0; pm < NP; ++pm)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pp = 64 * pm + 16 * warp + g + 8 * (e >> 1);
          const int c = 8 * i + 2 * t + (e & 1);
          if (pp < P && c < kv) dxh[c * hp + pp] = dx[pm][4 * i + e];
        }
  }
}

constexpr int kDcumItems = 8 * kThreads;  // dcum entries a fold block

// pass 3: blocks [0, 2 BC nq) fold the groups' tiles: role 0 forms dC
// for the queries of tile j, role 1 dB for its keys; the blocks after
// them finish dcum, kDcumItems entries each
template <int NN>
__global__ void __launch_bounds__(kThreads) ssd_bwd_fold_kernel(const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* p = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_addr(p);
  constexpr int PB = 2 * kBox;  // bytes of a plane
  const int Q = a.Q, N = a.N, H = a.H, nq = a.nq, npairs = nq * (nq + 1) / 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nfold = 2 * a.BC * nq;
  if ((int)blockIdx.x >= nfold) {
    // dcum += the rowsums, key tiles in order; at Q - 1 also + sum_k
    // w_k, key tiles in order
    const size_t qh = (size_t)Q * H;
    const size_t f0 = (size_t)(blockIdx.x - nfold) * kDcumItems;
#pragma unroll
    for (int u = 0; u < kDcumItems / kThreads; ++u) {
      const size_t f = f0 + u * kThreads + tid;
      if (f >= (size_t)a.BC * qh) break;
      const size_t bc = f / qh, r = f % qh;
      const int q = (int)(r / H), h = (int)(r % H);
      float v = a.dcum[f];
      const float* rows = a.rowp + bc * nq * qh + r;
      for (int kt = 0; kt <= q / kTile; ++kt) v += rows[kt * qh];
      if (q == Q - 1)
        for (int i = 0; i < 2 * nq; ++i)
          v += a.wsum[((bc * nq + i / 2) * H + h) * 2 + i % 2];
      a.dcum[f] = v;
    }
    return;
  }
  const int role = blockIdx.x & 1, j = (blockIdx.x >> 1) % nq;
  const int bc = (blockIdx.x >> 1) / nq;
  const float* dcb = a.dcbp + (size_t)bc * a.groups * npairs * kFrag;
  const size_t gstride = (size_t)npairs * kFrag;
  float acc[NN][32];
  if (role == 0) {
#pragma unroll
    for (int nm = 0; nm < NN; ++nm)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[nm][e] = 0.f;
    for (int kt = 0; kt <= j; ++kt) {
      // dC^T += B^T dCB^T: rows n, columns q; B^T's fragments load
      // beside the groups' tiles
      const float* bk = a.b + ((size_t)bc * Q + kt * kTile) * N;
      const int kv = Q - kt * kTile;
      float af[NN][8][4];
#pragma unroll
      for (int nm = 0; nm < NN; ++nm)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          gfrag(af[nm][kk], bk, 1, N, 64 * nm + 16 * warp + g, 8 * kk + t, N,
                kv);
      float s[32];
      frag_fold(s, dcb + (size_t)pair_of(j, kt) * kFrag, gstride, a.groups);
      __syncthreads();  // the last product is done with the planes
      acc_to_planes(s, p, p + PB);
      fence_async();
      __syncthreads();
#pragma unroll
      for (int nm = 0; nm < NN; ++nm)
        mma<2>(acc[nm], base, base + PB, 1, [&](int kk, float(&v)[4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = af[nm][kk][e];
        });
    }
#pragma unroll
    for (int nm = 0; nm < NN; ++nm)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 64 * nm + 16 * warp + g + 8 * (e >> 1);
          const int q = j * kTile + 8 * i + 2 * t + (e & 1);
          if (n < N && q < Q)
            a.dc[((size_t)bc * Q + q) * N + n] = acc[nm][4 * i + e];
        }
    return;
  }
  // dB^T = dB2^T + C^T dCB: rows n, columns k
#pragma unroll
  for (int nm = 0; nm < NN; ++nm)
    frag_fold(acc[nm],
              a.db2p + (((size_t)bc * a.groups * nq + j) * NN + nm) * kFrag,
              (size_t)nq * NN * kFrag, a.groups);
  for (int qt = j; qt < nq; ++qt) {
    const float* cq = a.c + ((size_t)bc * Q + qt * kTile) * N;
    const int qv = Q - qt * kTile;
    float af[NN][8][4];
#pragma unroll
    for (int nm = 0; nm < NN; ++nm)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        gfrag(af[nm][kk], cq, 1, N, 64 * nm + 16 * warp + g, 8 * kk + t, N,
              qv);
    float s[32];
    frag_fold(s, dcb + (size_t)pair_of(qt, j) * kFrag, gstride, a.groups);
    __syncthreads();
    acc_to_planes_t(s, p, p + PB);
    fence_async();
    __syncthreads();
#pragma unroll
    for (int nm = 0; nm < NN; ++nm)
      mma<2>(acc[nm], base, base + PB, 1, [&](int kk, float(&v)[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = af[nm][kk][e];
      });
  }
#pragma unroll
  for (int nm = 0; nm < NN; ++nm)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 64 * nm + 16 * warp + g + 8 * (e >> 1);
        const int k = j * kTile + 8 * i + 2 * t + (e & 1);
        if (n < N && k < Q)
          a.db[((size_t)bc * Q + k) * N + n] = acc[nm][4 * i + e];
      }
}

template <int NP, int NN>
cudaError_t launch(const Args& a, cudaStream_t st) {
  constexpr size_t cb_smem = 1024 + 4 * NN * kBox, fold_smem = 1024 + 4 * kBox;
  constexpr size_t keys = keys_smem<NP>();
  static_assert(keys <= kSmemMax && cb_smem <= kSmemMax, "shared memory");
  static bool configured = false;
  cudaError_t err;
  if (!configured) {
    if ((err = cudaFuncSetAttribute(ssd_bwd_cb_kernel<NN>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)cb_smem)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(ssd_bwd_keys_kernel<NP, NN>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)keys)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(ssd_bwd_fold_kernel<NN>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)fold_smem)) != cudaSuccess)
      return err;
    configured = true;
  }
  const long long pairs = (long long)a.nq * (a.nq + 1) / 2;
  const long long n1 = a.BC * pairs, n2 = (long long)a.nq * a.BC * a.groups;
  const long long n3 =
      2LL * a.BC * a.nq +
      ((long long)a.BC * a.Q * a.H + kDcumItems - 1) / kDcumItems;
  if (n1 > 0x7fffffff || n2 > 0x7fffffff || n3 > 0x7fffffff)
    return cudaErrorInvalidValue;
  ssd_bwd_cb_kernel<NN><<<(unsigned)n1, kThreads, cb_smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_keys_kernel<NP, NN><<<(unsigned)n2, kThreads, keys, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_fold_kernel<NN><<<(unsigned)n3, kThreads, fold_smem, st>>>(a);
  return cudaGetLastError();
}

bool valid(int Q, int N, int P) {
  return Q > 0 && Q <= kMaxQ && N > 0 && P > 0 && N % 4 == 0 &&
         P % 4 == 0 && N <= kMaxDim && P <= kMaxDim;
}

}  // namespace

// Floats of scratch that ssd_intra_bwd takes at these sizes (-1 where
// it refuses them).
extern "C" long long ssd_intra_bwd_workspace(int BC, int Q, int H, int N,
                                             int P) {
  if (BC <= 0 || H <= 0) return 0;
  if (!valid(Q, N, P)) return -1;
  return (long long)layout(BC, Q, H, N).total;
}

// cum [BC,Q,H], xdt and dy [BC,Q,H,P], b and c [BC,Q,N], ds [BC,H,N,P]
// in; dcum, dxdt, db, dc of the same shapes out; ws the scratch of
// ssd_intra_bwd_workspace floats.  All fp32, contiguous, 16-byte
// aligned.  Q in [1, 256]; N and P multiples of 4 in [4, 128].  Returns
// cudaGetLastError() after the last launch.
extern "C" int ssd_intra_bwd(const void* cum, const void* xdt, const void* b,
                             const void* c, const void* dy, const void* ds,
                             void* dcum, void* dxdt, void* db, void* dc,
                             void* ws, int BC, int Q, int H, int N, int P,
                             void* stream) {
  if (BC <= 0 || H <= 0) return cudaSuccess;
  if (!valid(Q, N, P)) return cudaErrorInvalidValue;
  const Layout l = layout(BC, Q, H, N);
  float* s = static_cast<float*>(ws);
  const Args a{static_cast<const float*>(cum), static_cast<const float*>(xdt),
               static_cast<const float*>(b),   static_cast<const float*>(c),
               static_cast<const float*>(dy),  static_cast<const float*>(ds),
               static_cast<float*>(dcum),      static_cast<float*>(dxdt),
               static_cast<float*>(db),        static_cast<float*>(dc),
               s + l.g, s + l.dcbp, s + l.db2p, s + l.rowp, s + l.wsum,
               BC, Q, H, N, P, l.nq, l.groups, l.hg};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P > 64)
    return N > 64 ? launch<2, 2>(a, st) : launch<2, 1>(a, st);
  return N > 64 ? launch<1, 2>(a, st) : launch<1, 1>(a, st);
}
