// SSD (Mamba2) intra-chunk block for Hopper (sm_90a), fp32 in and out,
// products on the tensor cores (wgmma) in 3xTF32; plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan/kernel.py
// (_kernel / ssd_intra_fwd).  Per (batch*chunk bc, head h), with
// cum [Q] the chunk's log-decay cumsum, xdt [Q, P] and B, C [Q, N]
// (one group: B and C are shared by every head):
//
//   y_intra[t] = sum_{j <= t} (C_t . B_j) exp(cum_t - cum_j) xdt_j   [Q, P]
//   S_chunk    = sum_j exp(cum_last - cum_j) B_j xdt_j^T             [N, P]
//
// One launch computes both.  A block owns (bc, head h) and the whole
// chunk; it walks 64-row query tiles qt and, for each, the 64-key tiles
// kt <= qt (tiles above the diagonal are never loaded).  Warpgroup 0
// (warps 0-3) owns the 64 query rows: per (qt, kt) it forms C.B^T in
// registers, turns it into M = tril(CB * exp(cum_t - cum_j)) and
// accumulates M @ xdt.  Warpgroup 1 (warps 4-7) owns the state rows (64
// at a time) and accumulates (B * dec_end)^T @ xdt on the diagonal
// tiles, where every key tile passes once.  dec_end = exp(cum_last -
// cum_j) is computed once per key into shared memory.  Head-dim columns
// go in passes of 64.
//
// Products (the helpers in tf32x3.cuh): wgmma m64n64k8 with tf32
// operands and fp32 accumulators, A from registers, B from shared
// memory.  Each fp32 operand a is split
// as hi = tf32(a), lo = tf32(a - hi) and a product is taken as
// lo*hi' + hi*lo' + hi*hi' (3xTF32, about fp32 accuracy; one TF32 pass
// errs by ~1e-2 where 1e-4 is tolerated).  tf32 wgmma reads B K-major
// only, so after each key tile lands, warpgroup 0 writes B (rows = keys,
// K = state) and warpgroup 1 xdt^T (rows = head-dim columns, K = keys)
// into shared memory once, split into hi and lo planes in the 128-byte
// swizzle the descriptors name; every product then reads them with no
// conversion in its loop, and C.B^T starts as soon as B's planes are
// written.  The A operands (C, M, B * dec_end) are split in registers.
// C.B^T's accumulator feeds M @ xdt as its A operand directly: inside
// each 8-key step the accumulator holds the keys in the order (0, 2, 4,
// 6, 1, 3, 5, 7), so xdt^T's planes store them in that order, and the
// state product's A operand follows it.
//
// Loads: every thread copies raw tiles with 16-byte cp.async (zero-
// filling rows past Q and the k padding of B and C); each warpgroup
// issues the next key tile's copies of the raw tile it has just split,
// so the next tile loads while this one's products run.  C query tiles
// (read as A fragments, row pitch = 4 mod 32 floats: no bank conflicts)
// go through a 2-slot ring, the raw B and xdt key tiles through one
// slot each.  (With one producer warp issuing every copy, that warp's
// issue rate set the kernel's time on the H100.)
//
// Masking comes BEFORE exp: above the diagonal cum_t - cum_j > 0 and
// the exponent can overflow; a product with a 0/1 mask would give
// inf * 0 = NaN.  Here M is a select: exp's value is used only where
// j <= t < Q, and dec_end is 0 past Q.
//
// Q is any value from 1 to 256 (the model's chunk is any divisor of
// the sequence length up to 256, e.g. 65); P and N are multiples of 4
// up to 128 (16-byte rows).
//
// What bounds it on this card: at zamba2-7b's prefill shapes (Q = 64,
// H = 112, P = N = 64) the function moves ~5.6 MB and does ~89 MFLOP of
// products, 1.7 us of bytes against 0.5 us of 3xTF32 tensor time, so
// the bound is bytes; but a block per head (112 blocks, one key tile
// each) makes the kernel a chain of latencies: load, split, C.B^T,
// M @ xdt, store.  The design shortens the chain (C.B^T waits for B's
// planes only; the state product runs beside it) and keeps the tensor
// cores fed within it (no branch between wgmmas, the next batch's A
// fragments split while one batch runs).  C.B^T is formed once a
// block, i.e. once per head: at the prefill shapes a block per head
// fills the most SMs, and a block of two heads (C.B^T formed half as
// often) was slower there.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kTile = 64;         // query rows and keys per tile
constexpr int kPB = 64;           // head-dim columns per pass
constexpr int kMaxQ = 256;
constexpr int kMaxDim = 128;      // largest N and P
constexpr int kThreads = 256;     // warps 0-3: y; warps 4-7: S_chunk
static_assert(kMaxQ == kThreads, "one cum entry a thread");
constexpr int kSmemMax = 232448;

struct Args {
  const float* cum;  // [BC, Q, H]
  const float* xdt;  // [BC, Q, H, P]
  const float* b;    // [BC, Q, N]
  const float* c;    // [BC, Q, N]
  float* y;          // [BC, Q, H, P]
  float* s;          // [BC, H, N, P]
  int Q, H, N, P;
};

__host__ __device__ constexpr int np8_of(int N) { return (N + 7) / 8 * 8; }
// C tile row pitch in floats, = 4 mod 32
__host__ __device__ constexpr int pitch_c(int N) {
  return (N + 31) / 32 * 32 + 4;
}
// 128-byte boxes of the B planes (32 state columns each): two up to
// N = 64, else four, so every batch of 4 k-steps has its box
__host__ __device__ constexpr int b_boxes(int N) { return N > 64 ? 4 : 2; }

// Shared memory, in bytes from a 1024-aligned base: the B planes (hi,
// lo), the xdt^T planes (hi, lo; two boxes each), then cum, dec_end,
// the C ring, the raw B tile and the raw xdt tile.
struct Offsets {
  int bp_hi, bp_lo, xp_hi, xp_lo, cum, dec, cs, kr, xr, total;
};

__host__ __device__ constexpr Offsets offsets(int N) {
  Offsets o{};
  o.bp_hi = 0;
  o.bp_lo = o.bp_hi + b_boxes(N) * kBox;
  o.xp_hi = o.bp_lo + b_boxes(N) * kBox;
  o.xp_lo = o.xp_hi + 2 * kBox;
  o.cum = o.xp_lo + 2 * kBox;
  o.dec = o.cum + 4 * kMaxQ;
  o.cs = o.dec + 4 * kMaxQ;
  o.kr = o.cs + 4 * 2 * kTile * pitch_c(N);
  o.xr = o.kr + 4 * kTile * np8_of(N);
  o.total = o.xr + 4 * kTile * kPB;
  return o;
}

__host__ __device__ constexpr size_t smem_bytes(int N) {
  return 1024 + offsets(N).total;  // + slack to align the base
}

// A 64-row tile, `cols` floats a row (a multiple of 4), into `dst`
// (row pitch `pitch`) by threads tid < nthr: row r < rows holds
// src[r * stride + c] for c < valid_cols and zeros past it; rows past
// `rows` are zeros.
__device__ __forceinline__ void copy_tile(float* dst, int pitch,
                                          const float* src, size_t stride,
                                          int rows, int cols, int valid_cols,
                                          int tid, int nthr) {
  const int per_row = cols / 4;
  if ((per_row & (per_row - 1)) == 0) {  // a power of 2: no division
    const int sh = __ffs(per_row) - 1;
    for (int i = tid; i < kTile * per_row; i += nthr) {
      const int r = i >> sh, c = (i & (per_row - 1)) * 4;
      const bool ok = r < rows && c < valid_cols;
      hopper::cp_async<16>(smem_addr(dst + r * pitch + c),
                           ok ? src + r * stride + c : src, ok ? 16 : 0);
    }
    return;
  }
  for (int i = tid; i < kTile * per_row; i += nthr) {
    const int r = i / per_row, c = (i - r * per_row) * 4;
    const bool ok = r < rows && c < valid_cols;
    hopper::cp_async<16>(smem_addr(dst + r * pitch + c),
                         ok ? src + r * stride + c : src, ok ? 16 : 0);
  }
}

// named barriers besides __syncthreads' 0: 1 warpgroup 0 alone, 2 the
// B planes written (warpgroup 0 arrives, 1 waits), 3 warpgroup 1 alone,
// 4 the xdt^T planes written (warpgroup 1 arrives, 0 waits)
enum { kBarY = 1, kBarB = 2, kBarS = 3, kBarX = 4 };
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

struct Smem {
  unsigned char* p;  // the aligned base
  uint32_t base;     // its shared-memory address
  Offsets o;
  float* cum;  // [kMaxQ] the head's cum, 0 past Q
  float* dec;  // [kMaxQ] exp(cum_last - cum_j), 0 past Q
  float* cs;   // [2][kTile][pc] C query tiles
  float* kr;   // [kTile][np8] raw B key tile
  float* xr;   // [kTile][kPB] raw xdt key tile
  int pc, np8;
};

// byte offset of B[key j][state n] in a B plane
__device__ __forceinline__ uint32_t b_off(int j, int n) {
  return (n >> 5) * kBox + swz(j, (n & 31) >> 2) + (n & 3) * 4;
}

// One step of the walk: head-dim pass pb, query tile qt, key tile kt;
// ci counts the (pb, qt) steps (the C ring's slot is ci & 1).
struct Step {
  int pb, qt, kt, ci;
};

// the step after `st`, or pb = npb where the walk ends
__device__ __forceinline__ Step next_step(Step st, int nq) {
  if (st.kt < st.qt) return {st.pb, st.qt, st.kt + 1, st.ci};
  if (st.qt + 1 < nq) return {st.pb, st.qt + 1, 0, st.ci + 1};
  return {st.pb + 1, 0, 0, st.ci + 1};
}

// Issue raw tiles of step `st` by threads tid < nthr: C query tile qt
// where the step starts a query tile, and B key tile kt
__device__ __forceinline__ void load_bc(const Args& a, const Smem& m, Step st,
                                        int bc, int tid, int nthr) {
  const int Q = a.Q, N = a.N;
  if (st.kt == 0)
    copy_tile(m.cs + (st.ci & 1) * kTile * m.pc, m.pc,
              a.c + ((size_t)bc * Q + st.qt * kTile) * N, N,
              Q - st.qt * kTile, m.np8, N, tid, nthr);
  copy_tile(m.kr, m.np8, a.b + ((size_t)bc * Q + st.kt * kTile) * N, N,
            Q - st.kt * kTile, m.np8, N, tid, nthr);
}

// ... and the xdt key tile kt of head h (pass pb)
__device__ __forceinline__ void load_x(const Args& a, const Smem& m, Step st,
                                       int bc, int h, int tid, int nthr) {
  const int Q = a.Q, P = a.P, H = a.H, rows = Q - st.kt * kTile;
  const int pcols = min(kPB, P - st.pb * kPB);
  copy_tile(m.xr, kPB,
            a.xdt + (((size_t)bc * Q + st.kt * kTile) * H + h) * P +
                st.pb * kPB,
            (size_t)H * P, rows, pcols, pcols, tid, nthr);
}

// At the start of each step every thread waits for its copies and
// meets the others (the raw tiles are then visible, and every product
// of the step before is done, so the planes are free).  Warpgroup 0
// then splits B into its planes and starts C.B^T; warpgroup 1 splits
// xdt^T and joins once B is written; warpgroup 0 waits for xdt^T only
// before M @ xdt.  Each issues the next step's copies of the raw tile
// it has just freed, to load while this step's products run.
// B planes: row = key, K = state column.
__device__ __forceinline__ void begin_y(const Args& a, const Smem& m,
                                        Step st, int nq, int npb, int bc,
                                        int gt) {
  hopper::cp_async_wait<0>();
  __syncthreads();
  const int per_row = m.np8 / 4;  // 16-byte chunks of a B row
  const bool pow2 = (per_row & (per_row - 1)) == 0;
  const int sh = __ffs(per_row) - 1;
#pragma unroll 4
  for (int i = gt; i < kTile * per_row; i += 128) {
    const int r = pow2 ? i >> sh : i / per_row, c4 = i - r * per_row;
    const float4 v =
        *reinterpret_cast<const float4*>(m.kr + r * m.np8 + 4 * c4);
    uint4 hi, lo;
    split(v.x, hi.x, lo.x);
    split(v.y, hi.y, lo.y);
    split(v.z, hi.z, lo.z);
    split(v.w, hi.w, lo.w);
    const uint32_t off = b_off(r, 4 * c4);
    *reinterpret_cast<uint4*>(m.p + m.o.bp_hi + off) = hi;
    *reinterpret_cast<uint4*>(m.p + m.o.bp_lo + off) = lo;
  }
  // the planes are read by wgmma (the async proxy)
  fence_async();
  bar_sync(kBarY, 128);
  bar_arrive(kBarB, 256);
  const Step nx = next_step(st, nq);
  if (nx.pb < npb) load_bc(a, m, nx, bc, gt, 128);
  hopper::cp_async_commit();
}

// xdt^T planes: row = head-dim column p, K = key, keys of each 8-step in
// the order (0, 2, 4, 6, 1, 3, 5, 7); thread (p, key octet g8, parity e)
// takes keys 8 g8 + e + {0, 2, 4, 6}, which land in K positions
// 8 g8 + 4 e + {0, 1, 2, 3}
__device__ __forceinline__ void begin_s(const Args& a, const Smem& m,
                                        Step st, int nq, int npb, int bc,
                                        int h, int gt) {
  hopper::cp_async_wait<0>();
  __syncthreads();
  constexpr int xp = kPB;  // raw xdt row pitch
#pragma unroll 4
  for (int i = gt; i < kPB * 16; i += 128) {
    const int p = i % kPB, q = i / kPB;
    const int g8 = q >> 1, e = q & 1;
    const float* col = m.xr + (8 * g8 + e) * xp + p;
    uint4 hi, lo;
    split(col[0], hi.x, lo.x);
    split(col[2 * xp], hi.y, lo.y);
    split(col[4 * xp], hi.z, lo.z);
    split(col[6 * xp], hi.w, lo.w);
    const int kpos = 8 * g8 + 4 * e;
    const uint32_t off = (kpos >> 5) * kBox + swz(p, (kpos & 31) >> 2);
    *reinterpret_cast<uint4*>(m.p + m.o.xp_hi + off) = hi;
    *reinterpret_cast<uint4*>(m.p + m.o.xp_lo + off) = lo;
  }
  fence_async();
  bar_sync(kBarS, 128);
  bar_arrive(kBarX, 256);
  const Step nx = next_step(st, nq);
  if (nx.pb < npb) load_x(a, m, nx, bc, h, gt, 128);
  hopper::cp_async_commit();
  bar_sync(kBarB, 256);  // B planes written
}

// warpgroup 0: y_intra; warp w holds query rows [16 w, +16) of a tile
template <int NM>
__device__ __forceinline__ void y_group(const Args& a, const Smem& m, int bc,
                                        int h, int warp, int lane, int tid) {
  const int Q = a.Q, P = a.P, H = a.H, pc = m.pc;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (Q + kTile - 1) / kTile, npb = (P + kPB - 1) / kPB;
  const int nk8 = m.np8 / 8;
  Step st{0, 0, 0, 0};
  for (int pb = 0; pb < npb; ++pb) {
    const int pcols = min(kPB, P - pb * kPB);
    for (int qt = 0; qt < nq; ++qt) {
      const int t0 = qt * kTile + 16 * warp + g, t1 = t0 + 8;  // my rows
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;

      for (int kt = 0; kt <= qt; ++kt, st = next_step(st, nq)) {
        begin_y(a, m, st, nq, npb, bc, tid);
        const float* crow = m.cs + ((st.ci & 1) * kTile + 16 * warp + g) * pc;
        uint32_t ah[2][4][4], al[2][4][4];

        // CB = C . B^T over the state columns, 8 a step
        float cb[32];
#pragma unroll
        for (int b = 0; b < 2 * NM; ++b) {
          const int k0 = 4 * b;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int c = 8 * min(k0 + s, nk8 - 1) + t;
            const bool in = k0 + s < nk8;  // else a zero step
            split(in ? crow[c] : 0.f, ah[b & 1][s][0], al[b & 1][s][0]);
            split(in ? crow[8 * pc + c] : 0.f, ah[b & 1][s][1],
                  al[b & 1][s][1]);
            split(in ? crow[c + 4] : 0.f, ah[b & 1][s][2], al[b & 1][s][2]);
            split(in ? crow[8 * pc + c + 4] : 0.f, ah[b & 1][s][3],
                  al[b & 1][s][3]);
          }
          if (b == 0) pin(cb);  // not while a batch writes it
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            wgmma3(cb, ah[b & 1][s], al[b & 1][s],
                   m.base + m.o.bp_hi + kstep(k0 + s),
                   m.base + m.o.bp_lo + kstep(k0 + s), k0 + s > 0);
          BATCH_ISSUED(b, ah, al);
        }
        BATCH_DRAIN(ah, al);
        pin(cb);
        bar_sync(kBarX, 256);  // xdt^T planes written

        // M @ xdt, keys 8 a step
        const float cq0 = m.cum[t0], cq1 = m.cum[t1];
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int k0 = 4 * b;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int nt = k0 + s;
            const int j0 = kt * kTile + 8 * nt + 2 * t, j1 = j0 + 1;
            const float c0 = m.cum[j0], c1 = m.cum[j1];
            // mask first: exp's value only where j <= t < Q
            const float m0 = j0 <= t0 && t0 < Q
                                 ? cb[4 * nt] * __expf(cq0 - c0) : 0.f;
            const float m1 = j1 <= t0 && t0 < Q
                                 ? cb[4 * nt + 1] * __expf(cq0 - c1) : 0.f;
            const float m2 = j0 <= t1 && t1 < Q
                                 ? cb[4 * nt + 2] * __expf(cq1 - c0) : 0.f;
            const float m3 = j1 <= t1 && t1 < Q
                                 ? cb[4 * nt + 3] * __expf(cq1 - c1) : 0.f;
            // A slots (t, t + 4) hold keys (2t, 2t + 1)
            split(m0, ah[b & 1][s][0], al[b & 1][s][0]);
            split(m2, ah[b & 1][s][1], al[b & 1][s][1]);
            split(m1, ah[b & 1][s][2], al[b & 1][s][2]);
            split(m3, ah[b & 1][s][3], al[b & 1][s][3]);
          }
          if (b == 0) pin(acc);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            wgmma3(acc, ah[b & 1][s], al[b & 1][s],
                   m.base + m.o.xp_hi + kstep(k0 + s),
                   m.base + m.o.xp_lo + kstep(k0 + s), 1);
          BATCH_ISSUED(b, ah, al);
        }
        BATCH_DRAIN(ah, al);
        pin(acc);
      }

      float* yh = a.y + ((size_t)bc * Q * H + h) * P + pb * kPB;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = 8 * i + 2 * t;
        if (p >= pcols) continue;
        if (t0 < Q)
          *reinterpret_cast<float2*>(yh + (size_t)t0 * H * P + p) =
              make_float2(acc[4 * i], acc[4 * i + 1]);
        if (t1 < Q)
          *reinterpret_cast<float2*>(yh + (size_t)t1 * H * P + p) =
              make_float2(acc[4 * i + 2], acc[4 * i + 3]);
      }
    }
  }
}

// warpgroup 1: S_chunk; warp sw holds state rows [64 i + 16 sw, +16),
// i < NM
template <int NM>
__device__ __forceinline__ void s_group(const Args& a, const Smem& m, int bc,
                                        int h, int sw, int lane, int tid) {
  const int Q = a.Q, N = a.N, P = a.P, H = a.H;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (Q + kTile - 1) / kTile, npb = (P + kPB - 1) / kPB;
  const float* bp_hi = reinterpret_cast<const float*>(m.p + m.o.bp_hi);
  const float* bp_lo = reinterpret_cast<const float*>(m.p + m.o.bp_lo);
  Step st{0, 0, 0, 0};
  for (int pb = 0; pb < npb; ++pb) {
    const int pcols = min(kPB, P - pb * kPB);
    float acc[NM][32];
#pragma unroll
    for (int i = 0; i < NM; ++i)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;

    for (int qt = 0; qt < nq; ++qt) {
      for (int kt = 0; kt <= qt; ++kt, st = next_step(st, nq)) {
        begin_s(a, m, st, nq, npb, bc, h, tid - 128);
        if (kt != qt) continue;  // each key tile once: on the diagonal
        const float* dec = m.dec + kt * kTile;
        uint32_t ah[2][4][4], al[2][4][4];
#pragma unroll
        for (int b = 0; b < 2 * NM; ++b) {
          const int i = b / 2, k0 = 4 * (b & 1);
          const int n0 = 64 * i + 16 * sw + g;  // rows n0, n0 + 8
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int j0 = 8 * (k0 + s) + 2 * t;  // keys j0, j0 + 1
            // B from its planes (hi + lo is B to 2^-22), at (j0, n0),
            // (j0, n0 + 8), (j0 + 1, n0), (j0 + 1, n0 + 8)
            float bv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t off = b_off(j0 + (e >> 1), n0 + 8 * (e & 1)) / 4;
              bv[e] = bp_hi[off] + bp_lo[off];
            }
            const float d0 = dec[j0], d1 = dec[j0 + 1];
            split(bv[0] * d0, ah[b & 1][s][0], al[b & 1][s][0]);
            split(bv[1] * d0, ah[b & 1][s][1], al[b & 1][s][1]);
            split(bv[2] * d1, ah[b & 1][s][2], al[b & 1][s][2]);
            split(bv[3] * d1, ah[b & 1][s][3], al[b & 1][s][3]);
          }
          if (b == 0)
#pragma unroll
            for (int i2 = 0; i2 < NM; ++i2) pin(acc[i2]);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            wgmma3(acc[i], ah[b & 1][s], al[b & 1][s],
                   m.base + m.o.xp_hi + kstep(k0 + s),
                   m.base + m.o.xp_lo + kstep(k0 + s), 1);
          BATCH_ISSUED(b, ah, al);
        }
        BATCH_DRAIN(ah, al);
#pragma unroll
        for (int i2 = 0; i2 < NM; ++i2) pin(acc[i2]);
      }
    }

    float* sh = a.s + (((size_t)bc * H + h) * N) * P + pb * kPB;
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      const int n0 = 64 * i + 16 * sw + g, n1 = n0 + 8;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int p = 8 * c + 2 * t;
        if (p >= pcols) continue;
        if (n0 < N)
          *reinterpret_cast<float2*>(sh + (size_t)n0 * P + p) =
              make_float2(acc[i][4 * c], acc[i][4 * c + 1]);
        if (n1 < N)
          *reinterpret_cast<float2*>(sh + (size_t)n1 * P + p) =
              make_float2(acc[i][4 * c + 2], acc[i][4 * c + 3]);
      }
    }
  }
}

// NM: 64-row passes of state rows (1 where N <= 64, else 2)
template <int NM>
__global__ void __launch_bounds__(kThreads, 1) ssd_intra_kernel(Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const int Q = a.Q;
  Smem m;
  m.p = smem_raw + pad;
  m.base = raw + pad;
  m.o = offsets(a.N);
  m.pc = pitch_c(a.N);
  m.np8 = np8_of(a.N);
  m.cum = reinterpret_cast<float*>(m.p + m.o.cum);
  m.dec = reinterpret_cast<float*>(m.p + m.o.dec);
  m.cs = reinterpret_cast<float*>(m.p + m.o.cs);
  m.kr = reinterpret_cast<float*>(m.p + m.o.kr);
  m.xr = reinterpret_cast<float*>(m.p + m.o.xr);

  const int bc = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // cum first (a strided 4-byte read, into a register), so its latency
  // overlaps the first tiles' copies; kMaxQ == kThreads
  const float cv =
      tid < Q ? __ldg(a.cum + ((size_t)bc * Q + tid) * a.H + h) : 0.f;
  load_bc(a, m, Step{0, 0, 0, 0}, bc, tid, kThreads);
  load_x(a, m, Step{0, 0, 0, 0}, bc, h, tid, kThreads);
  hopper::cp_async_commit();
  // zero the B planes' state columns past N, which no split writes but
  // zero steps read
  if (m.np8 < 32 * b_boxes(a.N))
    for (int i = tid; i < m.o.cum / 16; i += kThreads)
      reinterpret_cast<uint4*>(m.p)[i] = make_uint4(0, 0, 0, 0);
  m.cum[tid] = cv;
  __syncthreads();
  m.dec[tid] = tid < Q ? expf(m.cum[Q - 1] - cv) : 0.f;
  // (dec is read after the first step's __syncthreads)
  if (warp < 4)
    y_group<NM>(a, m, bc, h, warp, lane, tid);
  else
    s_group<NM>(a, m, bc, h, warp - 4, lane, tid);
}

template <int NM>
int launch(const Args& a, int BC, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_kernel<NM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMax);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long blocks = (long long)BC * a.H;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  ssd_intra_kernel<NM>
      <<<(unsigned)blocks, kThreads, smem_bytes(a.N), stream>>>(a);
  return cudaGetLastError();
}

static_assert(smem_bytes(kMaxDim) <= kSmemMax, "shared memory");

}  // namespace

// cum: [BC, Q, H]; xdt: [BC, Q, H, P]; b, c: [BC, Q, N]; y: [BC, Q, H, P];
// s: [BC, H, N, P]; all fp32, contiguous, 16-byte aligned.  1 <= Q <= 256;
// N and P multiples of 4 in [4, 128].  One launch writes y and s;
// returns cudaGetLastError() after it.
extern "C" int ssd_intra_fwd(const void* cum, const void* xdt, const void* b,
                             const void* c, void* y, void* s, int BC, int Q,
                             int H, int N, int P, void* stream) {
  if (BC <= 0 || H <= 0) return cudaSuccess;
  if (Q <= 0 || Q > kMaxQ || N <= 0 || P <= 0 || N % 4 || P % 4 ||
      N > kMaxDim || P > kMaxDim)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(cum), static_cast<const float*>(xdt),
               static_cast<const float*>(b),   static_cast<const float*>(c),
               static_cast<float*>(y),         static_cast<float*>(s),
               Q, H, N, P};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return N > 64 ? launch<2>(a, BC, st) : launch<1>(a, BC, st);
}
