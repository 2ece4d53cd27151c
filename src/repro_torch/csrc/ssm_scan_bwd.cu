// SSD (Mamba2) intra-chunk block, backward, for Hopper (sm_90a): fp32 in
// and out, fp32 FMA products; plain C interface for ctypes.
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
//   dC  = sum_h (dM o L) B,   dB = sum_h (dM o L)^T C + e o (xdt dS^T)
//   dcum = rowsum(dM o M) - colsum(dM o M) - w,  w_k = e_k sum_p
//          xdt_kp (B dS)_kp,  and sum_k w_k added at Q-1.
//
// The diagonal of dM o M is left out of both sums, where it cancels.
// Masking comes BEFORE exp, as in the forward: above the diagonal the
// exponent can overflow, and inf * 0 would give NaN.
//
// Three launches, no float atomics, so every run gives the same bits:
//
//   1. a block per (64-key tile, head, bc) walks the query tiles at or
//      below its keys' diagonal; it recomputes G and dM for each (query
//      tile, key tile) pair into registers, turns them into M and dM o L
//      in shared memory, and accumulates its keys' rows of dxdt and of
//      the per-head dB partial in registers, and colsum(dM o M); before
//      the walk it forms B dS and xdt dS^T for its keys (the dS terms)
//      and w.  It writes dxdt, the partial dBp[bc, h], -colsum - w into
//      dcum and w into a scratch row;
//   2. a block per (64-query tile, head, bc) walks the key tiles at or
//      below its queries, recomputes G and dM, and accumulates its
//      queries' rows of the per-head dC partial and rowsum(dM o M); it
//      adds the rowsum (and, at Q-1, sum_k w_k in key order) to dcum;
//   3. dB and dC fold the per-head partials [bc, H, Q, N] over heads in
//      head order.  C B^T is recomputed per head and per pass, and no
//      [Q, Q] partial of dCB is kept per head (470 MB at zamba2's train
//      shape); the partials dBp and dCp ([bc, H, Q, N], 117 MB each at
//      [1,16,256,112,64,64]) are the scratch.
//
// Layout of the products: 256 threads; thread (rg, cg) = (t / 16, t % 16)
// owns rows rg + 16 i (i < 4) and columns cg + 16 j of every tile, and
// shared tiles have odd row pitches (N + 1, P + 1, 65), so that the 16
// rows a half-warp reads in the same column fall in 16 banks.
//
// What bounds it on this card (the counts chip_smoke.py's bound uses):
// at zamba2's train shape [1,16,256,112,64,64] the function must move
// 390 MB (xdt, dy and dxdt 117 MB each, dS 29 MB: each input read and
// each output written once) and do 22.8 GFLOP of products in fp32 (dM =
// dy xdt^T and M^T dy per head over the lower triangle, C B^T, dCB B and
// dCB^T C once per chunk, B dS and xdt dS^T per head), 0.116 ms of bytes
// against 0.340 ms of fp32 FMA at 67 TFLOP/s, so the bound is
// operations.  This kernel does more products than that (G per head, G
// and dM again in pass 2, dB and dC per head) on CUDA cores; tensor
// cores (the forward's 3xTF32 wgmma) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // query rows and keys per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 256;
constexpr int kMaxDim = 128;       // largest N and P
constexpr int kMPitch = kTile + 1;

struct Args {
  const float* cum;    // [BC, Q, H]
  const float* xdt;    // [BC, Q, H, P]
  const float* b;      // [BC, Q, N]
  const float* c;      // [BC, Q, N]
  const float* dy;     // [BC, Q, H, P]
  const float* ds;     // [BC, H, N, P]
  float* dcum;         // [BC, Q, H]
  float* dxdt;         // [BC, Q, H, P]
  float* db;           // [BC, Q, N]
  float* dc;           // [BC, Q, N]
  float* dbp;          // [BC, H, Q, N] per-head partials
  float* dcp;          // [BC, H, Q, N]
  float* w;            // [BC, H, Q]
  int BC, Q, H, N, P;
};

// rows [0, rows) of a [rows, cols] block at src (row stride `stride`
// floats, cols a multiple of 4, 16-byte aligned) into shared memory of
// row pitch `pitch`; rows from `valid` on are zero-filled
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const float* src, size_t stride,
                                          int rows, int valid, int cols) {
  const int c4 = cols / 4;
  for (int idx = threadIdx.x; idx < rows * c4; idx += kThreads) {
    const int r = idx / c4, c = 4 * (idx % c4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid)
      v = __ldg(reinterpret_cast<const float4*>(src + r * stride + c));
    float* d = dst + r * pitch + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// cum of `rows` positions from q0 for head h (zero past Q)
__device__ __forceinline__ void load_cum(float* dst, const Args& a, int bc,
                                         int h, int q0) {
  if (threadIdx.x < kTile) {
    const int q = q0 + threadIdx.x;
    dst[threadIdx.x] =
        q < a.Q ? __ldg(a.cum + ((size_t)bc * a.Q + q) * a.H + h) : 0.f;
  }
}

// G = C_q B_k^T and D = dy_q xdt_k^T at this thread's (q, k) = (rg +
// 16 i, cg + 16 j); then L (masked before exp), M = G L and dM L into
// shared memory.  Returns this thread's strict-lower dM o M in dmm.
__device__ __forceinline__ void pair_tile(
    const float* sC, const float* sDy, const float* sB, const float* sX,
    const float* cumq, const float* cumk, float* sM, float* sML, int q0,
    int k0, int Q, int N, int P, float (&dmm)[4][4]) {
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const int pn = N + 1, pp = P + 1;
  float g[4][4], d[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = d[i][j] = 0.f;
  for (int s = 0; s < N; ++s) {
    float cv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = sC[(rg + 16 * i) * pn + s];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = sB[(cg + 16 * j) * pn + s];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
  }
  for (int p = 0; p < P; ++p) {
    float yv[4], xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) yv[i] = sDy[(rg + 16 * i) * pp + p];
#pragma unroll
    for (int j = 0; j < 4; ++j) xv[j] = sX[(cg + 16 * j) * pp + p];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) d[i][j] = fmaf(yv[i], xv[j], d[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = rg + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = cg + 16 * j;
      const bool on = k0 + k <= q0 + q && q0 + q < Q;
      const float l = on ? expf(cumq[q] - cumk[k]) : 0.f;
      const float m = g[i][j] * l;
      sM[q * kMPitch + k] = m;
      sML[q * kMPitch + k] = d[i][j] * l;
      dmm[i][j] = k0 + k < q0 + q ? d[i][j] * m : 0.f;
    }
  }
}

// acc[i][j] += sum_{r < rows} lhs[r][rg + 16 i] * rhs[r][cg + 16 j]
// (lhs a 64 x 64 tile of pitch 65, read transposed; rhs of pitch `pr`)
template <int J>
__device__ __forceinline__ void acc_t(float (&acc)[4][J], const float* lhs,
                                      const float* rhs, int pr, int rows,
                                      int cols) {
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  for (int r = 0; r < rows; ++r) {
    float lv[4], rv[J];
#pragma unroll
    for (int i = 0; i < 4; ++i) lv[i] = lhs[r * kMPitch + rg + 16 * i];
#pragma unroll
    for (int j = 0; j < J; ++j)
      rv[j] = cg + 16 * j < cols ? rhs[r * pr + cg + 16 * j] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(lv[i], rv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_{r < rows} lhs[rg + 16 i][r] * rhs[r][cg + 16 j]
template <int J>
__device__ __forceinline__ void acc_n(float (&acc)[4][J], const float* lhs,
                                      const float* rhs, int pr, int rows,
                                      int cols) {
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  for (int r = 0; r < rows; ++r) {
    float lv[4], rv[J];
#pragma unroll
    for (int i = 0; i < 4; ++i) lv[i] = lhs[(rg + 16 * i) * kMPitch + r];
#pragma unroll
    for (int j = 0; j < J; ++j)
      rv[j] = cg + 16 * j < cols ? rhs[r * pr + cg + 16 * j] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(lv[i], rv[j], acc[i][j]);
  }
}

// store rows r0 + rg + 16 i < valid of acc to dst (row stride `stride`)
template <int J>
__device__ __forceinline__ void store_rows(float* dst, size_t stride,
                                           const float (&acc)[4][J],
                                           int valid, int cols) {
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    if (r >= valid) continue;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (cg + 16 * j < cols) dst[r * stride + cg + 16 * j] = acc[i][j];
  }
}

// pass 1's shared memory: the key tiles, the query tiles (or, before
// the walk, dS), M and dM L, cum of keys and queries, dec_end, w and the
// colsum of each warp
size_t key_smem(int N, int P) {
  const size_t tiles = (size_t)kTile * (N + 1) + (size_t)kTile * (P + 1);
  const size_t ds = (size_t)N * (P + 1);
  return sizeof(float) * (tiles + (tiles > ds ? tiles : ds) +
                          2 * kTile * kMPitch + 4 * kTile + kWarps * kTile);
}

// pass 1: a block per (key tile, head, bc); J columns a thread
template <int J>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_keys_kernel(const Args a) {
  extern __shared__ float smem[];
  const int nq = (a.Q + kTile - 1) / kTile;
  const int kt = blockIdx.x % nq;
  const int h = (blockIdx.x / nq) % a.H;
  const int bc = blockIdx.x / (nq * a.H);
  const int k0 = kt * kTile;
  const int N = a.N, P = a.P, pn = N + 1, pp = P + 1;
  float* sB = smem;                          // [64][N+1]  keys
  float* sX = sB + kTile * pn;               // [64][P+1]
  float* sC = sX + kTile * pp;               // [64][N+1]  queries
  float* sDy = sC + kTile * pn;              // [64][P+1]
  float* sDS = sC;                           // [N][P+1], before the walk
  const size_t uni = (size_t)kTile * (pn + pp) > (size_t)N * pp
                         ? (size_t)kTile * (pn + pp) : (size_t)N * pp;
  float* sM = sC + uni;                      // [64][65]
  float* sML = sM + kTile * kMPitch;
  float* cumk = sML + kTile * kMPitch;
  float* cumq = cumk + kTile;
  float* se = cumq + kTile;                  // dec_end of the keys
  float* swe = se + kTile;                   // w of the keys
  float* sred = swe + kTile;                 // [8][64]
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const int kv = min(kTile, a.Q - k0);       // keys of the tile
  const size_t rowhp = (size_t)a.H * P;

  load_rows(sB, pn, a.b + ((size_t)bc * a.Q + k0) * N, N, kTile, kv, N);
  load_rows(sX, pp, a.xdt + (((size_t)bc * a.Q + k0) * a.H + h) * P, rowhp,
            kTile, kv, P);
  load_rows(sDS, pp, a.ds + ((size_t)bc * a.H + h) * N * P, P, N, N, P);
  load_cum(cumk, a, bc, h, k0);
  if (threadIdx.x < kTile) {
    const float last = __ldg(a.cum + ((size_t)bc * a.Q + a.Q - 1) * a.H + h);
    se[threadIdx.x] = threadIdx.x < kv
        ? expf(last - __ldg(a.cum + ((size_t)bc * a.Q + k0 + threadIdx.x)
                                        * a.H + h))
        : 0.f;
  }
  __syncthreads();

  // the dS terms: dxdt = e (B dS), dBp = e (xdt dS^T), w = e sum_p xdt B dS
  float dx[4][J], db[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) dx[i][j] = db[i][j] = 0.f;
  for (int s = 0; s < N; ++s) {              // B dS: rows k, columns p
    float bv[4], dv[J];
#pragma unroll
    for (int i = 0; i < 4; ++i) bv[i] = sB[(rg + 16 * i) * pn + s];
#pragma unroll
    for (int j = 0; j < J; ++j)
      dv[j] = cg + 16 * j < P ? sDS[s * pp + cg + 16 * j] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) dx[i][j] = fmaf(bv[i], dv[j], dx[i][j]);
  }
  for (int p = 0; p < P; ++p) {              // xdt dS^T: rows k, columns s
    float xv[4], dv[J];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = sX[(rg + 16 * i) * pp + p];
#pragma unroll
    for (int j = 0; j < J; ++j)
      dv[j] = cg + 16 * j < N ? sDS[(cg + 16 * j) * pp + p] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) db[i][j] = fmaf(xv[i], dv[j], db[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = rg + 16 * i;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (cg + 16 * j < P) part = fmaf(sX[k * pp + cg + 16 * j], dx[i][j],
                                       part);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)    // over the 16 lanes of row k
      part += __shfl_xor_sync(0xffffffffu, part, off);
    const float e = se[k];
    if (cg == 0) swe[k] = e * part;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      dx[i][j] *= e;
      db[i][j] *= e;
    }
  }
  __syncthreads();                           // sDS is overwritten below

  float cs[4] = {0.f, 0.f, 0.f, 0.f};        // colsum, keys cg + 16 j
  for (int qt = kt; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    const int qv = min(kTile, a.Q - q0);
    load_rows(sC, pn, a.c + ((size_t)bc * a.Q + q0) * N, N, kTile, qv, N);
    load_rows(sDy, pp, a.dy + (((size_t)bc * a.Q + q0) * a.H + h) * P,
              rowhp, kTile, qv, P);
    load_cum(cumq, a, bc, h, q0);
    __syncthreads();
    float dmm[4][4];
    pair_tile(sC, sDy, sB, sX, cumq, cumk, sM, sML, q0, k0, a.Q, N, P, dmm);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cs[j] += dmm[i][j];
    __syncthreads();
    acc_t<J>(dx, sM, sDy, pp, qv, P);        // M^T dy
    acc_t<J>(db, sML, sC, pn, qv, N);        // (dM L)^T C
    __syncthreads();
  }

  store_rows<J>(a.dxdt + (((size_t)bc * a.Q + k0) * a.H + h) * P, rowhp, dx,
                kv, P);
  store_rows<J>(a.dbp + (((size_t)bc * a.H + h) * a.Q + k0) * N, N, db, kv,
                N);
#pragma unroll
  for (int j = 0; j < 4; ++j) {              // over the two rg of a warp
    cs[j] += __shfl_xor_sync(0xffffffffu, cs[j], 16);
    if ((threadIdx.x & 16) == 0) sred[(threadIdx.x / 32) * kTile + cg + 16 * j]
        = cs[j];
  }
  __syncthreads();
  if (threadIdx.x < kv) {
    float col = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) col += sred[wi * kTile + threadIdx.x];
    const int k = k0 + threadIdx.x;
    a.dcum[((size_t)bc * a.Q + k) * a.H + h] = -col - swe[threadIdx.x];
    a.w[((size_t)bc * a.H + h) * a.Q + k] = swe[threadIdx.x];
  }
}

size_t query_smem(int N, int P) {
  return sizeof(float) * (2 * (size_t)kTile * (N + 1) +
                          2 * (size_t)kTile * (P + 1) +
                          2 * kTile * kMPitch + 2 * kTile);
}

// pass 2: a block per (query tile, head, bc)
template <int J>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_queries_kernel(const Args a) {
  extern __shared__ float smem[];
  const int nq = (a.Q + kTile - 1) / kTile;
  const int qt = blockIdx.x % nq;
  const int h = (blockIdx.x / nq) % a.H;
  const int bc = blockIdx.x / (nq * a.H);
  const int q0 = qt * kTile;
  const int N = a.N, P = a.P, pn = N + 1, pp = P + 1;
  float* sC = smem;
  float* sDy = sC + kTile * pn;
  float* sB = sDy + kTile * pp;
  float* sX = sB + kTile * pn;
  float* sM = sX + kTile * pp;
  float* sML = sM + kTile * kMPitch;
  float* cumq = sML + kTile * kMPitch;
  float* cumk = cumq + kTile;
  const int cg = threadIdx.x % 16, rg = threadIdx.x / 16;
  const int qv = min(kTile, a.Q - q0);
  const size_t rowhp = (size_t)a.H * P;

  load_rows(sC, pn, a.c + ((size_t)bc * a.Q + q0) * N, N, kTile, qv, N);
  load_rows(sDy, pp, a.dy + (((size_t)bc * a.Q + q0) * a.H + h) * P, rowhp,
            kTile, qv, P);
  load_cum(cumq, a, bc, h, q0);
  float dc[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) dc[i][j] = 0.f;
  float rs[4] = {0.f, 0.f, 0.f, 0.f};        // rowsum, queries rg + 16 i
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    const int kv = min(kTile, a.Q - k0);
    load_rows(sB, pn, a.b + ((size_t)bc * a.Q + k0) * N, N, kTile, kv, N);
    load_rows(sX, pp, a.xdt + (((size_t)bc * a.Q + k0) * a.H + h) * P,
              rowhp, kTile, kv, P);
    load_cum(cumk, a, bc, h, k0);
    __syncthreads();
    float dmm[4][4];
    pair_tile(sC, sDy, sB, sX, cumq, cumk, sM, sML, q0, k0, a.Q, N, P, dmm);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) rs[i] += dmm[i][j];
    __syncthreads();
    acc_n<J>(dc, sML, sB, pn, kv, N);        // (dM L) B
    __syncthreads();
  }
  store_rows<J>(a.dcp + (((size_t)bc * a.H + h) * a.Q + q0) * N, N, dc, qv,
                N);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)    // over the 16 lanes of row q
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], off);
    const int q = q0 + rg + 16 * i;
    if (cg == 0 && q < a.Q) {
      float* out = a.dcum + ((size_t)bc * a.Q + q) * a.H + h;
      float v = *out + rs[i];
      if (q == a.Q - 1) {
        const float* w = a.w + ((size_t)bc * a.H + h) * a.Q;
        float sum = 0.f;
        for (int k = 0; k < a.Q; ++k) sum += w[k];
        v += sum;
      }
      *out = v;
    }
  }
}

// pass 3: dB and dC as the per-head partials folded over heads, in order
__global__ void __launch_bounds__(kThreads)
ssd_bwd_fold_kernel(const Args a) {
  const size_t qn = (size_t)a.Q * a.N;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (size_t)a.BC * qn) return;
  const size_t bc = i / qn, r = i % qn;
  const float* pb = a.dbp + bc * a.H * qn + r;
  const float* pc = a.dcp + bc * a.H * qn + r;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < a.H; ++h) {
    sb += pb[h * qn];
    sc += pc[h * qn];
  }
  a.db[i] = sb;
  a.dc[i] = sc;
}

template <int J>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const int nq = (a.Q + kTile - 1) / kTile;
  const unsigned blocks = (unsigned)(nq * a.H * a.BC);
  const size_t sk = key_smem(a.N, a.P), sq = query_smem(a.N, a.P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_keys_kernel<J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sk);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_queries_kernel<J>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sq);
  if (err != cudaSuccess) return err;
  ssd_bwd_keys_kernel<J><<<blocks, kThreads, sk, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_queries_kernel<J><<<blocks, kThreads, sq, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t n = (size_t)a.BC * a.Q * a.N;
  ssd_bwd_fold_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                        0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// cum [BC,Q,H], xdt and dy [BC,Q,H,P], b and c [BC,Q,N], ds [BC,H,N,P]
// in; dcum, dxdt, db, dc of the same shapes out; dbp and dcp [BC,H,Q,N]
// and w [BC,H,Q] scratch.  All fp32, contiguous, 16-byte aligned.  Q in
// [1, 256]; N and P multiples of 4 in [4, 128].  Returns
// cudaGetLastError() after the last launch.
extern "C" int ssd_intra_bwd(const void* cum, const void* xdt, const void* b,
                             const void* c, const void* dy, const void* ds,
                             void* dcum, void* dxdt, void* db, void* dc,
                             void* dbp, void* dcp, void* w, int BC, int Q,
                             int H, int N, int P, void* stream) {
  if (BC <= 0 || H <= 0) return cudaSuccess;
  if (Q <= 0 || Q > kMaxQ || N <= 0 || P <= 0 || N % 4 || P % 4 ||
      N > kMaxDim || P > kMaxDim)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(cum), static_cast<const float*>(xdt),
               static_cast<const float*>(b),   static_cast<const float*>(c),
               static_cast<const float*>(dy),  static_cast<const float*>(ds),
               static_cast<float*>(dcum),      static_cast<float*>(dxdt),
               static_cast<float*>(db),        static_cast<float*>(dc),
               static_cast<float*>(dbp),       static_cast<float*>(dcp),
               static_cast<float*>(w),         BC, Q, H, N, P};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (N > 64 || P > 64 ? launch<8>(a, st) : launch<4>(a, st));
}
