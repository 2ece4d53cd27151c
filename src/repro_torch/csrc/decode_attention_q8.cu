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
//   s_i32[s] = sum_d qq[d]*k[s,d]   int32 (dp4a over 4 d at a time)
//   s[s]  = ((s_i32*qs)*ks[s])*(1/sqrt(D)), NEG_INF where masked
//   p     = exp(s - max s) / sum exp(s - max s)
//   pv    = p*vs[s]; ps = max(max|pv|/127, 1e-20); pq = clip(rint(pv/ps))
//   o[d]  = (sum_s pq[s]*v[s,d]) * ps     int32 sums (dp4a), then fp32
//
// in JAX's order of operations, so that only the exponentials and the
// order of the softmax sum differ from the reference.  The masks are
// those of the JAX function: a ring when Smax == window (every slot
// below min(len, Smax)), a window that is not a ring (len - window <= s
// < len), or s < len; len is per slot.
//
// What bounds it on this card: bytes.  Every int8 of k and v is read
// once, plus the fp16 scales: at qwen2.5-32b's decode over 16 slots of
// 32768 tokens (8 kv heads, D 128) 1.09 GB, 0.326 ms at 3.35 TB/s, half
// what a bf16 cache costs.  pq needs the max over the whole row, so the
// work is four launches in stream order, no float atomics and a fixed
// order for every float sum, so every run gives the same bits:
//
//   q8_scores_kernel  a block per (b, kv) and 256 positions, a thread
//                     per position: quantizes the G query rows into
//                     shared memory (a warp a row), reads its k row with
//                     16-byte loads and writes the G scores to an fp32
//                     scratch [B,KV,G,Smax] and each row's block max;
//   q8_stats_kernel   a block per (b, kv, g) row: the max, the sum of
//                     exponentials (each thread in order, then a fixed
//                     tree) and ps; zeroes the row's int32 sums;
//   q8_pv_kernel      a block per (b, kv) and 1024 positions: forms pq
//                     for the G rows in shared memory, then a thread per
//                     (4 columns d, a lane of positions) reads 4 v rows
//                     as 4-byte words (coalesced across the warp), four
//                     position quads ahead, transposes them with byte
//                     permutes and takes dp4a against 4 positions of pq
//                     (accumulators for G rounded up to 1, 2, 4, 5 or 8);
//                     sums go to shared and then global int32 sums by
//                     integer atomics (exact, so their order does not
//                     matter).  Four positions whose pq are all 0
//                     (masked, or too small to count) are not read;
//   q8_out_kernel     o = float(sum) * ps, in q's dtype.
//
// In the [B,Smax,KV,D] layout a head's rows lie KV*D bytes apart, so the
// grid's fastest axis is (b, kv): the blocks in flight read every head
// of the same positions, whole records of KV*D bytes, not one row of
// each.
// The scores scratch costs 4·G bytes a position and kv head (written
// once, read three times); a later version can keep it on chip.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxG = 8;
constexpr int kScoreRows = 256;      // positions a scores block, a thread each
constexpr int kStatThreads = 1024;
constexpr int kPvRows = 1024;        // positions a P·V block
constexpr int kPvThreads = 256;
constexpr int kPvAhead = 4;          // position quads loaded ahead
constexpr float kNegInf = -1e30f;

int score_tiles(int Smax) { return (Smax + kScoreRows - 1) / kScoreRows; }

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

struct Workspace {
  float* scores;     // [B*KV*G, Smax]
  float* tile_max;   // [B*KV*G, score_tiles(Smax)]
  float* stats;      // [B*KV*G, 4]: max, sum, ps
  int* sums;         // [B*KV*G, D]
};

size_t workspace_bytes(int B, int KV, int G, int Smax, int D,
                       Workspace* ws, char* base) {
  const size_t rows = (size_t)B * KV * G;
  const size_t tiles = score_tiles(Smax);
  const size_t sizes[4] = {align256(rows * Smax * 4),
                           align256(rows * tiles * 4), align256(rows * 16),
                           align256(rows * D * 4)};
  if (ws != nullptr) {
    ws->scores = reinterpret_cast<float*>(base);
    ws->tile_max = reinterpret_cast<float*>(base + sizes[0]);
    ws->stats = reinterpret_cast<float*>(base + sizes[0] + sizes[1]);
    ws->sums = reinterpret_cast<int*>(base + sizes[0] + sizes[1] + sizes[2]);
  }
  return sizes[0] + sizes[1] + sizes[2] + sizes[3];
}

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

// max (or sum, in warp order) over the block, the same value to every
// thread; `red` holds one float a warp
template <bool kSum>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kSum ? warp_sum(v) : warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    r = kSum ? r + red[w] : fmaxf(r, red[w]);
  return r;
}

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x / scale), -127.f), 127.f));
}

__device__ __forceinline__ bool attended(int s, long long len, int Smax,
                                         int window) {
  if (window > 0 && Smax == window) return s < min(len, (long long)Smax);
  return s < len && (window <= 0 || s >= len - window);
}

// The G query rows of (b, kv), a warp each: fp32 scale, int8 payload
// into qw (D bytes a row), the scale rounded to fp16 into qs_f.
template <int D>
__device__ void quantize_q(const void* __restrict__ q, int q_bf16,
                           size_t row0, int G, int* qw, float* qs_f) {
  constexpr int kPerLane = (D + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= G) return;
  const size_t off = (row0 + warp) * D;
  float x[kPerLane];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + 32 * i;
    x[i] = 0.f;
    if (d < D)
      x[i] = q_bf16 ? __bfloat162float(
                          static_cast<const __nv_bfloat16*>(q)[off + d])
                    : static_cast<const float*>(q)[off + d];
    amax = fmaxf(amax, fabsf(x[i]));
  }
  amax = warp_max(amax);
  const float qs = fmaxf(amax / 127.f, 1e-8f);
  int8_t* row = reinterpret_cast<int8_t*>(qw + warp * (D / 4));
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < D) row[d] = quantize(x[i], qs);
  }
  if (lane == 0) qs_f[warp] = __half2float(__float2half_rn(qs));
}

template <int D>
__global__ void __launch_bounds__(kScoreRows) q8_scores_kernel(
    const void* __restrict__ q, int q_bf16, const int8_t* __restrict__ k,
    const __half* __restrict__ k_scale, const long long* __restrict__ lens,
    Workspace ws, int* __restrict__ dbg_s, int Smax, int KV, int G,
    int window, float scale) {
  constexpr int kVecs = D / 16;
  __shared__ __align__(16) int qw[kMaxG][D / 4];
  __shared__ float qs_f[kMaxG];
  __shared__ float red[kScoreRows / 32][kMaxG];
  const int bk = blockIdx.x, b = bk / KV, kv = bk % KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  quantize_q<D>(q, q_bf16, (size_t)bk * G, G, &qw[0][0], qs_f);
  __syncthreads();

  const int s = blockIdx.y * kScoreRows + threadIdx.x;
  float val[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) val[g] = kNegInf;
  if (s < Smax) {
    const size_t pos = (size_t)b * Smax + s;
    const size_t row0 = (size_t)bk * G * Smax + s;
    if (attended(s, lens[b], Smax, window)) {
      const int4* kr = reinterpret_cast<const int4*>(k + (pos * KV + kv) * D);
      int4 kw[kVecs];
#pragma unroll
      for (int j = 0; j < kVecs; ++j) kw[j] = __ldg(kr + j);
      const float ks = __half2float(k_scale[pos * KV + kv]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        int acc = 0;
#pragma unroll
        for (int j = 0; j < kVecs; ++j) {
          const int4 qv = *reinterpret_cast<const int4*>(&qw[g][4 * j]);
          acc = __dp4a(kw[j].x, qv.x, acc);
          acc = __dp4a(kw[j].y, qv.y, acc);
          acc = __dp4a(kw[j].z, qv.z, acc);
          acc = __dp4a(kw[j].w, qv.w, acc);
        }
        val[g] = ((static_cast<float>(acc) * qs_f[g]) * ks) * scale;
        if (dbg_s != nullptr) dbg_s[row0 + (size_t)g * Smax] = acc;
      }
    } else if (dbg_s != nullptr) {
      for (int g = 0; g < G; ++g) dbg_s[row0 + (size_t)g * Smax] = 0;
    }
    for (int g = 0; g < G; ++g) ws.scores[row0 + (size_t)g * Smax] = val[g];
  }
  // each row's max over this block's positions
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    const float m = warp_max(val[g]);
    if (lane == 0) red[warp][g] = m;
  }
  __syncthreads();
  if (threadIdx.x < G) {
    float m = red[0][threadIdx.x];
    for (int w = 1; w < kScoreRows / 32; ++w)
      m = fmaxf(m, red[w][threadIdx.x]);
    ws.tile_max[((size_t)bk * G + threadIdx.x) * gridDim.y + blockIdx.y] = m;
  }
}

__global__ void __launch_bounds__(kStatThreads) q8_stats_kernel(
    const __half* __restrict__ v_scale, Workspace ws, int Smax, int KV,
    int G, int D, int tiles) {
  __shared__ float red[kStatThreads / 32];
  const int r = blockIdx.x, bk = r / G, b = bk / KV, kv = bk % KV;
  float m = kNegInf;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x)
    m = fmaxf(m, ws.tile_max[(size_t)r * tiles + t]);
  m = block_reduce<false>(m, red);
  const float* sr = ws.scores + (size_t)r * Smax;
  float l = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < Smax; i += blockDim.x) l += expf(sr[i] - m);
  l = block_reduce<true>(l, red);
  float pm = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < Smax; i += blockDim.x) {
    const float vs = __half2float(v_scale[((size_t)b * Smax + i) * KV + kv]);
    pm = fmaxf(pm, fabsf((expf(sr[i] - m) / l) * vs));
  }
  pm = block_reduce<false>(pm, red);
  if (threadIdx.x == 0) {
    ws.stats[4 * r] = m;
    ws.stats[4 * r + 1] = l;
    ws.stats[4 * r + 2] = fmaxf(pm / 127.f, 1e-20f);
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    ws.sums[(size_t)r * D + d] = 0;
}

// rows w[0..3] (positions s..s+3, 4 columns each) -> t[i] = column i at
// the 4 positions
__device__ __forceinline__ void transpose4(const int w[4], int t[4]) {
  const unsigned x0 = __byte_perm(w[0], w[1], 0x5140);
  const unsigned x1 = __byte_perm(w[0], w[1], 0x7362);
  const unsigned y0 = __byte_perm(w[2], w[3], 0x5140);
  const unsigned y1 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(x0, y0, 0x5410);
  t[1] = __byte_perm(x0, y0, 0x7632);
  t[2] = __byte_perm(x1, y1, 0x5410);
  t[3] = __byte_perm(x1, y1, 0x7632);
}

// kG: the query rows a kv head this instance holds in registers, G <=
// kG at run time (1, 2, 4, 5 or 8); registers capped for three blocks
// an SM, so that enough loads are in flight
template <int D, int kG>
__global__ void __launch_bounds__(kPvThreads, 3) q8_pv_kernel(
    const int8_t* __restrict__ v, const __half* __restrict__ v_scale,
    Workspace ws, int8_t* __restrict__ dbg_pq, int Smax, int KV, int G) {
  constexpr int kQuads = D / 4;                  // column quads
  constexpr int kLanes = kPvThreads / kQuads;    // position lanes
  __shared__ __align__(16) int8_t pq_s[kG][kPvRows];
  __shared__ float vs_s[kPvRows];
  __shared__ int sum_s[kG * D];
  const int bk = blockIdx.x, b = bk / KV, kv = bk % KV;
  const int t0 = blockIdx.y * kPvRows;
  const int n = min(kPvRows, Smax - t0);
  const int n4 = (n + 3) & ~3;

  for (int i = threadIdx.x; i < kG * D; i += blockDim.x) sum_s[i] = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    vs_s[i] = __half2float(v_scale[((size_t)b * Smax + t0 + i) * KV + kv]);
  __syncthreads();
  // pq of the G rows at this block's positions (0 past Smax and for
  // rows past G)
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const size_t r = (size_t)bk * G + g;
    float m = 0.f, l = 1.f, ps = 1.f;
    if (g < G) {
      m = ws.stats[4 * r];
      l = ws.stats[4 * r + 1];
      ps = ws.stats[4 * r + 2];
    }
    for (int j = threadIdx.x; j < n4; j += blockDim.x) {
      int8_t pq = 0;
      if (g < G && j < n) {
        const float p = expf(ws.scores[r * Smax + t0 + j] - m) / l;
        pq = quantize(p * vs_s[j], ps);
        if (dbg_pq != nullptr) dbg_pq[r * Smax + t0 + j] = pq;
      }
      pq_s[g][j] = pq;
    }
  }
  __syncthreads();

  const int quad = threadIdx.x % kQuads, lane = threadIdx.x / kQuads;
  int acc[kG][4];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0;
  if (lane < kLanes) {
    const size_t stride = (size_t)KV * D;
    const int8_t* vb = v + ((size_t)b * Smax * KV + kv) * D + 4 * quad;
    for (int base = lane; 4 * base < n; base += kPvAhead * kLanes) {
      // kPvAhead position quads: their pq words, then all their v loads
      int pw[kPvAhead][kG], w[kPvAhead][4];
#pragma unroll
      for (int u = 0; u < kPvAhead; ++u) {
        const int s4 = base + u * kLanes;
        bool any = false;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          pw[u][g] = 4 * s4 < n ? reinterpret_cast<const int*>(pq_s[g])[s4]
                                : 0;
          any |= pw[u][g] != 0;
        }
        const int s = t0 + 4 * s4;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[u][i] = (any && s + i < Smax)
                        ? __ldg(reinterpret_cast<const int*>(
                              vb + (size_t)(s + i) * stride))
                        : 0;
      }
#pragma unroll
      for (int u = 0; u < kPvAhead; ++u) {
        int t[4];
        transpose4(w[u], t);
#pragma unroll
        for (int g = 0; g < kG; ++g)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[g][i] = __dp4a(t[i], pw[u][g], acc[g][i]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (acc[g][i] != 0) atomicAdd(&sum_s[g * D + 4 * quad + i], acc[g][i]);
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    if (sum_s[i] != 0) atomicAdd(&ws.sums[(size_t)bk * G * D + i], sum_s[i]);
}

__global__ void q8_out_kernel(Workspace ws, void* __restrict__ out,
                              int out_bf16, int D) {
  const int r = blockIdx.x, d = threadIdx.x;
  const float o = static_cast<float>(ws.sums[(size_t)r * D + d]) *
                  ws.stats[4 * r + 2];
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[(size_t)r * D + d] = __float2bfloat16(o);
  else
    static_cast<float*>(out)[(size_t)r * D + d] = o;
}

template <int D, int kG>
void launch_pv(const int8_t* v, const __half* v_scale, const Workspace& ws,
               int8_t* dbg_pq, int B, int Smax, int KV, int G,
               cudaStream_t st) {
  q8_pv_kernel<D, kG><<<dim3(B * KV, (Smax + kPvRows - 1) / kPvRows),
                        kPvThreads, 0, st>>>(v, v_scale, ws, dbg_pq, Smax,
                                             KV, G);
}

template <int D>
cudaError_t run(const void* q, int q_bf16, const int8_t* k, const int8_t* v,
                const __half* k_scale, const __half* v_scale,
                const long long* lens, void* out, const Workspace& ws,
                int* dbg_s, int8_t* dbg_pq, int B, int Smax, int KV, int G,
                int window, float scale, cudaStream_t st) {
  const int tiles = score_tiles(Smax);
  const int rows = B * KV * G;
  q8_scores_kernel<D><<<dim3(B * KV, tiles), kScoreRows, 0, st>>>(
      q, q_bf16, k, k_scale, lens, ws, dbg_s, Smax, KV, G, window, scale);
  q8_stats_kernel<<<rows, kStatThreads, 0, st>>>(v_scale, ws, Smax, KV, G,
                                                 D, tiles);
  if (G == 1)
    launch_pv<D, 1>(v, v_scale, ws, dbg_pq, B, Smax, KV, G, st);
  else if (G == 2)
    launch_pv<D, 2>(v, v_scale, ws, dbg_pq, B, Smax, KV, G, st);
  else if (G <= 4)
    launch_pv<D, 4>(v, v_scale, ws, dbg_pq, B, Smax, KV, G, st);
  else if (G == 5)
    launch_pv<D, 5>(v, v_scale, ws, dbg_pq, B, Smax, KV, G, st);
  else
    launch_pv<D, 8>(v, v_scale, ws, dbg_pq, B, Smax, KV, G, st);
  q8_out_kernel<<<rows, D, 0, st>>>(ws, out, q_bf16, D);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch decode_attention_q8 needs at these sizes.
extern "C" size_t decode_attention_q8_workspace(int B, int KV, int G,
                                                int Smax, int D) {
  return workspace_bytes(B, KV, G, Smax, D, nullptr, nullptr);
}

// q: [B,1,KV*G,D] bf16 (q_bf16) or fp32, contiguous; k, v: int8
// [B,Smax,KV,D] contiguous and 16-byte aligned; k_scale, v_scale: fp16
// [B,Smax,KV]; lens: int64 [B]; out: [B,1,KV*G,D] in q's dtype;
// workspace: decode_attention_q8_workspace bytes, 256-byte aligned;
// dbg_s (int32) and dbg_pq (int8), [B,KV,G,Smax], may be null: when
// given, they receive the int32 scores (0 where masked) and pq.
// window <= 0: none.  Returns cudaGetLastError() after the launches.
extern "C" int decode_attention_q8(
    const void* q, int q_bf16, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* lens, void* out,
    void* workspace, void* dbg_s, void* dbg_pq, int B, int Smax, int KV,
    int G, int D, int window, float scale, void* stream) {
  if (B <= 0 || Smax <= 0 || KV <= 0 || G <= 0 || G > kMaxG)
    return cudaErrorInvalidValue;
  Workspace ws;
  workspace_bytes(B, KV, G, Smax, D, &ws, static_cast<char*>(workspace));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define Q8_RUN(DIM)                                                        \
  run<DIM>(q, q_bf16, static_cast<const int8_t*>(k),                       \
           static_cast<const int8_t*>(v),                                  \
           static_cast<const __half*>(k_scale),                            \
           static_cast<const __half*>(v_scale),                            \
           static_cast<const long long*>(lens), out, ws,                   \
           static_cast<int*>(dbg_s), static_cast<int8_t*>(dbg_pq), B, Smax, \
           KV, G, window, scale, st)
  switch (D) {
    case 32: return Q8_RUN(32);
    case 80: return Q8_RUN(80);
    case 96: return Q8_RUN(96);
    case 128: return Q8_RUN(128);
    default: return cudaErrorInvalidValue;
  }
#undef Q8_RUN
}
