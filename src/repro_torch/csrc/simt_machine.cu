// The Vortex SIMT machine's cycle loop for Hopper (sm_90a): one launch
// runs a machine from its state to completion; plain C interface for
// ctypes.
//
// Replaces src/repro/core/simt/machine.py:646 `_run_jit`, the
// `lax.while_loop` that XLA compiles into one device program (no TPU
// kernel: the JAX machine has no `pallas_call`).  The plain PyTorch
// version is `repro_torch.core.simt.machine.run_plain`, a host loop of
// tensor ops; this kernel must reproduce it, and so the JAX machine,
// bit for bit: every counter, register and word of memory.
//
// What bounds it: nothing the roofline counts.  The machine is a serial
// interpreter, one simulated cycle after another on a few hundred bytes
// of state, so its yardstick is SM clocks per simulated cycle: the
// length of the chain of dependent instructions one cycle runs.  One
// block of one CUDA warp runs a machine (nothing else hides latency);
// CUDA lane t is Vortex lane t of whichever warp issues (T <= 32).  The
// design keeps that chain short:
//   * the scheduler's masks live in registers, updated where they
//     change.  `active`, `at_barrier`, `visible` and a derived `stalled`
//     mask are bitmasks over the warps: with W <= 32 every lane holds the
//     whole mask and a pick is a few ALU instructions; with W > 32 lane k
//     holds the word of warps 32k..32k+31 and a pick is a ballot, a
//     shuffle and a find-first-set (W <= 1024).  `stalled` is recomputed
//     only when the cycle reaches `next_wake`, the least stalled_until of
//     a stalled warp; the active count is a popc kept beside the mask;
//   * the program is decoded once per launch into a table in shared
//     memory, one 16-byte record per word (handler, the one immediate the
//     opcode uses, the byte offsets of rs1, rs2 and rd in a warp's GPRs):
//     a cycle fetches with one LDS.128;
//   * a run of idle cycles is skipped in one step.  A cycle with no
//     schedulable warp changes only `cycle`, idle_cycles, the occupancy
//     counter (+ the active warps) and `visible` (all false), and so does
//     every cycle after it until the first stalled active warp that is
//     not at a barrier wakes; with none, until max_cycles;
//   * the memory path computes the cache model only when a lane touches
//     dmem and the bank model only when one touches smem; word indices
//     are masks when MW and SW are powers of two (a second instance of
//     the kernel keeps the modulo for other sizes).
// All other state but dmem sits in shared memory: per-warp records {pc,
// thread mask, stalled_until, IPDOM depth} (one LDS.128 per cycle), GPRs
// [W][32][T] (lane t reads word t, no bank conflicts), IPDOM stacks,
// barriers, smem, cache sets {tag0, tag1, lru, valid bytes}.  dmem (64 Ki
// words) stays in global memory, read through L1.  Warp-uniform state is
// written by every lane with the same value, so only the data one lane
// writes and another reads (memory, cache, spawned warps, barrier
// release flags) needs a __syncwarp.
//
// Where the JAX machine's results rest on XLA's CPU execution, this file
// spells them out (see machine.py's docstring):
//   * floats flush denormal inputs and results to signed zero with x86's
//     tininess after rounding: the arithmetic runs in double (the
//     correctly rounded float result for + - * / sqrt), and a result that
//     rounds below 2^-126 at 24 bits becomes zero.  NaN results take
//     x86's operand order and default NaN; fmin/fmax follow LLVM's x86
//     lowering of minimum/maximum; fcvt.w.s saturates, NaN -> 0.  None of
//     this depends on the build's -ftz/-fmad flags (build.py sets them
//     anyway: -ftz=true -prec-div=true -prec-sqrt=true -fmad=false);
//   * scatters with repeated indices resolve last-wins in lane order:
//     only the highest lane writing an index writes it (__match_any_sync).
//     A store is a write by every lane (the old word where the lane does
//     not store), so a masked-off higher lane aliasing an active lane's
//     word undoes that store, and byte stores from several lanes into one
//     word keep only the highest lane's bytes;
//   * C's INT_MIN / -1 and division by zero are handled as _alu_m does;
//     shifts take b & 31.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSmemBase = 0x10000000u;
constexpr int kIntMin = -2147483647 - 1;
constexpr int kIntMax = 2147483647;
constexpr int kStats = 16;      // machine.STAT_KEYS, then the cycle
constexpr int kMaxWarps = 1024;  // one 32-bit mask word per lane

// opcodes and CSRs (core/simt/isa.py)
constexpr int OP_LUI = 0x37, OP_AUIPC = 0x17, OP_JAL = 0x6F, OP_JALR = 0x67,
              OP_BRANCH = 0x63, OP_LOAD = 0x03, OP_STORE = 0x23,
              OP_IMM = 0x13, OP_OP = 0x33, OP_SYSTEM = 0x73, OP_FP = 0x53,
              OP_CUSTOM0 = 0x0B;
constexpr int CSR_TID = 0xCC0, CSR_WID = 0xCC1, CSR_NT = 0xCC2,
              CSR_NW = 0xCC3, CSR_CYCLE = 0xB00;

// Handlers of the decoded table.  K_CONST writes its immediate (lui, and
// the CSRs whose value is fixed at launch: nt, nw, unknown ones).
enum Handler : int {
  K_CONST, K_AUIPC, K_JAL, K_JALR,
  K_BEQ, K_BNE, K_BLT, K_BGE, K_BLTU, K_BGEU,
  K_LOAD, K_STORE,
  K_ADD, K_SUB, K_SLL, K_SLT, K_SLTU, K_XOR, K_SRL, K_SRA, K_OR, K_AND,
  K_MUL, K_MULH, K_MULHSU, K_MULHU, K_DIV, K_DIVU, K_REM, K_REMU,
  K_ECALL, K_TID, K_WID, K_CYCLE, K_FP,
  K_TMC, K_WSPAWN, K_SPLIT, K_JOIN, K_BAR, K_HALT
};

}  // namespace

// Mirrors kernels/simt_machine/ops.py `_Params` field for field.
struct SimtParams {
  int W, T, D, NB, MW, SW, sets, tag_shift, banks, miss_latency,
      miss_pipeline, max_cycles, imem_len;
  const unsigned* imem;           // [imem_len]
  unsigned* pc;                   // [W]
  unsigned char* active;          // [W]
  int* stalled_until;             // [W]
  unsigned char* at_barrier;      // [W]
  unsigned char* visible;         // [W]
  unsigned char* tmask;           // [W, T]
  int* gpr;                       // [W, T, 32]
  unsigned* ipdom_pc;             // [W, D]
  unsigned char* ipdom_mask;      // [W, D, T]
  unsigned char* ipdom_ft;        // [W, D]
  int* ipdom_sp;                  // [W]
  int* bar_count;                 // [NB]
  unsigned char* bar_release;     // [NB, W]
  int* dmem;                      // [MW]
  int* smem;                      // [SW]
  int* tags;                      // [sets, 2]
  unsigned char* tvalid;          // [sets, 2]
  int* lru;                       // [sets]
  int* counters;                  // [kStats + 1]: STAT_KEYS, cycle
};

namespace {

// The machine's state in shared memory.
struct Shared {
  int4* code;              // [imem_len] decoded program
  int4* warp;              // [W] {pc, tmask, stalled_until, ipdom_sp}
  int4* cache;             // [sets] {tag0, tag1, lru, valid0 | valid1 << 8}
  int* gpr;                // [W][32][T]
  unsigned* ipdom_pc;      // [W * D]
  unsigned* ipdom_mask;    // [W * D] lane bitmask
  int* bar_count;          // [NB]
  int* smem;               // [SW]
  unsigned char* ipdom_ft;     // [W * D]
  unsigned char* bar_release;  // [NB * W]
};

__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  size_t at = off;
  off += (bytes + 15) & ~size_t(15);
  return at;
}

// Byte offsets of the shared state; returns the total.  `s` may be null
// (the host sizes the launch with it).
__host__ __device__ inline size_t carve(const SimtParams& p, char* base,
                                        Shared* s) {
  const size_t W = p.W, T = p.T, D = p.D, NB = p.NB, SW = p.SW,
               sets = p.sets;
  size_t off = 0;
  size_t o[10];
  o[0] = take(off, 16 * size_t(p.imem_len));
  o[1] = take(off, 16 * W);
  o[2] = take(off, 16 * sets);
  o[3] = take(off, 4 * W * 32 * T);
  o[4] = take(off, 4 * W * D);
  o[5] = take(off, 4 * W * D);
  o[6] = take(off, 4 * NB);
  o[7] = take(off, 4 * SW);
  o[8] = take(off, W * D);
  o[9] = take(off, NB * W);
  if (s != nullptr) {
    s->code = reinterpret_cast<int4*>(base + o[0]);
    s->warp = reinterpret_cast<int4*>(base + o[1]);
    s->cache = reinterpret_cast<int4*>(base + o[2]);
    s->gpr = reinterpret_cast<int*>(base + o[3]);
    s->ipdom_pc = reinterpret_cast<unsigned*>(base + o[4]);
    s->ipdom_mask = reinterpret_cast<unsigned*>(base + o[5]);
    s->bar_count = reinterpret_cast<int*>(base + o[6]);
    s->smem = reinterpret_cast<int*>(base + o[7]);
    s->ipdom_ft = reinterpret_cast<unsigned char*>(base + o[8]);
    s->bar_release = reinterpret_cast<unsigned char*>(base + o[9]);
  }
  return off;
}

// ---------------------------------------------------------------------------
// decode (once per launch)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int4 decode(unsigned i, int T, int W) {
  const int opcode = i & 0x7F, rd = (i >> 7) & 31, f3 = (i >> 12) & 7,
            rs1 = (i >> 15) & 31, rs2 = (i >> 20) & 31,
            f7 = (i >> 25) & 0x7F;
  const int imm_i = static_cast<int>(i) >> 20;
  const int imm_s = static_cast<int>(
      static_cast<unsigned>(static_cast<int>(i & 0xFE000000u) >> 20)
      | ((i >> 7) & 31u));
  const int imm_b = static_cast<int>(
      static_cast<unsigned>(static_cast<int>(i & 0x80000000u) >> 19)
      | ((i & 0x80u) << 4) | ((i >> 20) & 0x7E0u) | ((i >> 7) & 0x1Eu));
  const int imm_u = static_cast<int>(i & 0xFFFFF000u);
  const int imm_j = static_cast<int>(
      static_cast<unsigned>(static_cast<int>(i & 0x80000000u) >> 11)
      | (i & 0xFF000u) | ((i >> 9) & 0x800u) | ((i >> 20) & 0x7FEu));
  int k = K_HALT, imm = 0;
  bool use_imm = false;
  switch (opcode) {
    case OP_LUI: k = K_CONST; imm = imm_u; break;
    case OP_AUIPC: k = K_AUIPC; imm = imm_u; break;
    case OP_JAL: k = K_JAL; imm = imm_j; break;
    case OP_JALR: k = K_JALR; imm = imm_i; break;
    case OP_BRANCH: {
      const int by_f3[8] = {K_BEQ, K_BNE, K_BEQ, K_BEQ,
                            K_BLT, K_BGE, K_BLTU, K_BGEU};
      k = by_f3[f3]; imm = imm_b;
      break;
    }
    case OP_LOAD: k = K_LOAD; imm = imm_i; break;
    case OP_STORE: k = K_STORE; imm = imm_s; break;
    case OP_IMM:
    case OP_OP: {
      const bool reg = opcode == OP_OP;
      const bool alt = reg ? f7 == 0x20 : f3 == 5 && ((imm_i >> 10) & 1);
      const int by_f3[8] = {alt ? K_SUB : K_ADD, K_SLL, K_SLT, K_SLTU,
                            K_XOR, alt ? K_SRA : K_SRL, K_OR, K_AND};
      k = reg && f7 == 1 ? K_MUL + f3 : by_f3[f3];
      imm = imm_i;
      use_imm = !reg;
      break;
    }
    case OP_SYSTEM:
      if (f3 == 0) {
        k = K_ECALL;
      } else {
        const int csr = imm_i & 0xFFF;
        k = csr == CSR_TID ? K_TID : csr == CSR_WID ? K_WID
            : csr == CSR_CYCLE ? K_CYCLE : K_CONST;
        imm = csr == CSR_NT ? T : csr == CSR_NW ? W : 0;
      }
      break;
    case OP_FP: k = K_FP; break;
    case OP_CUSTOM0: k = K_TMC + (f3 < 4 ? f3 : 4); imm = imm_b; break;
    default: break;   // fault: halt the warp (no runaway fetch)
  }
  const int row = 4 * T;    // bytes between a lane's registers
  return make_int4(k | f3 << 8 | f7 << 16 | int(use_imm) << 24, imm,
                   rs1 * row | rs2 * row << 16, rd * row);
}

// ---------------------------------------------------------------------------
// ALU groups (one lane)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int alu_m(int f3, int a, int b) {
  const unsigned ua = a, ub = b;
  const bool zero = b == 0, ovf = a == kIntMin && b == -1;
  switch (f3) {
    case 0: return static_cast<int>(ua * ub);
    case 1: return __mulhi(a, b);
    case 2:  // signed x unsigned: |a * ub| < 2^63
      return static_cast<int>(
          (static_cast<long long>(a) * static_cast<long long>(ub)) >> 32);
    case 3: return static_cast<int>(__umulhi(ua, ub));
    case 4: return zero ? -1 : ovf ? kIntMin : a / b;
    case 5: return zero ? -1 : static_cast<int>(ua / ub);
    case 6: return zero ? a : ovf ? 0 : a % b;
    default: return zero ? a : static_cast<int>(ua % ub);
  }
}

__device__ __forceinline__ bool is_nan(unsigned u) {
  return (u & 0x7F800000u) == 0x7F800000u && (u & 0x7FFFFFu) != 0;
}

// Denormal inputs read as zero of the same sign.
__device__ __forceinline__ unsigned daz(unsigned u) {
  return (u & 0x7F800000u) ? u : (u & 0x80000000u);
}

// A NaN result is `first` quieted if it is NaN, else `second` quieted if
// it is, else the default NaN (x86).
__device__ __forceinline__ unsigned nan_bits(unsigned res, unsigned first,
                                             unsigned second) {
  if (!is_nan(res)) return res;
  if (is_nan(first)) return first | 0x400000u;
  if (is_nan(second)) return second | 0x400000u;
  return 0xFFC00000u;
}

// The double result `p` rounded to float; flushed to signed zero when it
// is tiny after rounding to 24 bits with an unbounded exponent.
__device__ __forceinline__ unsigned round_ftz(double p) {
  const float t = __double2float_rn(__dmul_rn(p, 0x1p64));
  if (fabsf(t) < 0x1p-62f)
    return __double_as_longlong(p) < 0 ? 0x80000000u : 0u;
  return __float_as_uint(__double2float_rn(p));
}

__device__ __noinline__ int alu_fp(int f7, int f3, int a, int b) {
  const unsigned ua = a, ub = b;
  const float fa = __uint_as_float(daz(ua)), fb = __uint_as_float(daz(ub));
  const double da = fa, db = fb;
  switch (f7) {
    case 0x04:  // a + (-b): the NaN rule of add with b negated
      return nan_bits(round_ftz(__dsub_rn(da, db)), ub ^ 0x80000000u, ua);
    case 0x08: return nan_bits(round_ftz(__dmul_rn(da, db)), ub, ua);
    case 0x0C: return nan_bits(round_ftz(__ddiv_rn(da, db)), ua, ub);
    case 0x2C: return nan_bits(round_ftz(__dsqrt_rn(da)), ua, ua);
    case 0x14:
      if (f3 <= 1) {
        // LLVM's x86 minimum/maximum: order the operands by a's sign,
        // minss/maxss (the second operand on ties and NaN), then the
        // first ordered operand if it is NaN
        const bool neg = ua >> 31;
        const bool swap = f3 == 0 ? neg : !neg;
        const unsigned nx = swap ? ub : ua, ny = swap ? ua : ub;
        if (is_nan(nx)) return nx;
        const unsigned dx = daz(nx), dy = daz(ny);
        const float fx = __uint_as_float(dx), fy = __uint_as_float(dy);
        return (f3 == 0 ? fx < fy : fx > fy) ? dx : dy;
      }
      break;
    case 0x50:
      if (f3 == 0) return fa <= fb;
      if (f3 == 1) return fa < fb;
      if (f3 == 2) return fa == fb;
      break;
    case 0x60: {  // fcvt.w.s: truncate, saturate, NaN -> 0
      if (isnan(fa)) return 0;
      const float t = truncf(fa);
      if (t >= 2147483648.0f) return kIntMax;
      if (t <= -2147483648.0f) return kIntMin;
      return static_cast<int>(t);
    }
    case 0x68: return __float_as_uint(__int2float_rn(a));  // fcvt.s.w
    default: break;
  }
  return nan_bits(round_ftz(__dadd_rn(da, db)), ub, ua);
}

// Highest lane of `lanes` (non-empty).
__device__ __forceinline__ int top_lane(unsigned lanes) {
  return 31 - __clz(lanes);
}

// The most lanes of `mine` that share a value with a lane's `same`
// (its __match_any_sync), less one: the serialized extra accesses.
__device__ __forceinline__ int conflicts(bool in, unsigned same,
                                         unsigned mine) {
  return max(__reduce_max_sync(kFull, in ? __popc(same & mine) : 0) - 1, 0);
}

// ---------------------------------------------------------------------------
// sets of warps as bitmasks in registers.  Narrow (W <= 32): every lane
// holds the whole mask.  Wide (W <= 1024): lane k holds the word of warps
// 32k..32k+31.
// ---------------------------------------------------------------------------

template <bool kWide>
__device__ __forceinline__ bool any_of(unsigned m) {
  return kWide ? __any_sync(kFull, m != 0) : m != 0;
}

template <bool kWide>
__device__ __forceinline__ int count(unsigned m) {
  return kWide ? static_cast<int>(__reduce_add_sync(kFull, __popc(m)))
               : __popc(m);
}

// The lowest warp of a non-empty set.
template <bool kWide>
__device__ __forceinline__ int lowest(unsigned m) {
  if (!kWide) return __ffs(m) - 1;
  const int j = __ffs(__ballot_sync(kFull, m != 0)) - 1;
  return 32 * j + __ffs(__shfl_sync(kFull, m, j)) - 1;
}

// This lane's share of the set {w}.
template <bool kWide>
__device__ __forceinline__ unsigned only(int w, int lane) {
  if (!kWide) return 1u << w;
  return (w >> 5) == lane ? 1u << (w & 31) : 0u;
}

// Word j (warps 32j..32j+31) of the set, in every lane.
template <bool kWide>
__device__ __forceinline__ unsigned word(unsigned m, int j) {
  return kWide ? __shfl_sync(kFull, m, j) : m;
}

// This lane's share of the set whose word j is `bits` (every lane).
template <bool kWide>
__device__ __forceinline__ unsigned as_word(unsigned bits, int j,
                                            int lane) {
  return !kWide || lane == j ? bits : 0u;
}

// A set from per-warp flags: warp b + lane is in it when `flag` is true
// in that lane, for each chunk of 32 warps b.
template <bool kWide, typename F>
__device__ __forceinline__ unsigned gather(int W, int lane, F flag) {
  unsigned m = 0;
  for (int b = 0; b < (kWide ? W : 1); b += 32) {
    const int k = b + lane;
    m |= as_word<kWide>(__ballot_sync(kFull, k < W && flag(k)), b >> 5,
                        lane);
  }
  return m;
}

// Is warp k + lane, k a multiple of 32, in the set (per lane)?  A
// shuffle when wide: every lane calls it.
template <bool kWide>
__device__ __forceinline__ bool has(unsigned m, int k, int lane) {
  return (word<kWide>(m, k >> 5) >> lane) & 1u;
}

// The least stalled_until over the warps of `m` (kIntMax if none).
template <bool kWide>
__device__ __forceinline__ int least_stall(const Shared& s, unsigned m,
                                           int W, int lane) {
  int least = kIntMax;
  for (int b = 0; b < (kWide ? W : 1); b += 32) {
    const int k = b + lane;
    const bool in = has<kWide>(m, b, lane) && k < W;
    least = min(least, __reduce_min_sync(
        kFull, in ? s.warp[k].z : kIntMax));
  }
  return least;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <bool kWide, bool kPow2>
__global__ void __launch_bounds__(32, 1) simt_kernel(SimtParams p) {
  extern __shared__ __align__(16) char sh_raw[];
  Shared s;
  carve(p, sh_raw, &s);
  const int lane = threadIdx.x;
  const int W = p.W, T = p.T, D = p.D, NB = p.NB;
  const bool is_lane = lane < T;
  const unsigned lanes_T = T == 32 ? kFull : (1u << T) - 1;
  const unsigned imem_len = p.imem_len;
  const unsigned mw_mask = p.MW - 1, sw_mask = p.SW - 1;
  // this lane's GPR column: warp w's register r at + 128 T w + 4 T r
  char* const gpr_lane = reinterpret_cast<char*>(s.gpr) + 4 * lane;
  const int warp_bytes = 128 * T;

  // ---- state in -----------------------------------------------------------
  for (int i = lane; i < p.imem_len; i += 32)
    s.code[i] = decode(__ldg(&p.imem[i]), T, W);
  for (int i = lane; i < W * 32 * T; i += 32) {
    const int w = i / (32 * T), r = (i / T) % 32, t = i % T;
    s.gpr[i] = p.gpr[(w * T + t) * 32 + r];
  }
  for (int w = lane; w < W; w += 32) {
    unsigned m = 0;
    for (int t = 0; t < T; ++t) m |= (p.tmask[w * T + t] ? 1u : 0u) << t;
    s.warp[w] = make_int4(static_cast<int>(p.pc[w]), static_cast<int>(m),
                          p.stalled_until[w], p.ipdom_sp[w]);
  }
  for (int i = lane; i < W * D; i += 32) {
    s.ipdom_pc[i] = p.ipdom_pc[i];
    s.ipdom_ft[i] = p.ipdom_ft[i];
    unsigned m = 0;
    for (int t = 0; t < T; ++t)
      m |= (p.ipdom_mask[i * T + t] ? 1u : 0u) << t;
    s.ipdom_mask[i] = m;
  }
  for (int i = lane; i < NB; i += 32) s.bar_count[i] = p.bar_count[i];
  for (int i = lane; i < NB * W; i += 32) s.bar_release[i] = p.bar_release[i];
  for (int i = lane; i < p.SW; i += 32) s.smem[i] = p.smem[i];
  for (int i = lane; i < p.sets; i += 32)
    s.cache[i] = make_int4(p.tags[2 * i], p.tags[2 * i + 1], p.lru[i],
                           (p.tvalid[2 * i] ? 1 : 0)
                           | (p.tvalid[2 * i + 1] ? 1 << 8 : 0));
  unsigned act = gather<kWide>(W, lane, [&](int k) { return p.active[k]; });
  unsigned bar =
      gather<kWide>(W, lane, [&](int k) { return p.at_barrier[k]; });
  unsigned vis = gather<kWide>(W, lane, [&](int k) { return p.visible[k]; });
  unsigned stl = 0;        // stalled_until > cycle, valid below next_wake
  int next_wake = kIntMin;  // recompute `stl` on the first cycle
  // counters: the same value in every lane; unsigned, so sums wrap as
  // the JAX machine's int32 counters do
  unsigned st[kStats];
#pragma unroll
  for (int k = 0; k < kStats; ++k) st[k] = p.counters[k];
  int cycle = p.counters[kStats];
  int n_active = count<kWide>(act);
  __syncwarp();

  enum { INSTRS, STALL, IDLE, HITS, MISSES, BANK, DIV, UNI, JOINS, BARW,
         VIOL, LOADS, STORES, OCC, LANES, REFILLS };

  while (n_active > 0 && cycle < p.max_cycles) {
    // ---- scheduler: refill-if-empty, then the lowest visible warp -------
    unsigned ok = act & ~stl & ~bar;
    if (cycle >= next_wake || !any_of<kWide>(ok)) {
      if (cycle >= next_wake) {   // a stalled warp wakes
        stl = gather<kWide>(W, lane,
                            [&](int k) { return s.warp[k].z > cycle; });
        next_wake = least_stall<kWide>(s, stl, W, lane);
        ok = act & ~stl & ~bar;
      }
      if (!any_of<kWide>(ok)) {
        // idle until the first active warp not at a barrier wakes (all of
        // them are stalled); none: until max_cycles
        const int wake = least_stall<kWide>(s, act & ~bar, W, lane);
        const int to = min(wake, p.max_cycles);
        const unsigned k = static_cast<unsigned>(to - cycle);
        st[IDLE] += k;
        st[OCC] += k * static_cast<unsigned>(n_active);
        vis = 0;
        cycle = to;
        continue;
      }
    }
    const unsigned seen = vis & ok;
    const bool refilled = !any_of<kWide>(seen);
    const unsigned pick = refilled ? ok : seen;
    const int w = lowest<kWide>(pick);
    vis = pick & ~only<kWide>(w, lane);

    // ---- fetch (the decoded record), operands ----------------------------
    const int4 wr = s.warp[w];
    const unsigned pc = wr.x;
    const unsigned lanes = wr.y;
    unsigned at = pc >> 2;
    if (at >= imem_len) at %= imem_len;
    const int4 rec = s.code[at];
    const int op = rec.x & 0xFF, f3 = (rec.x >> 8) & 0xFF,
              f7 = (rec.x >> 16) & 0xFF;
    const int imm = rec.y;
    char* const row = gpr_lane + w * warp_bytes;
    const int rs1v =
        is_lane ? *reinterpret_cast<int*>(row + (rec.z & 0xFFFF)) : 0;
    const int rs2v = is_lane ? *reinterpret_cast<int*>(row + (rec.z >> 16))
                             : 0;
    const bool on = (lanes >> lane) & 1u;
    const int first = lanes ? __ffs(lanes) - 1 : 0;
    const unsigned pc4 = pc + 4;
    unsigned npc = pc4;
    bool wrd = true;    // this lane writes rd (if on and rd != 0)
    int val = 0;
    unsigned new_lanes = lanes;

    switch (op) {
      case K_CONST: val = imm; break;
      case K_AUIPC: val = static_cast<int>(pc + unsigned(imm)); break;
      case K_JAL: val = static_cast<int>(pc4); npc = pc + unsigned(imm);
        break;
      case K_JALR:
        val = static_cast<int>(pc4);
        npc = (unsigned(__shfl_sync(kFull, rs1v, first)) + unsigned(imm))
              & ~1u;
        break;
      case K_BEQ: case K_BNE: case K_BLT: case K_BGE: case K_BLTU:
      case K_BGEU: {
        const bool cmp =
            op == K_BEQ ? rs1v == rs2v : op == K_BNE ? rs1v != rs2v
            : op == K_BLT ? rs1v < rs2v : op == K_BGE ? rs1v >= rs2v
            : op == K_BLTU ? unsigned(rs1v) < unsigned(rs2v)
            : unsigned(rs1v) >= unsigned(rs2v);
        const unsigned taken = __ballot_sync(kFull, cmp);
        const bool take_b = (taken >> first) & 1u;
        st[VIOL] += ((take_b ? ~taken : taken) & lanes) != 0;
        npc = take_b ? pc + unsigned(imm) : pc4;
        wrd = false;
        break;
      }
      case K_LOAD:
      case K_STORE: {
        const bool store = op == K_STORE;
        const unsigned addr = unsigned(rs1v) + unsigned(imm);
        const bool is_sm = addr >= kSmemBase;
        const bool dm = on && !is_sm, smon = on && is_sm;
        const unsigned dm_b = __ballot_sync(kFull, dm);
        const unsigned sm_b = __ballot_sync(kFull, smon);
        const unsigned dword = addr >> 2;
        const unsigned sm_word = (addr - kSmemBase) >> 2;
        const unsigned widx = kPow2 ? dword & mw_mask : dword % unsigned(p.MW);
        const unsigned sidx =
            kPow2 ? sm_word & sw_mask : sm_word % unsigned(p.SW);
        const bool sub = (f3 & 3) < 2;    // a byte or halfword store
        int old = 0;                      // the word the lane reads
        if (on && (!store || sub))
          old = is_sm ? s.smem[sidx] : p.dmem[widx];
        int n_miss = 0, n_hit = 0, extra = 0, sm_extra = 0;
        int set = 0, tag = 0, fill_way = 0, used_way = 0;
        bool fill = false, flip = false;
        if (dm_b) {
          // data cache over the lanes that access dmem
          const int line = static_cast<int>(addr >> 4);
          set = line & (p.sets - 1);
          tag = line >> p.tag_shift;
          const int4 c = dm ? s.cache[set] : make_int4(0, 0, 0, 0);
          const bool wh0 = (c.w & 0xFF) && c.x == tag;
          const bool wh1 = (c.w >> 8) && c.y == tag;
          const bool hit = dm && (wh0 || wh1);
          fill_way = c.z;
          used_way = hit ? (wh0 ? 0 : 1) : fill_way;
          // a lane repeating an earlier dmem lane's line is not counted
          const unsigned dup_b = __ballot_sync(
              kFull, (__match_any_sync(kFull, line) & dm_b
                      & ((1u << lane) - 1u)) != 0);
          const unsigned hit_b = __ballot_sync(kFull, hit);
          const unsigned uniq_b = dm_b & ~dup_b;
          const unsigned fill_b = uniq_b & ~hit_b;
          const unsigned touch_b = hit_b | fill_b;
          n_miss = __popc(fill_b);
          n_hit = __popc(uniq_b & hit_b);
          // one unique line: one set, no bank conflict
          unsigned same_set = kFull;
          if (__popc(uniq_b) > 1) {
            same_set = __match_any_sync(kFull, set);
            // line-granular banks: serialized unique lines per bank
            extra = conflicts((uniq_b >> lane) & 1u,
                              __match_any_sync(kFull, line & (p.banks - 1)),
                              uniq_b);
          }
          // fills, then LRU flips: the highest lane of a set writes it
          fill = ((fill_b >> lane) & 1u)
                 && lane == top_lane(same_set & fill_b);
          flip = ((touch_b >> lane) & 1u)
                 && lane == top_lane(same_set & touch_b);
        }
        if (sm_b) {   // smem: word-granular banks
          if (__popc(sm_b) > 1)
            sm_extra = conflicts(
                smon, __match_any_sync(kFull, sm_word & unsigned(p.banks - 1)),
                sm_b);
        }
        // stores: every lane writes dmem[widx] and smem[sidx] (its new
        // word where it stores there, else the old one): the highest lane
        // of an index decides it
        unsigned same_w = 0, same_s = 0;
        if (store && dm_b) same_w = __match_any_sync(kFull, widx) & lanes_T;
        if (store && sm_b) same_s = __match_any_sync(kFull, sidx) & lanes_T;
        __syncwarp();   // every read of the cache and memory is done
        if (fill) {
          int* cw = reinterpret_cast<int*>(&s.cache[set]);
          cw[fill_way] = tag;
          reinterpret_cast<unsigned char*>(cw + 3)[fill_way] = 1;
        }
        if (flip) reinterpret_cast<int*>(&s.cache[set])[2] = 1 - used_way;
        const int stall = (n_miss > 0 ? p.miss_latency
                           + (n_miss - 1) * p.miss_pipeline : 0)
                          + extra + sm_extra;
        if (stall > 0) {
          const int until = static_cast<int>(static_cast<unsigned>(cycle)
                                             + 1u + unsigned(stall));
          s.warp[w].z = until;
          stl |= only<kWide>(w, lane);
          next_wake = min(next_wake, until);
        }
        st[MISSES] += n_miss;
        st[HITS] += n_hit;
        st[STALL] += stall;
        st[BANK] += extra + sm_extra;
        const unsigned sh = (addr & 3u) * 8;
        if (!store) {
          st[LOADS] += 1;
          const unsigned wd = static_cast<unsigned>(old);
          const unsigned b8 = (wd >> sh) & 0xFFu;
          const unsigned h16 = (wd >> (sh & ~8u)) & 0xFFFFu;
          val = f3 == 0 ? static_cast<signed char>(b8)
                : f3 == 1 ? static_cast<short>(h16)
                : f3 == 4 ? static_cast<int>(b8)
                : f3 == 5 ? static_cast<int>(h16) : old;
        } else {
          st[STORES] += 1;
          wrd = false;
          const unsigned bmask = !sub ? kFull
                                 : (f3 & 3) == 0 ? 0xFFu << sh
                                 : 0xFFFFu << sh;
          const int newv = static_cast<int>(
              (unsigned(old) & ~bmask) | ((unsigned(rs2v) << sh) & bmask));
          if (dm && lane == top_lane(same_w)) p.dmem[widx] = newv;
          if (smon && lane == top_lane(same_s)) s.smem[sidx] = newv;
        }
        __syncwarp();   // the writes are seen by the next instruction
        break;
      }
      case K_ADD: case K_SUB: case K_SLL: case K_SLT: case K_SLTU:
      case K_XOR: case K_SRL: case K_SRA: case K_OR: case K_AND: {
        const int b = (rec.x >> 24) ? imm : rs2v;
        const unsigned ua = rs1v, ub = b, sh = ub & 31;
        switch (op) {
          case K_ADD: val = static_cast<int>(ua + ub); break;
          case K_SUB: val = static_cast<int>(ua - ub); break;
          case K_SLL: val = static_cast<int>(ua << sh); break;
          case K_SLT: val = rs1v < b; break;
          case K_SLTU: val = ua < ub; break;
          case K_XOR: val = rs1v ^ b; break;
          case K_SRL: val = static_cast<int>(ua >> sh); break;
          case K_SRA: val = rs1v >> sh; break;
          case K_OR: val = rs1v | b; break;
          default: val = rs1v & b; break;
        }
        break;
      }
      case K_MUL: case K_MULH: case K_MULHSU: case K_MULHU: case K_DIV:
      case K_DIVU: case K_REM: case K_REMU:
        val = alu_m(op - K_MUL, rs1v, rs2v);
        break;
      case K_ECALL:     // warp exit
        wrd = false;
        act &= ~only<kWide>(w, lane);
        n_active -= 1;
        break;
      case K_TID: val = lane; break;
      case K_WID: val = w; break;
      case K_CYCLE: val = cycle; break;
      case K_FP: val = alu_fp(f7, f3, rs1v, rs2v); break;
      case K_TMC: {
        wrd = false;
        const int n = min(max(__shfl_sync(kFull, rs1v, first), 0), T);
        new_lanes = n == 32 ? kFull : (1u << n) - 1u;
        if (n == 0) {
          act &= ~only<kWide>(w, lane);
          n_active -= 1;
        }
        break;
      }
      case K_WSPAWN: {
        wrd = false;
        const int nw = min(max(__shfl_sync(kFull, rs1v, first), 0), W);
        const unsigned to = unsigned(__shfl_sync(kFull, rs2v, first));
        for (int b = 0; b < (kWide ? W : 1); b += 32) {
          const int k = b + lane;
          const bool spawn = !has<kWide>(act, b, lane) && k < nw && k != w;
          if (spawn) {
            s.warp[k].x = static_cast<int>(to);
            s.warp[k].y = 1;
          }
          act |= as_word<kWide>(__ballot_sync(kFull, spawn), b >> 5, lane);
        }
        n_active = count<kWide>(act);
        __syncwarp();   // the spawned warps' records are seen
        break;
      }
      case K_SPLIT: {
        // stack writes past the depth are dropped, reads clamp to it
        wrd = false;
        const unsigned pred = __ballot_sync(kFull, on && rs1v != 0);
        const unsigned ntaken = __ballot_sync(kFull, on && rs1v == 0);
        const bool any_t = pred != 0, divergent = any_t && ntaken != 0;
        const int sp = wr.w;
        const unsigned else_pc = pc + unsigned(imm);
        if (sp < D) {            // the fall-through entry
          s.ipdom_mask[w * D + sp] = lanes;
          s.ipdom_ft[w * D + sp] = 1;
          s.ipdom_pc[w * D + sp] = pc4;
        }
        if (any_t && sp + 1 < D) {   // the else entry
          s.ipdom_mask[w * D + sp + 1] = ntaken;
          s.ipdom_ft[w * D + sp + 1] = 0;
          s.ipdom_pc[w * D + sp + 1] = else_pc;
        }
        s.warp[w].w = sp + (any_t ? 2 : 1);
        new_lanes = any_t ? pred : lanes;
        npc = any_t ? pc4 : else_pc;
        st[DIV] += divergent;
        st[UNI] += !divergent;
        break;
      }
      case K_JOIN: {
        wrd = false;
        const int sp0 = wr.w;
        const int sp1 = max(sp0 - 1, 0), sp2 = max(sp0 - 2, 0);
        const int i1 = w * D + min(sp1, D - 1);
        const int i2 = w * D + min(sp2, D - 1);
        const unsigned top_mask = s.ipdom_mask[i1];
        const bool top_ft = s.ipdom_ft[i1];
        const unsigned top_pc = s.ipdom_pc[i1];
        const bool top_empty = top_mask == 0 && !top_ft;
        int new_sp;
        if (sp0 == 0) {
          new_sp = 0;
        } else if (top_empty) {
          new_sp = sp2; new_lanes = s.ipdom_mask[i2];
          npc = pc + unsigned(imm);
        } else {
          new_sp = sp1; new_lanes = top_mask; npc = top_ft ? pc4 : top_pc;
        }
        s.warp[w].w = new_sp;
        st[JOINS] += 1;
        break;
      }
      case K_BAR: {
        wrd = false;
        const int bid = __shfl_sync(kFull, rs1v, first) & (NB - 1);
        const int need = __shfl_sync(kFull, rs2v, first);
        const int cnt = static_cast<int>(unsigned(s.bar_count[bid]) + 1u);
        const bool done = cnt >= need;
        unsigned char* rel = s.bar_release + bid * W;
        if (done) {
          for (int b = 0; b < (kWide ? W : 1); b += 32) {
            const int k = b + lane;
            const bool go = k < W && (rel[k] || k == w);
            if (k < W) rel[k] = 0;
            bar &= ~as_word<kWide>(__ballot_sync(kFull, go), b >> 5, lane);
          }
          s.bar_count[bid] = 0;
        } else {
          bar |= only<kWide>(w, lane);
          rel[w] = 1;
          s.bar_count[bid] = cnt;
        }
        st[BARW] += !done;
        __syncwarp();   // the release flags are seen
        break;
      }
      default:    // K_HALT, a fault: halt the warp (no runaway fetch)
        wrd = false;
        act &= ~only<kWide>(w, lane);
        n_active -= 1;
        break;
    }
    if (wrd && on && rec.w != 0) *reinterpret_cast<int*>(row + rec.w) = val;
    s.warp[w].x = static_cast<int>(npc);
    s.warp[w].y = static_cast<int>(new_lanes);
    st[INSTRS] += 1;
    st[OCC] += n_active;
    st[LANES] += __popc(lanes);
    st[REFILLS] += refilled;
    cycle += 1;
  }

  // ---- state out ----------------------------------------------------------
  __syncwarp();
  for (int i = lane; i < W * 32 * T; i += 32) {
    const int w = i / (32 * T), r = (i / T) % 32, t = i % T;
    p.gpr[(w * T + t) * 32 + r] = s.gpr[i];
  }
  for (int b = 0; b < (kWide ? W : 1); b += 32) {
    const int w = b + lane;
    const bool a = has<kWide>(act, b, lane), br = has<kWide>(bar, b, lane),
               v = has<kWide>(vis, b, lane);
    if (w >= W) continue;
    const int4 r = s.warp[w];
    p.pc[w] = static_cast<unsigned>(r.x);
    p.stalled_until[w] = r.z;
    p.ipdom_sp[w] = r.w;
    p.active[w] = a;
    p.at_barrier[w] = br;
    p.visible[w] = v;
    for (int t = 0; t < T; ++t)
      p.tmask[w * T + t] = (static_cast<unsigned>(r.y) >> t) & 1u;
  }
  for (int i = lane; i < W * D; i += 32) {
    p.ipdom_pc[i] = s.ipdom_pc[i];
    p.ipdom_ft[i] = s.ipdom_ft[i];
    for (int t = 0; t < T; ++t)
      p.ipdom_mask[i * T + t] = (s.ipdom_mask[i] >> t) & 1u;
  }
  for (int i = lane; i < NB; i += 32) p.bar_count[i] = s.bar_count[i];
  for (int i = lane; i < NB * W; i += 32) p.bar_release[i] = s.bar_release[i];
  for (int i = lane; i < p.SW; i += 32) p.smem[i] = s.smem[i];
  for (int i = lane; i < p.sets; i += 32) {
    const int4 c = s.cache[i];
    p.tags[2 * i] = c.x;
    p.tags[2 * i + 1] = c.y;
    p.lru[i] = c.z;
    p.tvalid[2 * i] = c.w & 0xFF;
    p.tvalid[2 * i + 1] = c.w >> 8;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kStats; ++k) p.counters[k] = static_cast<int>(st[k]);
    p.counters[kStats] = cycle;
  }
}

}  // namespace

// Shared memory one launch of `p` needs, in bytes: the state and the
// decoded program.
extern "C" int simt_smem_bytes(const SimtParams* p) {
  return static_cast<int>(carve(*p, nullptr, nullptr));
}

// Runs the machine of `p` to completion on `stream`: one block of one
// warp.  Returns cudaGetLastError() after the launch, or -1 when the
// state and program do not fit in a block's shared memory (ops.py checks
// T and W).
extern "C" int simt_run(const SimtParams* p, void* stream) {
  const size_t bytes = carve(*p, nullptr, nullptr);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (bytes > size_t(optin)) return -1;
  if (p->T < 1 || p->T > 32 || p->W < 1 || p->W > kMaxWarps ||
      p->imem_len < 1)
    return cudaErrorInvalidValue;
  const bool pow2 = (p->MW & (p->MW - 1)) == 0 && (p->SW & (p->SW - 1)) == 0;
  const auto kernel =
      p->W > 32 ? (pow2 ? simt_kernel<true, true> : simt_kernel<true, false>)
                : (pow2 ? simt_kernel<false, true> : simt_kernel<false, false>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<1, 32, bytes, static_cast<cudaStream_t>(stream)>>>(*p);
  return cudaGetLastError();
}
