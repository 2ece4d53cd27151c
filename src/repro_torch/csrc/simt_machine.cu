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
// interpreter, one simulated cycle after another, each a few hundred
// dependent instructions on a few hundred bytes of state; its yardstick
// is time per simulated cycle.  So the design keeps every access of the
// loop on chip and out of the way of a second launch:
//   * one thread block of one CUDA warp per machine.  CUDA lane t is
//     Vortex lane t of whichever warp issues (T <= 32); warp-uniform
//     values (decode, the scheduler's pick, the first active lane's
//     operands) are computed by every lane or moved with __shfl_sync,
//     the per-warp masks are ballots;
//   * all state but dmem in shared memory: GPRs [W][32][T] (lane t reads
//     word t, no bank conflicts), IPDOM stacks and thread masks as lane
//     bitmasks, barriers, smem, cache tags and LRU.  dmem (64 Ki words)
//     stays in global memory, read through L1;
//   * the counters and the cycle in registers, written back once.
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
constexpr int kStats = 16;  // machine.STAT_KEYS, then the cycle

// opcodes and CSRs (core/simt/isa.py)
constexpr int OP_LUI = 0x37, OP_AUIPC = 0x17, OP_JAL = 0x6F, OP_JALR = 0x67,
              OP_BRANCH = 0x63, OP_LOAD = 0x03, OP_STORE = 0x23,
              OP_IMM = 0x13, OP_OP = 0x33, OP_SYSTEM = 0x73, OP_FP = 0x53,
              OP_CUSTOM0 = 0x0B;
constexpr int CSR_TID = 0xCC0, CSR_WID = 0xCC1, CSR_NT = 0xCC2,
              CSR_NW = 0xCC3, CSR_CYCLE = 0xB00;

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
  int* gpr;                // [W][32][T]
  unsigned* pc;            // [W]
  int* stalled_until;      // [W]
  int* ipdom_sp;           // [W]
  unsigned* tmask;         // [W] lane bitmask
  unsigned* ipdom_pc;      // [W * D]
  unsigned* ipdom_mask;    // [W * D] lane bitmask
  int* bar_count;          // [NB]
  int* smem;               // [SW]
  int* tags;               // [sets * 2]
  int* lru;                // [sets]
  unsigned char* active;   // [W]
  unsigned char* at_barrier;
  unsigned char* visible;
  unsigned char* ipdom_ft;     // [W * D]
  unsigned char* bar_release;  // [NB * W]
  unsigned char* tvalid;       // [sets * 2]
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
  size_t o[17];
  o[0] = take(off, 4 * W * 32 * T);
  o[1] = take(off, 4 * W);
  o[2] = take(off, 4 * W);
  o[3] = take(off, 4 * W);
  o[4] = take(off, 4 * W);
  o[5] = take(off, 4 * W * D);
  o[6] = take(off, 4 * W * D);
  o[7] = take(off, 4 * NB);
  o[8] = take(off, 4 * SW);
  o[9] = take(off, 4 * sets * 2);
  o[10] = take(off, 4 * sets);
  o[11] = take(off, W);
  o[12] = take(off, W);
  o[13] = take(off, W);
  o[14] = take(off, W * D);
  o[15] = take(off, NB * W);
  o[16] = take(off, sets * 2);
  if (s != nullptr) {
    s->gpr = reinterpret_cast<int*>(base + o[0]);
    s->pc = reinterpret_cast<unsigned*>(base + o[1]);
    s->stalled_until = reinterpret_cast<int*>(base + o[2]);
    s->ipdom_sp = reinterpret_cast<int*>(base + o[3]);
    s->tmask = reinterpret_cast<unsigned*>(base + o[4]);
    s->ipdom_pc = reinterpret_cast<unsigned*>(base + o[5]);
    s->ipdom_mask = reinterpret_cast<unsigned*>(base + o[6]);
    s->bar_count = reinterpret_cast<int*>(base + o[7]);
    s->smem = reinterpret_cast<int*>(base + o[8]);
    s->tags = reinterpret_cast<int*>(base + o[9]);
    s->lru = reinterpret_cast<int*>(base + o[10]);
    s->active = reinterpret_cast<unsigned char*>(base + o[11]);
    s->at_barrier = reinterpret_cast<unsigned char*>(base + o[12]);
    s->visible = reinterpret_cast<unsigned char*>(base + o[13]);
    s->ipdom_ft = reinterpret_cast<unsigned char*>(base + o[14]);
    s->bar_release = reinterpret_cast<unsigned char*>(base + o[15]);
    s->tvalid = reinterpret_cast<unsigned char*>(base + o[16]);
  }
  return off;
}

// ---------------------------------------------------------------------------
// ALU groups (one lane)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int alu_int(int f3, bool alt, int a, int b) {
  const unsigned ua = a, ub = b, sh = ub & 31;
  switch (f3) {
    case 0: return static_cast<int>(alt ? ua - ub : ua + ub);
    case 1: return static_cast<int>(ua << sh);
    case 2: return a < b;
    case 3: return ua < ub;
    case 4: return a ^ b;
    case 5: return alt ? (a >> sh) : static_cast<int>(ua >> sh);
    case 6: return a | b;
    default: return a & b;
  }
}

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

__device__ __forceinline__ int count_active(const Shared& s, int W,
                                            int lane) {
  int n = 0;
  for (int b = 0; b < W; b += 32) {
    const int w = b + lane;
    n += __popc(__ballot_sync(kFull, w < W && s.active[w]));
  }
  return n;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32, 1) simt_kernel(SimtParams p) {
  extern __shared__ __align__(16) char sh_raw[];
  Shared s;
  carve(p, sh_raw, &s);
  const int lane = threadIdx.x;
  const int W = p.W, T = p.T, D = p.D, NB = p.NB;
  const bool is_lane = lane < T;
  const unsigned lanes_T = T == 32 ? kFull : (1u << T) - 1;

  // ---- state in -----------------------------------------------------------
  for (int i = lane; i < W * 32 * T; i += 32) {
    const int w = i / (32 * T), r = (i / T) % 32, t = i % T;
    s.gpr[i] = p.gpr[(w * T + t) * 32 + r];
  }
  for (int w = lane; w < W; w += 32) {
    s.pc[w] = p.pc[w];
    s.stalled_until[w] = p.stalled_until[w];
    s.ipdom_sp[w] = p.ipdom_sp[w];
    s.active[w] = p.active[w];
    s.at_barrier[w] = p.at_barrier[w];
    s.visible[w] = p.visible[w];
    unsigned m = 0;
    for (int t = 0; t < T; ++t) m |= (p.tmask[w * T + t] ? 1u : 0u) << t;
    s.tmask[w] = m;
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
  for (int i = lane; i < 2 * p.sets; i += 32) {
    s.tags[i] = p.tags[i];
    s.tvalid[i] = p.tvalid[i];
  }
  for (int i = lane; i < p.sets; i += 32) s.lru[i] = p.lru[i];
  // counters: the same value in every lane; unsigned, so sums wrap as
  // the JAX machine's int32 counters do
  unsigned st[kStats];
#pragma unroll
  for (int k = 0; k < kStats; ++k) st[k] = p.counters[k];
  int cycle = p.counters[kStats];
  __syncwarp();

  enum { INSTRS, STALL, IDLE, HITS, MISSES, BANK, DIV, UNI, JOINS, BARW,
         VIOL, LOADS, STORES, OCC, LANES, REFILLS };

  int n_active = count_active(s, W, lane);
  while (n_active > 0 && cycle < p.max_cycles) {
    // ---- scheduler: refill-if-empty, then the lowest visible warp -------
    bool any_vis = false, any_ok = false;
    for (int b = 0; b < W; b += 32) {
      const int w = b + lane;
      const bool ok = w < W && s.active[w] && !(s.stalled_until[w] > cycle)
                      && !s.at_barrier[w];
      const bool vis = w < W && s.visible[w];
      any_vis |= __any_sync(kFull, vis && ok);
      any_ok |= __any_sync(kFull, ok);
    }
    const bool refilled = !any_vis && any_ok;
    int wid = W;
    for (int b = 0; b < W; b += 32) {
      const int w = b + lane;
      const bool ok = w < W && s.active[w] && !(s.stalled_until[w] > cycle)
                      && !s.at_barrier[w];
      const bool nv = any_vis ? (w < W && s.visible[w] && ok) : ok;
      const unsigned bal = __ballot_sync(kFull, nv);
      if (wid == W && bal) wid = b + __ffs(bal) - 1;
      if (w < W) s.visible[w] = nv;
    }
    __syncwarp();
    if (lane == 0 && wid < W) s.visible[wid] = 0;

    const bool issued = wid < W;
    unsigned lanes = 0;
    if (!issued) {
      st[IDLE] += 1;
    } else {
      const int w = wid;
      const unsigned pc = s.pc[w];
      const unsigned i = __ldg(&p.imem[(pc >> 2) % unsigned(p.imem_len)]);
      // ---- decode (every lane; warp-uniform) ----
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

      lanes = s.tmask[w];
      const bool on = (lanes >> lane) & 1u;
      const int rs1v = is_lane ? s.gpr[(w * 32 + rs1) * T + lane] : 0;
      const int rs2v = is_lane ? s.gpr[(w * 32 + rs2) * T + lane] : 0;
      const int first = lanes ? __ffs(lanes) - 1 : 0;
      const int rs1_u = __shfl_sync(kFull, rs1v, first);
      const int rs2_u = __shfl_sync(kFull, rs2v, first);
      const unsigned pc4 = pc + 4;
      unsigned npc = pc4;
      bool wrd = false;   // this lane writes rd (if on and rd != 0)
      int val = 0;
      __syncwarp();       // every lane has read pc, tmask and its GPRs

      switch (opcode) {
        case OP_LUI: wrd = true; val = imm_u; break;
        case OP_AUIPC:
          wrd = true; val = static_cast<int>(pc + unsigned(imm_u)); break;
        case OP_JAL:
          wrd = true; val = static_cast<int>(pc4); npc = pc + unsigned(imm_j);
          break;
        case OP_JALR:
          wrd = true; val = static_cast<int>(pc4);
          npc = (unsigned(rs1_u) + unsigned(imm_i)) & ~1u;
          break;
        case OP_BRANCH: {
          const bool eq = rs1v == rs2v, lt = rs1v < rs2v,
                     ltu = unsigned(rs1v) < unsigned(rs2v);
          bool cmp;
          switch (f3) {
            case 1: cmp = !eq; break;
            case 4: cmp = lt; break;
            case 5: cmp = !lt; break;
            case 6: cmp = ltu; break;
            case 7: cmp = !ltu; break;
            default: cmp = eq; break;
          }
          const bool take_b = __shfl_sync(kFull, cmp, first);
          const unsigned viol = __ballot_sync(kFull, cmp != take_b && on);
          st[VIOL] += viol != 0;
          npc = take_b ? pc + unsigned(imm_b) : pc4;
          break;
        }
        case OP_LOAD:
        case OP_STORE: {
          const bool store = opcode == OP_STORE;
          const unsigned addr =
              unsigned(rs1v) + unsigned(store ? imm_s : imm_i);
          const bool is_sm = addr >= kSmemBase;
          // data cache over the lanes that access dmem
          const bool dm = on && !is_sm;
          const int line = static_cast<int>(addr >> 4);
          const int set = line & (p.sets - 1);
          const int tag = line >> p.tag_shift;
          bool wh0 = false, wh1 = false;
          int fill_way = 0;
          if (is_lane) {
            wh0 = s.tvalid[2 * set] && s.tags[2 * set] == tag;
            wh1 = s.tvalid[2 * set + 1] && s.tags[2 * set + 1] == tag;
            fill_way = s.lru[set];
          }
          const bool hit = (wh0 || wh1) && dm, miss = dm && !hit;
          const unsigned dm_b = __ballot_sync(kFull, dm);
          // a lane repeating an earlier dmem lane's line is not counted
          const bool dup = (__match_any_sync(kFull, line) & dm_b
                            & ((1u << lane) - 1u)) != 0;
          const bool uniq_miss = miss && !dup, uniq = dm && !dup;
          const int n_miss = __popc(__ballot_sync(kFull, uniq_miss));
          const int n_hit = __popc(__ballot_sync(kFull, hit && !dup));
          const int used_way = hit ? (wh0 ? 0 : 1) : fill_way;
          const bool touched = hit || uniq_miss;
          const unsigned same_set = __match_any_sync(kFull, set);
          const unsigned fill_b = __ballot_sync(kFull, uniq_miss);
          const unsigned touch_b = __ballot_sync(kFull, touched);
          // line-granular banks: serialized unique lines per bank
          const unsigned uniq_b = __ballot_sync(kFull, uniq);
          const unsigned same_bank =
              __match_any_sync(kFull, line & (p.banks - 1));
          const int extra = max(__reduce_max_sync(
              kFull, uniq ? __popc(same_bank & uniq_b) : 0) - 1, 0);
          // smem: word-granular banks
          const unsigned sm_word = (addr - kSmemBase) >> 2;
          const bool smon = on && is_sm;
          const unsigned sm_b = __ballot_sync(kFull, smon);
          const unsigned same_smb = __match_any_sync(
              kFull, sm_word & unsigned(p.banks - 1));
          const int sm_extra = max(__reduce_max_sync(
              kFull, smon ? __popc(same_smb & sm_b) : 0) - 1, 0);
          const int stall = (n_miss > 0 ? p.miss_latency
                             + (n_miss - 1) * p.miss_pipeline : 0)
                            + extra + sm_extra;
          const unsigned widx = (addr >> 2) % unsigned(p.MW);
          const unsigned sidx = sm_word % unsigned(p.SW);
          const int old_d = is_lane ? p.dmem[widx] : 0;
          const int old_s = is_lane ? s.smem[sidx] : 0;
          __syncwarp();   // every read of the cache and memory is done
          // fills, then LRU flips: the highest lane of a set writes it
          if (uniq_miss && lane == top_lane(same_set & fill_b)) {
            s.tags[2 * set + fill_way] = tag;
            s.tvalid[2 * set + fill_way] = 1;
          }
          if (touched && lane == top_lane(same_set & touch_b))
            s.lru[set] = 1 - used_way;
          if (lane == 0 && stall > 0) s.stalled_until[w] = cycle + 1 + stall;
          st[MISSES] += n_miss;
          st[HITS] += n_hit;
          st[STALL] += stall;
          st[BANK] += extra + sm_extra;
          if (store) st[STORES] += 1; else st[LOADS] += 1;
          const unsigned word = unsigned(is_sm ? old_s : old_d);
          const unsigned sh = (addr & 3u) * 8;
          if (!store) {
            const unsigned b8 = (word >> sh) & 0xFFu;
            const unsigned h16 = (word >> (sh & ~8u)) & 0xFFFFu;
            wrd = true;
            switch (f3) {
              case 0: val = static_cast<signed char>(b8); break;
              case 1: val = static_cast<short>(h16); break;
              case 4: val = b8; break;
              case 5: val = h16; break;
              default: val = static_cast<int>(word); break;
            }
          } else {
            const int f = f3 % 4;
            const unsigned bmask = f == 0 ? 0xFFu << sh
                                   : f == 1 ? 0xFFFFu << sh : kFull;
            const unsigned newv =
                (word & ~bmask) | ((unsigned(rs2v) << sh) & bmask);
            // every lane writes dmem[widx] and smem[sidx] (its new word
            // where it stores there, else the old one): the highest lane
            // of an index decides it
            const unsigned same_w =
                __match_any_sync(kFull, widx) & lanes_T;
            const unsigned same_s =
                __match_any_sync(kFull, sidx) & lanes_T;
            if (is_lane && on && !is_sm && lane == top_lane(same_w))
              p.dmem[widx] = static_cast<int>(newv);
            if (is_lane && on && is_sm && lane == top_lane(same_s))
              s.smem[sidx] = static_cast<int>(newv);
          }
          break;
        }
        case OP_IMM:
          wrd = true;
          val = alu_int(f3, f3 == 5 && ((imm_i >> 10) & 1), rs1v, imm_i);
          break;
        case OP_OP:
          wrd = true;
          val = f7 == 1 ? alu_m(f3, rs1v, rs2v)
                        : alu_int(f3, f7 == 0x20, rs1v, rs2v);
          break;
        case OP_SYSTEM:
          if (f3 == 0) {               // ecall = warp exit
            if (lane == 0) s.active[w] = 0;
          } else {
            const int csr = imm_i & 0xFFF;
            wrd = true;
            val = csr == CSR_TID ? lane : csr == CSR_WID ? w
                  : csr == CSR_NT ? T : csr == CSR_NW ? W
                  : csr == CSR_CYCLE ? cycle : 0;
          }
          break;
        case OP_FP:
          wrd = true;
          val = alu_fp(f7, f3, rs1v, rs2v);
          break;
        case OP_CUSTOM0: {
          const int fv = f3 < 4 ? f3 : 4;
          if (fv == 0) {                                    // tmc
            const int n = min(max(rs1_u, 0), T);
            if (lane == 0) {
              s.tmask[w] = n == 32 ? kFull : (1u << n) - 1u;
              if (n == 0) s.active[w] = 0;
            }
          } else if (fv == 1) {                             // wspawn
            const int nw = min(max(rs1_u, 0), W);
            for (int k = lane; k < W; k += 32) {
              if (k < nw && !s.active[k] && k != w) {
                s.active[k] = 1;
                s.pc[k] = unsigned(rs2_u);
                s.tmask[k] = 1u;
              }
            }
          } else if (fv == 2) {                             // split
            // stack writes past the depth are dropped, reads clamp to it
            const unsigned pred = __ballot_sync(kFull, on && rs1v != 0);
            const unsigned ntaken = __ballot_sync(kFull, on && rs1v == 0);
            const bool any_t = pred != 0, divergent = any_t && ntaken != 0;
            const int sp = s.ipdom_sp[w];
            const unsigned else_pc = pc + unsigned(imm_b);
            __syncwarp();
            if (lane == 0) {
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
              s.ipdom_sp[w] = sp + (any_t ? 2 : 1);
              s.tmask[w] = any_t ? pred : lanes;
            }
            npc = any_t ? pc4 : else_pc;
            st[DIV] += divergent;
            st[UNI] += !divergent;
          } else if (fv == 3) {                             // join
            const int sp0 = s.ipdom_sp[w];
            const int sp1 = max(sp0 - 1, 0), sp2 = max(sp0 - 2, 0);
            const int i1 = w * D + min(sp1, D - 1);
            const int i2 = w * D + min(sp2, D - 1);
            const unsigned top_mask = s.ipdom_mask[i1];
            const bool top_ft = s.ipdom_ft[i1];
            const unsigned top_pc = s.ipdom_pc[i1];
            const bool top_empty = top_mask == 0 && !top_ft;
            const unsigned ft_mask = s.ipdom_mask[i2];
            int new_sp;
            unsigned new_mask;
            if (sp0 == 0) {
              new_sp = 0; new_mask = lanes; npc = pc4;
            } else if (top_empty) {
              new_sp = sp2; new_mask = ft_mask; npc = pc + unsigned(imm_b);
            } else {
              new_sp = sp1; new_mask = top_mask; npc = top_ft ? pc4 : top_pc;
            }
            __syncwarp();
            if (lane == 0) {
              s.ipdom_sp[w] = new_sp;
              s.tmask[w] = new_mask;
            }
            st[JOINS] += 1;
          } else {                                          // bar
            const int bid = rs1_u & (NB - 1);
            const int cnt =
                static_cast<int>(unsigned(s.bar_count[bid]) + 1u);
            const bool done = cnt >= rs2_u;
            __syncwarp();
            if (done) {
              for (int k = lane; k < W; k += 32) {
                if (s.bar_release[bid * W + k] || k == w)
                  s.at_barrier[k] = 0;
                s.bar_release[bid * W + k] = 0;
              }
              if (lane == 0) s.bar_count[bid] = 0;
            } else if (lane == 0) {
              s.at_barrier[w] = 1;
              s.bar_release[bid * W + w] = 1;
              s.bar_count[bid] = cnt;
            }
            st[BARW] += !done;
          }
          break;
        }
        default:   // fault: halt the warp (no runaway fetch)
          if (lane == 0) s.active[w] = 0;
          break;
      }
      if (wrd && on && rd != 0) s.gpr[(w * 32 + rd) * T + lane] = val;
      if (lane == 0) s.pc[w] = npc;
    }
    __syncwarp();
    n_active = count_active(s, W, lane);
    st[INSTRS] += issued;
    st[OCC] += n_active;
    st[LANES] += issued ? __popc(lanes) : 0;
    st[REFILLS] += refilled;
    cycle += 1;
    __syncwarp();
  }

  // ---- state out ----------------------------------------------------------
  for (int i = lane; i < W * 32 * T; i += 32) {
    const int w = i / (32 * T), r = (i / T) % 32, t = i % T;
    p.gpr[(w * T + t) * 32 + r] = s.gpr[i];
  }
  for (int w = lane; w < W; w += 32) {
    p.pc[w] = s.pc[w];
    p.stalled_until[w] = s.stalled_until[w];
    p.ipdom_sp[w] = s.ipdom_sp[w];
    p.active[w] = s.active[w];
    p.at_barrier[w] = s.at_barrier[w];
    p.visible[w] = s.visible[w];
    for (int t = 0; t < T; ++t) p.tmask[w * T + t] = (s.tmask[w] >> t) & 1u;
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
  for (int i = lane; i < 2 * p.sets; i += 32) {
    p.tags[i] = s.tags[i];
    p.tvalid[i] = s.tvalid[i];
  }
  for (int i = lane; i < p.sets; i += 32) p.lru[i] = s.lru[i];
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kStats; ++k) p.counters[k] = static_cast<int>(st[k]);
    p.counters[kStats] = cycle;
  }
}

}  // namespace

// Shared memory one launch of `p` needs, in bytes.
extern "C" int simt_smem_bytes(const SimtParams* p) {
  return static_cast<int>(carve(*p, nullptr, nullptr));
}

// Runs the machine of `p` to completion on `stream`: one block of one
// warp.  Returns cudaGetLastError() after the launch, or -1 when the
// state does not fit in a block's shared memory (ops.py checks T).
extern "C" int simt_run(const SimtParams* p, void* stream) {
  const size_t bytes = carve(*p, nullptr, nullptr);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (bytes > size_t(optin)) return -1;
  if (p->T < 1 || p->T > 32) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(simt_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  simt_kernel<<<1, 32, bytes, static_cast<cudaStream_t>(stream)>>>(*p);
  return cudaGetLastError();
}
