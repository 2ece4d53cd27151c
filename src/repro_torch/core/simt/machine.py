"""simX in PyTorch: the cycle-level SIMT machine of ``repro.core.simt``.

The same Vortex microarchitecture as the JAX machine (§IV): the 4-mask
warp scheduler (scheduler.py), per-warp thread masks predicating every
register and memory write, per-warp IPDOM stacks driving split/join,
the barrier table, the RV32IM + Zfinx execute stage over the T lanes,
and the banked 2-way data-cache latency model.  It reproduces the JAX
machine exactly: every counter, register and word of memory.

Two implementations of one cycle loop:

* ``run_plain``: a plain PyTorch loop, one ``step`` per cycle.  Per-lane
  work is tensor ops; warp-uniform values (the scheduler's pick, the
  fetched instruction, its decode) are read to the host, which branches
  on the instruction group as the JAX ``lax.switch`` selects its
  handler.  It runs on the tensors' device; ``run`` takes it for CPU
  tensors only.
* the CUDA kernel ``csrc/simt_machine.cu`` (``kernels/simt_machine``):
  one launch runs the whole loop on the card, as ``_run_jit``'s
  ``lax.while_loop`` runs it in one XLA program.  ``run`` launches it
  for CUDA tensors, or raises.

Where the JAX machine's results rest on how XLA executes on the CPU,
both implementations say so explicitly instead of inheriting their
device's habits:

* floats: denormal inputs and results are flushed to signed zero, with
  x86's tininess after rounding; NaN results take x86's operand order
  (add, sub and mul the second operand first, div the first) and its
  default NaN 0xFFC00000; fmin/fmax follow LLVM's x86 lowering of
  ``minimum``/``maximum``; fcvt.w.s saturates with NaN -> 0.  The
  arithmetic is done in float64 and rounded once to float32, which is
  the correctly rounded float32 result for +, -, *, / and sqrt.
* scatters with repeated indices resolve last-wins in lane order
  (stores, cache fills, LRU flips): the plain loop writes only each
  index's highest writing lane, never an ``index_put_`` with repeated
  indices.
* unsigned arithmetic is done in int64 masked to 32 bits; 32-bit fields
  that JAX keeps as uint32 (``pc``, ``ipdom_pc``) are int64 tensors
  holding values in [0, 2**32).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.simt import isa, scheduler
from repro_torch.device import DeviceLike, resolve_device
# leaf obs modules only; both are off by default, one attribute read on
# the fast path
from repro_torch.obs.flight import flight as _flight
from repro_torch.obs.tracing import tracer as _tracer

SMEM_BASE = 0x1000_0000     # shared-memory window
M32 = 0xFFFF_FFFF
I32, I64 = torch.int32, torch.int64


@dataclasses.dataclass(frozen=True)
class MachineConfig:
    warps: int = 8
    threads: int = 4
    ipdom_depth: int = 16
    barriers: int = 4
    dmem_words: int = 1 << 16          # 256 KB data memory
    smem_words: int = 2 << 10          # 8 KB shared memory (paper config)
    # cache geometry: 4 KB, 2-way, 4 banks, 16 B lines (paper config)
    cache_lines: int = 256             # total lines
    cache_ways: int = 2
    cache_banks: int = 4
    line_words: int = 4
    miss_latency: int = 48             # cycles to HBM-ish memory
    miss_pipeline: int = 4             # extra per additional missing line
    max_cycles: int = 2_000_000

    @property
    def sets(self) -> int:
        return self.cache_lines // self.cache_ways

    @property
    def tag_shift(self) -> int:
        return int(np.log2(self.sets))


class State(NamedTuple):
    pc: torch.Tensor              # [W] int64 (u32 values)
    active: torch.Tensor          # [W] bool
    stalled_until: torch.Tensor   # [W] int32 (cycle when schedulable again)
    at_barrier: torch.Tensor      # [W] bool
    visible: torch.Tensor         # [W] bool
    tmask: torch.Tensor           # [W,T] bool
    gpr: torch.Tensor             # [W,T,32] int32
    ipdom_pc: torch.Tensor        # [W,D] int64 (u32 values)
    ipdom_mask: torch.Tensor      # [W,D,T] bool
    ipdom_ft: torch.Tensor        # [W,D] bool
    ipdom_sp: torch.Tensor        # [W] int32
    bar_count: torch.Tensor       # [NB] int32
    bar_release: torch.Tensor     # [NB,W] bool
    dmem: torch.Tensor            # [MW] int32
    smem: torch.Tensor            # [SW] int32
    tags: torch.Tensor            # [sets,ways] int32
    tvalid: torch.Tensor          # [sets,ways] bool
    lru: torch.Tensor             # [sets] int32 (way to evict next)
    cycle: torch.Tensor           # 0-dim int32
    stats: Dict[str, torch.Tensor]  # 0-dim int32 each


STAT_KEYS = ("instrs", "stall_cycles", "idle_cycles", "dcache_hits",
             "dcache_misses", "bank_conflict_cycles", "divergent_splits",
             "uniform_splits", "joins", "barrier_waits",
             "divergence_violations", "loads", "stores",
             # telemetry counters (repro_torch.obs.perf.PerfReport inputs):
             # occupancy_cycles — sum over cycles of active warps,
             # issued_lanes — sum of active lanes of issued instructions,
             # sched_refills — visible-window refill events (§IV-B)
             "occupancy_cycles", "issued_lanes", "sched_refills")


def check_config(mc: MachineConfig) -> None:
    """Configurations both implementations take.  The LRU flip
    (``1 - used_way``) is the JAX model's two-way rule."""
    if mc.cache_ways != 2:
        raise ValueError(f"cache_ways must be 2, got {mc.cache_ways}")
    if min(mc.warps, mc.threads, mc.ipdom_depth, mc.barriers,
           mc.dmem_words, mc.smem_words, mc.sets, mc.cache_banks) < 1:
        raise ValueError(f"every size of {mc} must be positive")


def init_state(mc: MachineConfig, dmem_image: Optional[np.ndarray] = None,
               device: DeviceLike = None) -> State:
    check_config(mc)
    dev = resolve_device(device)
    W, T, D = mc.warps, mc.threads, mc.ipdom_depth

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    dmem = z(mc.dmem_words)
    if dmem_image is not None:
        img = torch.as_tensor(np.asarray(dmem_image).astype(np.int32))
        if img.ndim != 1 or img.shape[0] > mc.dmem_words:
            raise ValueError(f"dmem image of shape {tuple(img.shape)} does "
                             f"not fit {mc.dmem_words} words")
        dmem[: img.shape[0]] = img.to(dev)
    tmask = z(W, T, dtype=torch.bool)
    tmask[0, 0] = True                  # warp0/lane0 boots
    active = z(W, dtype=torch.bool)
    active[0] = True
    return State(
        pc=z(W, dtype=I64), active=active, stalled_until=z(W),
        at_barrier=z(W, dtype=torch.bool), visible=z(W, dtype=torch.bool),
        tmask=tmask, gpr=z(W, T, 32), ipdom_pc=z(W, D, dtype=I64),
        ipdom_mask=z(W, D, T, dtype=torch.bool),
        ipdom_ft=z(W, D, dtype=torch.bool), ipdom_sp=z(W),
        bar_count=z(mc.barriers),
        bar_release=z(mc.barriers, W, dtype=torch.bool), dmem=dmem,
        smem=z(mc.smem_words), tags=z(mc.sets, mc.cache_ways),
        tvalid=z(mc.sets, mc.cache_ways, dtype=torch.bool), lru=z(mc.sets),
        cycle=z(), stats={k: z() for k in STAT_KEYS})


# ---------------------------------------------------------------------------
# scalar helpers (host ints)
# ---------------------------------------------------------------------------

def _s32(v):
    """Wrap an int (or an int64 tensor) to the int32 range."""
    return ((v + 2**31) & M32) - 2**31


def _sext(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _decode(i: int) -> Dict[str, int]:
    """Fields of one instruction word (host ints, immediates signed)."""
    return dict(
        opcode=i & 0x7F, rd=(i >> 7) & 31, funct3=(i >> 12) & 7,
        rs1=(i >> 15) & 31, rs2=(i >> 20) & 31, funct7=(i >> 25) & 0x7F,
        imm_i=_sext(i >> 20, 12),
        imm_s=_sext((((i >> 25) & 0x7F) << 5) | ((i >> 7) & 31), 12),
        imm_b=_sext((((i >> 31) & 1) << 12) | (((i >> 7) & 1) << 11)
                    | (((i >> 25) & 0x3F) << 5) | (((i >> 8) & 0xF) << 1),
                    13),
        imm_u=_s32(i & 0xFFFFF000),
        imm_j=_sext((((i >> 31) & 1) << 20) | (((i >> 12) & 0xFF) << 12)
                    | (((i >> 20) & 1) << 11) | (((i >> 21) & 0x3FF) << 1),
                    21))


_GROUP_IDS = {isa.OP_LUI: 1, isa.OP_AUIPC: 2, isa.OP_JAL: 3, isa.OP_JALR: 4,
              isa.OP_BRANCH: 5, isa.OP_LOAD: 6, isa.OP_STORE: 7,
              isa.OP_IMM: 8, isa.OP_OP: 9, isa.OP_SYSTEM: 10,
              isa.OP_FP: 11, isa.OP_CUSTOM0: 12}
_INVALID = 13


# ---------------------------------------------------------------------------
# ALU groups (vectorized over lanes; int32 tensors in, int32 tensors out)
# ---------------------------------------------------------------------------

def _u(x: torch.Tensor) -> torch.Tensor:
    """The u32 value of an int32 tensor, as int64."""
    return x.to(I64) & M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor wrapped to int32."""
    return _s32(x).to(I32)


def _alu_int(funct3: int, sub_or_sra: bool, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    a64, b64 = a.to(I64), b.to(I64)
    sh = b64 & 31
    if funct3 == 0:
        return _i32(a64 - b64 if sub_or_sra else a64 + b64)
    if funct3 == 1:
        return _i32(_u(a) << sh)
    if funct3 == 2:
        return (a64 < b64).to(I32)
    if funct3 == 3:
        return (_u(a) < _u(b)).to(I32)
    if funct3 == 4:
        return a ^ b
    if funct3 == 5:
        return _i32(a64 >> sh if sub_or_sra else _u(a) >> sh)
    if funct3 == 6:
        return a | b
    return a & b


def _alu_m(funct3: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a64, b64 = a.to(I64), b.to(I64)
    zero_b = b64 == 0
    if funct3 == 0:
        return _i32(a64 * b64)
    mulh = (a64 * b64) >> 32                        # |a*b| <= 2**62
    if funct3 == 1:
        return _i32(mulh)
    if funct3 == 2:                                 # |a * u(b)| < 2**63
        return _i32((a64 * _u(b)) >> 32)
    if funct3 == 3:                                 # mulhu from mulh
        return _i32(mulh + torch.where(a64 < 0, _u(b), 0)
                    + torch.where(b64 < 0, _u(a), 0))
    if funct3 in (4, 6):
        ovf = (a64 == -2**31) & (b64 == -1)
        safe = torch.where(zero_b | ovf, 1, b64)
        q = torch.div(a64, safe, rounding_mode="trunc")
        if funct3 == 4:
            return _i32(torch.where(zero_b, -1, torch.where(ovf, -2**31, q)))
        return _i32(torch.where(zero_b, a64,
                                torch.where(ovf, 0, a64 - q * safe)))
    safe = torch.where(zero_b, 1, _u(b))
    if funct3 == 5:
        return _i32(torch.where(zero_b, -1, _u(a) // safe))
    return _i32(torch.where(zero_b, _u(a), _u(a) % safe))


def _is_nan(u: torch.Tensor) -> torch.Tensor:
    return ((u & 0x7F800000) == 0x7F800000) & ((u & 0x7FFFFF) != 0)


def _daz(u: torch.Tensor) -> torch.Tensor:
    """Denormal inputs read as zero of the same sign."""
    return torch.where((u & 0x7F800000) == 0, u & 0x80000000, u)


def _f32(u: torch.Tensor) -> torch.Tensor:
    """The float32 whose bits are the u32 values `u` (int64)."""
    return _i32(u).view(torch.float32)


def _bits(f: torch.Tensor) -> torch.Tensor:
    return _u(f.view(I32))


def _round_ftz(p: torch.Tensor) -> torch.Tensor:
    """Bits of the float64 result `p` rounded to float32, with results
    that are tiny after rounding (|x| < 2**-126 when rounded to 24 bits
    with an unbounded exponent, x86's rule) flushed to signed zero."""
    tiny = (p * 2.0**64).to(torch.float32).abs() < 2.0**-62
    zero = torch.where(torch.signbit(p), 0x80000000, 0)
    return torch.where(tiny, zero, _bits(p.to(torch.float32)))


def _nan_bits(res: torch.Tensor, first: torch.Tensor,
              second: torch.Tensor) -> torch.Tensor:
    """A NaN result is `first` quieted if it is NaN, else `second`
    quieted if it is, else the default NaN."""
    q = torch.where(_is_nan(first), first | 0x400000,
                    torch.where(_is_nan(second), second | 0x400000,
                                0xFFC00000))
    return torch.where(_is_nan(res), q, res)


def _alu_fp(funct7: int, funct3: int, a: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    ua, ub = _u(a), _u(b)
    fa, fb = _f32(_daz(ua)), _f32(_daz(ub))
    da, db = fa.to(torch.float64), fb.to(torch.float64)
    if funct7 == 0x04:                  # sub: a + (-b), NaN rule as add
        ub_neg = ub ^ 0x80000000
        out = _nan_bits(_round_ftz(da - db), ub_neg, ua)
    elif funct7 == 0x08:
        out = _nan_bits(_round_ftz(da * db), ub, ua)
    elif funct7 == 0x0C:
        out = _nan_bits(_round_ftz(da / db), ua, ub)
    elif funct7 == 0x2C:
        out = _nan_bits(_round_ftz(torch.sqrt(da)), ua, ua)
    elif funct7 == 0x14 and funct3 in (0, 1):
        # LLVM's x86 minimum/maximum: order the operands by a's sign,
        # then minss/maxss (second operand on ties and NaN), then the
        # first ordered operand if it is NaN
        neg = (ua & 0x80000000) != 0
        lo_first = neg if funct3 == 0 else ~neg
        nx = torch.where(lo_first, ub, ua)
        ny = torch.where(lo_first, ua, ub)
        fx, fy = _f32(_daz(nx)), _f32(_daz(ny))
        pick = fx < fy if funct3 == 0 else fx > fy
        out = torch.where(_is_nan(nx), nx,
                          torch.where(pick, _daz(nx), _daz(ny)))
    elif funct7 == 0x50 and funct3 in (0, 1, 2):
        cmp = (fa <= fb, fa < fb, fa == fb)[funct3]
        out = cmp.to(I64)
    elif funct7 == 0x60:                # fcvt.w.s: saturate, NaN -> 0
        t = torch.trunc(fa).to(torch.float64)
        ok = ~torch.isnan(t)
        safe = torch.where(ok, t.clamp(-2.0**31, 2.0**31 - 1), 0.0)
        out = safe.to(I64) & M32
    elif funct7 == 0x68:                # fcvt.s.w: round to nearest even
        out = _bits(a.to(torch.float64).to(torch.float32))
    else:
        out = _nan_bits(_round_ftz(da + db), ub, ua)
    return _i32(out)


# ---------------------------------------------------------------------------
# the plain cycle loop
# ---------------------------------------------------------------------------

def _last_writers(idx: torch.Tensor, writes: torch.Tensor,
                  later: torch.Tensor) -> torch.Tensor:
    """Lanes whose write to `idx` survives a scatter that resolves
    repeated indices last-wins in lane order: writing lanes with no
    higher writing lane at the same index (`later[t, u]`: u > t).  The
    survivors' indices are distinct."""
    hidden = (idx[:, None] == idx[None, :]) & later & writes[None, :]
    return writes & ~hidden.any(1)


class _Plain:
    """The machine's state as tensors updated in place, the cycle and the
    counters as host ints; `step` runs one cycle."""

    def __init__(self, mc: MachineConfig, program: np.ndarray, st: State):
        check_config(mc)
        self.mc = mc
        self.imem = _program(program).tolist()
        self.s = {f: getattr(st, f).clone() for f in State._fields
                  if f not in ("cycle", "stats")}
        self.cycle = int(st.cycle)
        self.stats = {k: int(v) for k, v in st.stats.items()}
        dev = st.pc.device
        T, W = mc.threads, mc.warps
        self.lane_iota = torch.arange(T, device=dev)
        self.warp_iota = torch.arange(W, device=dev)
        self.bank_iota = torch.arange(mc.cache_banks, device=dev)
        self.earlier = torch.ones(T, T, dtype=torch.bool,
                                  device=dev).tril(-1)
        self.later = self.earlier.T.clone()

    def state(self) -> State:
        dev = self.s["pc"].device

        def scalar(v: int) -> torch.Tensor:
            return torch.tensor(_s32(v), dtype=I32, device=dev)

        return State(**self.s, cycle=scalar(self.cycle),
                     stats={k: scalar(v) for k, v in self.stats.items()})

    def bump(self, **kw: int) -> None:
        for k, v in kw.items():
            self.stats[k] += int(v)

    # -- one cycle ----------------------------------------------------------

    def step(self) -> int:
        """One cycle; returns the number of active warps after it."""
        s, mc = self.s, self.mc
        W = mc.warps
        stalled = s["stalled_until"] > self.cycle
        ok = scheduler.schedulable(s["active"], stalled, s["at_barrier"])
        refilled = ~(s["visible"] & ok).any() & ok.any()
        wid, visible = scheduler.step_masks(s["visible"], s["active"],
                                            stalled, s["at_barrier"])
        s["visible"].copy_(visible)
        wid, refilled = torch.stack([wid, refilled.to(wid.dtype)]).tolist()
        issued = wid < W
        lanes_n = 0
        if issued:
            lanes = s["tmask"][wid].clone()
            lanes_n = int(lanes.sum())
            self.issue(wid, lanes)
        else:
            self.bump(idle_cycles=1)
        n_active = int(s["active"].sum())
        self.bump(instrs=issued, occupancy_cycles=n_active,
                  issued_lanes=lanes_n, sched_refills=refilled)
        self.cycle += 1
        return n_active

    def issue(self, w: int, lanes: torch.Tensor) -> None:
        s, mc = self.s, self.mc
        pc = int(s["pc"][w])
        d = _decode(self.imem[(pc >> 2) % len(self.imem)])
        g = _GROUP_IDS.get(d["opcode"], _INVALID)
        self.w, self.lanes, self.d, self.pc4 = w, lanes, d, (pc + 4) & M32
        self.rs1v = s["gpr"][w, :, d["rs1"]].clone()
        self.rs2v = s["gpr"][w, :, d["rs2"]].clone()
        if g == 1:                                          # lui
            self.write_rd(d["imm_u"])
        elif g == 2:                                        # auipc
            self.write_rd(_s32(pc + d["imm_u"]))
        elif g in (3, 4):                                   # jal, jalr
            tgt = ((pc + d["imm_j"]) if g == 3
                   else (self.uniform(self.rs1v) + d["imm_i"]) & ~1)
            self.write_rd(_s32(self.pc4))
            s["pc"][w] = tgt & M32
            return
        elif g == 5:
            self.branch(pc)
            return
        elif g in (6, 7):
            self.memory(store=g == 7)
        elif g == 8:                                        # op-imm
            is_sra = d["funct3"] == 5 and (d["imm_i"] >> 10) & 1 == 1
            b = torch.full_like(self.rs1v, d["imm_i"])
            self.write_rd(_alu_int(d["funct3"], is_sra, self.rs1v, b))
        elif g == 9:                                        # op
            if d["funct7"] == 1:
                val = _alu_m(d["funct3"], self.rs1v, self.rs2v)
            else:
                val = _alu_int(d["funct3"], d["funct7"] == 0x20, self.rs1v,
                              self.rs2v)
            self.write_rd(val)
        elif g == 10:
            self.system()
        elif g == 11:
            self.write_rd(_alu_fp(d["funct7"], d["funct3"], self.rs1v,
                                 self.rs2v))
        elif g == 12:
            self.vortex(pc)
            return
        else:                   # fault: halt the warp (no runaway fetch)
            s["active"][w] = False
        s["pc"][w] = self.pc4

    # -- helpers ------------------------------------------------------------

    def first_lane(self) -> int:
        """The lowest active lane, or lane 0 when none is (warp-uniform
        reads take this lane's value)."""
        i = int(scheduler.first_set(self.lanes))
        return 0 if i == self.mc.threads else i

    def uniform(self, vals: torch.Tensor) -> int:
        return int(vals[self.first_lane()])

    def write_rd(self, val) -> None:
        """Predicated per-lane GPR write; x0 stays zero."""
        rd = self.d["rd"]
        if rd == 0:
            return
        col = self.s["gpr"][self.w, :, rd]
        self.s["gpr"][self.w, :, rd] = torch.where(self.lanes, val, col)

    # -- groups -------------------------------------------------------------

    def branch(self, pc: int) -> None:
        a, b = self.rs1v, self.rs2v
        f3 = self.d["funct3"]
        if f3 in (4, 5):
            cmp = a < b
        elif f3 in (6, 7):
            cmp = _u(a) < _u(b)
        else:
            cmp = a == b
        if f3 in (1, 5, 7):
            cmp = ~cmp
        take = bool(cmp[self.first_lane()])
        viol = bool(((cmp != take) & self.lanes).any())
        self.bump(divergence_violations=viol)
        npc = (pc + self.d["imm_b"]) & M32 if take else self.pc4
        self.s["pc"][self.w] = npc

    def dcache(self, addrs: torch.Tensor, mask: torch.Tensor):
        """Cache model over the lanes in `mask`: fills and LRU flips in
        place; returns (unique missing lines, bank-conflict cycles, unique
        hits) as 0-dim tensors."""
        s, mc = self.s, self.mc
        line = addrs >> 4                                   # 16 B lines
        set_ = line & (mc.sets - 1)
        tag = line >> mc.tag_shift
        way_hit = s["tvalid"][set_] & (s["tags"][set_] == tag[:, None])
        hit = way_hit.any(1) & mask
        miss = mask & ~hit
        # a lane repeating an earlier masked lane's line is not counted
        dup = ((line[:, None] == line[None, :]) & self.earlier
               & mask[None, :]).any(1)
        uniq_miss = miss & ~dup
        fill_way = s["lru"][set_].to(I64)
        win = _last_writers(set_, uniq_miss, self.later)
        s["tags"][set_[win], fill_way[win]] = tag[win].to(I32)
        s["tvalid"][set_[win], fill_way[win]] = True
        # LRU flip: on hit or fill, evict the other way next
        first_hit = torch.where(way_hit[:, 0], 0, 1)
        used_way = torch.where(hit, first_hit, fill_way)
        win = _last_writers(set_, hit | uniq_miss, self.later)
        s["lru"][set_[win]] = (1 - used_way[win]).to(I32)
        # line-granular banking: serialized accesses per bank
        bank = line & (mc.cache_banks - 1)
        counts = ((bank[:, None] == self.bank_iota)
                  & (mask & ~dup)[:, None]).sum(0)
        return (uniq_miss.sum(), (counts.max() - 1).clamp(min=0),
                (hit & ~dup).sum())

    def memory(self, store: bool) -> None:
        s, mc, d, w, lanes = self.s, self.mc, self.d, self.w, self.lanes
        addrs = (_u(self.rs1v) + (d["imm_s"] if store else d["imm_i"])) & M32
        is_sm = addrs >= SMEM_BASE
        n_miss, extra, n_hit = self.dcache(addrs, lanes & ~is_sm)
        # smem: word-granular banks
        sm_word = ((addrs - SMEM_BASE) & M32) >> 2
        sm_bank = sm_word & (mc.cache_banks - 1)
        sm_counts = ((sm_bank[:, None] == self.bank_iota)
                     & (lanes & is_sm)[:, None]).sum(0)
        sm_extra = (sm_counts.max() - 1).clamp(min=0)
        n_miss, extra, n_hit, sm_extra = torch.stack(
            [n_miss, extra, n_hit, sm_extra]).tolist()
        stall = (mc.miss_latency + (n_miss - 1) * mc.miss_pipeline
                 if n_miss > 0 else 0) + extra + sm_extra
        if stall > 0:
            s["stalled_until"][w] = _s32(self.cycle + 1 + stall)
        self.bump(dcache_misses=n_miss, dcache_hits=n_hit,
                  stall_cycles=stall, bank_conflict_cycles=extra + sm_extra,
                  loads=not store, stores=store)
        widx = (addrs >> 2) % mc.dmem_words
        sidx = sm_word % mc.smem_words
        old_d, old_s = s["dmem"][widx], s["smem"][sidx]
        word = _u(torch.where(is_sm, old_s, old_d))
        sh = (addrs & 3) * 8
        f3 = d["funct3"]
        if not store:
            b = (word >> sh) & 0xFF
            h = (word >> (sh & ~8)) & 0xFFFF
            if f3 == 0:
                val = b - torch.where(b >= 0x80, 0x100, 0)
            elif f3 == 1:
                val = h - torch.where(h >= 0x8000, 0x10000, 0)
            else:
                val = {4: b, 5: h}.get(f3, word)
            self.write_rd(_i32(val))
            return
        # every lane writes back (the old word where it does not store),
        # so a higher masked-off lane aliasing a word undoes a store to it
        if f3 % 4 < 2:
            bmask = ((0xFF if f3 % 4 == 0 else 0xFFFF) << sh) & M32
        else:
            bmask = torch.full_like(sh, M32)
        newv = _i32((word & ~bmask) | ((_u(self.rs2v) << sh) & bmask))
        every = torch.ones_like(lanes)
        for mem, idx, old, mine in ((s["dmem"], widx, old_d, ~is_sm),
                                    (s["smem"], sidx, old_s, is_sm)):
            val = torch.where(lanes & mine, newv, old)
            win = _last_writers(idx, every, self.later)
            mem[idx[win]] = val[win]

    def system(self) -> None:
        s, mc, d = self.s, self.mc, self.d
        if d["funct3"] == 0:                    # ecall = warp exit
            s["active"][self.w] = False
            return
        csr = d["imm_i"] & 0xFFF
        val = {isa.CSR_TID: None, isa.CSR_WID: self.w, isa.CSR_NT: mc.threads,
               isa.CSR_NW: mc.warps, isa.CSR_CYCLE: _s32(self.cycle)}.get(
                   csr, 0)
        self.write_rd(self.lane_iota.to(I32) if val is None else val)

    def vortex(self, pc: int) -> None:
        s, mc, d, w, lanes = self.s, self.mc, self.d, self.w, self.lanes
        W, T, D = mc.warps, mc.threads, mc.ipdom_depth
        f3 = min(d["funct3"], 4)
        s["pc"][w] = self.pc4
        if f3 == 0:                                         # tmc
            n = min(max(self.uniform(self.rs1v), 0), T)
            s["tmask"][w] = self.lane_iota < n
            if n == 0:
                s["active"][w] = False
        elif f3 == 1:                                       # wspawn
            nw = min(max(self.uniform(self.rs1v), 0), W)
            spawn = (self.warp_iota < nw) & ~s["active"] & (self.warp_iota
                                                            != w)
            s["active"] |= spawn
            s["pc"][spawn] = self.uniform(self.rs2v) & M32
            s["tmask"][spawn] = self.lane_iota == 0
        elif f3 == 2:                                       # split
            # stack writes past the depth are dropped, reads clamp to it
            pred = (self.rs1v != 0) & lanes
            ntaken = (self.rs1v == 0) & lanes
            any_t, any_n = torch.stack([pred.any(), ntaken.any()]).tolist()
            divergent = any_t and any_n
            sp = int(s["ipdom_sp"][w])
            else_pc = (pc + d["imm_b"]) & M32
            if sp < D:              # the fall-through entry, always pushed
                s["ipdom_mask"][w, sp] = lanes
                s["ipdom_ft"][w, sp] = True
                s["ipdom_pc"][w, sp] = self.pc4
            if any_t and sp + 1 < D:    # the else entry
                s["ipdom_mask"][w, sp + 1] = ntaken
                s["ipdom_ft"][w, sp + 1] = False
                s["ipdom_pc"][w, sp + 1] = else_pc
            s["ipdom_sp"][w] = _s32(sp + (2 if any_t else 1))
            s["tmask"][w] = pred if any_t else lanes
            s["pc"][w] = self.pc4 if any_t else else_pc
            self.bump(divergent_splits=divergent,
                      uniform_splits=not divergent)
        elif f3 == 3:                                       # join
            sp0 = int(s["ipdom_sp"][w])
            sp1, sp2 = max(sp0 - 1, 0), max(sp0 - 2, 0)
            i1, i2 = min(sp1, D - 1), min(sp2, D - 1)
            top_mask = s["ipdom_mask"][w, i1].clone()
            top_ft = bool(s["ipdom_ft"][w, i1])
            top_pc = int(s["ipdom_pc"][w, i1])
            top_empty = not bool(top_mask.any()) and not top_ft
            if sp0 == 0:
                new = (0, lanes, self.pc4)
            elif top_empty:
                new = (sp2, s["ipdom_mask"][w, i2].clone(),
                       (pc + d["imm_b"]) & M32)
            else:
                new = (sp1, top_mask, self.pc4 if top_ft else top_pc)
            s["ipdom_sp"][w], s["tmask"][w], s["pc"][w] = new
            self.bump(joins=1)
        else:                                               # bar
            bid = self.uniform(self.rs1v) & (mc.barriers - 1)
            need = self.uniform(self.rs2v)
            cnt = _s32(int(s["bar_count"][bid]) + 1)
            if cnt >= need:
                rel = s["bar_release"][bid].clone()
                rel[w] = True
                s["at_barrier"] &= ~rel
                s["bar_release"][bid] = False
                s["bar_count"][bid] = 0
            else:
                s["at_barrier"][w] = True
                s["bar_release"][bid, w] = True
                s["bar_count"][bid] = cnt
                self.bump(barrier_waits=1)


def _program(program) -> np.ndarray:
    """Instruction words as a non-empty 1-d np.uint32 array."""
    words = np.asarray(program, np.uint32)
    if words.ndim != 1 or words.size == 0:
        raise ValueError(f"a program is a non-empty 1-d array of words, "
                         f"got shape {words.shape}")
    return words


def _start(mc: MachineConfig, dmem_image, state: Optional[State],
           device: DeviceLike) -> State:
    if state is None:
        return init_state(mc, dmem_image, device=device)
    if device is not None and resolve_device(device) != state.pc.device:
        raise ValueError(f"state lies on {state.pc.device}, not {device}")
    return state


def run_plain(mc: MachineConfig, program: np.ndarray,
              dmem_image: Optional[np.ndarray] = None,
              state: Optional[State] = None,
              device: DeviceLike = None) -> State:
    """The plain PyTorch loop: `program` (np.uint32 words) to completion
    on the state's device, one `_Plain.step` per cycle (the kernel's
    oracle; ``run`` takes it for CPU tensors)."""
    st = _start(mc, dmem_image, state, device)
    m = _Plain(mc, program, st)
    n_active = int(st.active.sum())
    while n_active > 0 and m.cycle < mc.max_cycles:
        n_active = m.step()
    return m.state()


def _run(mc: MachineConfig, program, st: State) -> State:
    if st.pc.device.type == "cpu":
        return run_plain(mc, program, state=st)
    from repro_torch.kernels.simt_machine import ops
    words = torch.from_numpy(_program(program).view(np.int32).copy())
    return ops.simt_machine(mc, words.to(st.pc.device), st)


class LaunchLog:
    """Per-kernel launch telemetry: each `machine.run` call (== one kernel
    launch via pocl_spawn/raw_spawn) records its label, stats delta, and
    wall time, so multi-kernel pipelines (gaussian Fan1/Fan2, k-means
    assign/update, ...) get a PerfReport PER KERNEL instead of one blurred
    per-run aggregate.

    Off by default — the disabled path adds one attribute read to `run`.
    Enabling forces a host sync per launch (stats must be read back), so
    it is a profiling switch, not an always-on counter."""

    def __init__(self) -> None:
        self.enabled = False
        self.records: List[Dict[str, Any]] = []

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self.records = []

    def record(self, label: str, stats: Dict[str, int],
               wall_s: float) -> None:
        self.records.append({"label": label, "stats": stats,
                             "wall_s": wall_s})

    def per_kernel(self) -> Dict[str, Dict[str, int]]:
        """Aggregate stats by kernel label (summed over launches, plus a
        `launches` count and `wall_s` total)."""
        out: Dict[str, Dict[str, Any]] = {}
        for rec in self.records:
            agg = out.setdefault(rec["label"], {"launches": 0,
                                                "wall_s": 0.0})
            agg["launches"] += 1
            agg["wall_s"] = round(agg["wall_s"] + rec["wall_s"], 6)
            for k, v in rec["stats"].items():
                agg[k] = agg.get(k, 0) + v
        return out

    def reports(self, mc: Optional[MachineConfig] = None
                ) -> Dict[str, Any]:
        """{label: PerfReport} over the aggregated per-kernel stats."""
        from repro_torch.obs.perf import PerfReport
        return {label: PerfReport.from_stats(
                    stats, warps=mc.warps if mc else None,
                    threads=mc.threads if mc else None)
                for label, stats in self.per_kernel().items()}


# process-global launch log (mirrors obs.tracer / obs.flight)
launch_log = LaunchLog()


def run(mc: MachineConfig, program: np.ndarray,
        dmem_image: Optional[np.ndarray] = None,
        state: Optional[State] = None,
        label: Optional[str] = None,
        device: DeviceLike = None) -> State:
    """Run `program` (np.uint32 words) to completion; returns final State.

    On ``cuda`` (the default; or a CUDA `state`) one launch of the CUDA
    kernel runs the whole loop; on ``cpu`` the plain loop runs.

    `label` names the launch for telemetry (per-kernel LaunchLog entries,
    `simt:launch:<label>` trace spans, flight events).  With the launch
    log, tracer, and flight recorder all disabled (the default) this is
    exactly the bare run — no sync, no clock reads."""
    st = _start(mc, dmem_image, state, device)
    if not (launch_log.enabled or _tracer.enabled or _flight.enabled):
        return _run(mc, program, st)
    name = label or "kernel"
    base = stats_dict(st) if state is not None else None
    t0 = time.perf_counter()
    with _tracer.span(f"simt:launch:{name}"):
        out = _run(mc, program, st)
        stats = stats_dict(out)         # blocks: the span covers execution
    wall_s = time.perf_counter() - t0
    if base is not None:                # continuation run: delta only
        stats = {k: v - base.get(k, 0) for k, v in stats.items()}
    if launch_log.enabled:
        launch_log.record(name, stats, wall_s)
    _flight.record("simt.launch", label=name, cycles=stats["cycles"],
                   instrs=stats["instrs"], wall_s=round(wall_s, 6))
    return out


def stats_dict(st: State) -> Dict[str, int]:
    """Counters and ``cycles`` as host ints (one device read)."""
    vals = torch.stack([st.stats[k] for k in STAT_KEYS] + [st.cycle])
    *counts, cycles = vals.tolist()
    return {**dict(zip(STAT_KEYS, counts)), "cycles": cycles}


def read_words(st: State, addr: int, n: int) -> np.ndarray:
    return st.dmem[addr // 4: addr // 4 + n].cpu().numpy()


def perf_report(st_or_stats, mc: Optional[MachineConfig] = None):
    """Vortex-style derived report (IPC, stall/idle breakdown, D-cache hit
    rate, occupancy) — see repro_torch.obs.perf.PerfReport.

    Accepts either a final State or a stats dict from `stats_dict`."""
    from repro_torch.obs.perf import PerfReport
    stats = (stats_dict(st_or_stats) if isinstance(st_or_stats, State)
             else dict(st_or_stats))
    return PerfReport.from_stats(
        stats,
        warps=mc.warps if mc is not None else None,
        threads=mc.threads if mc is not None else None)
