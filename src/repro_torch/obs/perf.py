"""Vortex-style machine performance report.

The Vortex follow-on work (arXiv:2110.10857) exposes hardware counters
through CSRs and derives IPC / cache hit-rate / stall breakdowns from
them; this module computes the same derived report from the cycle-level
simulator's ``stats`` dict (``core.simt.machine.stats_dict`` of the JAX
package).  A copy of ``repro.obs.perf``, which imports no JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

__all__ = ["PerfReport"]


def _g(stats: Mapping[str, Any], key: str) -> int:
    return int(stats.get(key, 0))


@dataclasses.dataclass(frozen=True)
class PerfReport:
    """Derived machine-level performance summary.

    Cycle accounting: each simulator cycle either issues an instruction
    (``instrs``) or idles (``idle_cycles`` — no schedulable warp).
    ``stall_cycles`` is the total stall *penalty* charged to warps
    (memory latency + bank serialization); with multiple warps in flight
    those penalties overlap, which is exactly the latency hiding the
    occupancy column measures.
    """
    cycles: int
    instrs: int
    ipc: float
    idle_cycles: int
    idle_frac: float
    stall_cycles: int               # total per-warp stall penalty charged
    loads: int
    stores: int
    dcache_hits: int
    dcache_misses: int
    dcache_hit_rate: float
    bank_conflict_cycles: int
    bank_conflict_rate: float       # conflict cycles per memory access
    divergent_splits: int
    uniform_splits: int
    joins: int
    barrier_waits: int
    divergence_violations: int
    sched_refills: int              # visible-window refill events
    warp_occupancy: float           # mean active warps per cycle
    lane_utilization: float         # mean active-lane fraction per issue
    warps: Optional[int] = None
    threads: Optional[int] = None

    @classmethod
    def from_stats(cls, stats: Mapping[str, Any], *,
                   warps: Optional[int] = None,
                   threads: Optional[int] = None) -> "PerfReport":
        cycles = _g(stats, "cycles")
        instrs = _g(stats, "instrs")
        hits = _g(stats, "dcache_hits")
        misses = _g(stats, "dcache_misses")
        accesses = _g(stats, "loads") + _g(stats, "stores")
        conflicts = _g(stats, "bank_conflict_cycles")
        occ_cycles = _g(stats, "occupancy_cycles")
        issued_lanes = _g(stats, "issued_lanes")
        lane_util = 0.0
        if threads and instrs:
            lane_util = issued_lanes / (instrs * threads)
        return cls(
            cycles=cycles,
            instrs=instrs,
            ipc=instrs / cycles if cycles else 0.0,
            idle_cycles=_g(stats, "idle_cycles"),
            idle_frac=_g(stats, "idle_cycles") / cycles if cycles else 0.0,
            stall_cycles=_g(stats, "stall_cycles"),
            loads=_g(stats, "loads"),
            stores=_g(stats, "stores"),
            dcache_hits=hits,
            dcache_misses=misses,
            dcache_hit_rate=hits / (hits + misses) if hits + misses else 0.0,
            bank_conflict_cycles=conflicts,
            bank_conflict_rate=conflicts / accesses if accesses else 0.0,
            divergent_splits=_g(stats, "divergent_splits"),
            uniform_splits=_g(stats, "uniform_splits"),
            joins=_g(stats, "joins"),
            barrier_waits=_g(stats, "barrier_waits"),
            divergence_violations=_g(stats, "divergence_violations"),
            sched_refills=_g(stats, "sched_refills"),
            warp_occupancy=occ_cycles / cycles if cycles else 0.0,
            lane_utilization=lane_util,
            warps=warps,
            threads=threads,
        )

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        cfg = ""
        if self.warps is not None and self.threads is not None:
            cfg = f" ({self.warps}w x {self.threads}t)"
        occ = f"{self.warp_occupancy:.2f}"
        if self.warps:
            occ += f"/{self.warps}"
        lines = [
            f"PerfReport{cfg}",
            f"  cycles          {self.cycles:>12,d}",
            f"  instrs          {self.instrs:>12,d}",
            f"  IPC             {self.ipc:>12.4f}",
            f"  idle cycles     {self.idle_cycles:>12,d}"
            f"  ({self.idle_frac:.1%} of cycles)",
            f"  stall penalty   {self.stall_cycles:>12,d} cycles charged",
            f"  loads/stores    {self.loads:>12,d} / {self.stores:,d}",
            f"  dcache          {self.dcache_hits:>12,d} hits,"
            f" {self.dcache_misses:,d} misses"
            f"  (hit rate {self.dcache_hit_rate:.1%})",
            f"  bank conflicts  {self.bank_conflict_cycles:>12,d} cycles"
            f"  ({self.bank_conflict_rate:.2f} per access)",
            f"  splits          {self.divergent_splits:>12,d} divergent,"
            f" {self.uniform_splits:,d} uniform, {self.joins:,d} joins",
            f"  barrier waits   {self.barrier_waits:>12,d}",
            f"  sched refills   {self.sched_refills:>12,d}",
            f"  warp occupancy  {occ:>12s} active warps/cycle",
            f"  lane util       {self.lane_utilization:>12.1%}"
            f" of issued-warp lanes",
        ]
        if self.divergence_violations:
            lines.append(f"  DIVERGENCE VIOLATIONS "
                         f"{self.divergence_violations:,d}")
        return "\n".join(lines)
