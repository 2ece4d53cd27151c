"""Area/power analytical model calibrated to the paper's Fig 7/8.

Structure follows §V-A's design-space discussion exactly:

  * threads scale the ALUs, the GPR read/write width, the post-GPR
    pipeline registers, and the cache/smem arbitration logic;
  * warps scale the scheduler, the number of GPR tables, IPDOM stacks and
    scoreboards — and each of those is itself proportional to the thread
    count ("the cost of increasing warps depends on the number of threads").
  * caches/smem are a fixed overhead (1KB I$ + 4KB D$ + 8KB smem in every
    config Fig 8 uses).

  area(W,T)  = a_mem + a_alu*T + a_pipe*T + a_sched*W + a_gpr*W*T + a_ipdom*W*T
  power(W,T) = same shape with power coefficients + activity factor.

Absolute anchor: the paper's GDS config (8 warps x 4 threads, 300 MHz)
produces 46.8 mW total (Fig 7) — power coefficients are normalized so
power(8,4) == 46.8 mW.  Area is reported normalized to the 1x1 config as
in Fig 8 (no absolute mm^2 is published).

The four qualitative claims this model must (and does — see
tests/test_paper_claims.py) reproduce:
  (i)   area/power grow faster in T than the warp-only direction,
  (ii)  warp cost scales with T (d area / d W is increasing in T),
  (iii) the fixed memory overhead damps small-config differences,
  (iv)  32-thread configs land near the paper's power-efficiency sweet
        spot for cache-friendly kernels (combined with fig9 cycles).

A copy of ``repro.core.simt.power`` (the port imports nothing of
``repro``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# Relative cost coefficients (unitless; GPR bit dominates — a 4KB register
# file per 8w x 4t config is the paper's own sizing: 32 regs x 4B x T x W).
_AREA = dict(mem=6.0, alu=1.0, pipe=0.35, sched=0.25, gpr=0.55, ipdom=0.08)
_POWER = dict(mem=3.2, alu=1.0, pipe=0.4, sched=0.3, gpr=0.75, ipdom=0.08)

PAPER_ANCHOR_MW = 46.8           # Fig 7: 8 warps x 4 threads @ 300 MHz


def _model(c: Dict[str, float], warps: int, threads: int) -> float:
    return (c["mem"] + c["alu"] * threads + c["pipe"] * threads
            + c["sched"] * warps + (c["gpr"] + c["ipdom"]) * warps * threads)


def area(warps: int, threads: int) -> float:
    """Relative area units."""
    return _model(_AREA, warps, threads)


def power_mw(warps: int, threads: int) -> float:
    """Absolute power estimate in mW, anchored at the paper's GDS point."""
    rel = _model(_POWER, warps, threads)
    return PAPER_ANCHOR_MW * rel / _model(_POWER, 8, 4)


def area_normalized(warps: int, threads: int) -> float:
    """Fig 8 convention: normalized to the 1 warp x 1 thread config."""
    return area(warps, threads) / area(1, 1)


def power_normalized(warps: int, threads: int) -> float:
    return power_mw(warps, threads) / power_mw(1, 1)


def cell_count_normalized(warps: int, threads: int) -> float:
    """Cell count tracks area minus the SRAM macros (Fig 8's third panel)."""
    logic = dict(_AREA, mem=1.5)     # SRAMs are macro cells, few std cells
    return _model(logic, warps, threads) / _model(logic, 1, 1)


@dataclasses.dataclass(frozen=True)
class Efficiency:
    cycles: int
    power_mw: float

    @property
    def perf(self) -> float:
        return 1.0 / max(self.cycles, 1)

    @property
    def perf_per_watt(self) -> float:
        return self.perf / (self.power_mw * 1e-3)


def power_efficiency(cycles: int, warps: int, threads: int) -> Efficiency:
    """Fig 10's metric: performance per watt for a benchmark run."""
    return Efficiency(cycles=cycles, power_mw=power_mw(warps, threads))
