"""Request scheduler for continuous batching, built from the Vortex warp
scheduler's 4-mask design (§IV-B) — the mask algebra is a host-side
NumPy mirror of the cycle-level simulator's functions
(repro.core.simt.scheduler), kept bit-exact by an equivalence test.
A copy of repro.serving.scheduler without its ``hw`` re-export:

  warp                    <->  request slot
  active mask             <->  slot holds a live request
  stalled mask            <->  request admitted but not yet prefilled
                               (waiting on "memory" — the KV cache fill)
  barrier mask            <->  slots parked for group-synchronous steps
                               (e.g. beam/ensemble groups)
  visible mask + refill   <->  the two-level scheduling window: each decode
                               tick selects up to `width` visible slots,
                               invalidates them, and refills when drained —
                               giving older requests the same round-robin
                               fairness hierarchical warp scheduling gives
                               warps [18].
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

__all__ = ["RequestScheduler", "step_masks_np"]


def step_masks_np(visible: np.ndarray, active: np.ndarray,
                  stalled: np.ndarray,
                  barrier: np.ndarray) -> Tuple[int, np.ndarray]:
    """NumPy mirror of `repro.core.simt.scheduler.step_masks`
    (refill-if-empty then select).

    The engine calls this up to `width` times per decode tick; the jnp
    reference's eager op dispatch dominated tick time at serving scale.
    tests assert bit-exact equivalence against the simulator over
    random mask states, so the serving scheduler still IS the Vortex
    4-mask algebra — just on host arrays."""
    sched = active & ~stalled & ~barrier
    masked = visible & sched
    vis = masked if masked.any() else sched
    if not vis.any():
        return len(vis), vis        # pure stall cycle (wid out of range)
    wid = int(np.argmax(vis))
    new_vis = vis.copy()
    new_vis[wid] = False
    return wid, new_vis


@dataclasses.dataclass
class RequestScheduler:
    n_slots: int

    def __post_init__(self):
        z = np.zeros(self.n_slots, bool)
        self.active = z.copy()
        self.stalled = z.copy()
        self.barrier = z.copy()
        self.visible = z.copy()
        # chunked-prefill refinement: a stalled slot is no longer an
        # opaque "waiting on memory" state — it makes chunk-granular
        # progress every tick while staying excluded from decode issue.
        # `prefill_progress` counts chunks appended so far (observability
        # + fairness audits); it is NOT part of the issue masks.
        self.prefill_progress = np.zeros(self.n_slots, np.int64)

    # -- mask ops (delegating to the hardware-model mask algebra) ----------

    def _select_batch(self, width: int) -> List[int]:
        picked: List[int] = []
        visible = self.visible
        for _ in range(width):
            wid, visible = step_masks_np(visible, self.active,
                                         self.stalled, self.barrier)
            if wid >= self.n_slots or wid in picked:
                # a slot issues at most once per tick (a warp cannot be
                # re-issued before its instruction completes)
                break
            picked.append(wid)
        self.visible = visible.copy()         # writable copy
        return picked

    # -- lifecycle ----------------------------------------------------------

    def admit(self) -> int:
        """Claim a free slot (active+stalled until prefill completes);
        -1 if the pool is full."""
        free = np.flatnonzero(~self.active)
        if len(free) == 0:
            return -1
        s = int(free[0])
        self.active[s] = True
        self.stalled[s] = True
        return s

    def prefill_targets(self) -> np.ndarray:
        """Slots that should receive a prefill chunk this tick: admitted,
        still stalled on their KV fill, and not parked at a barrier
        (barrier groups park *whole* requests — prefilling a parked slot
        would let it race ahead of its group)."""
        return np.flatnonzero(self.active & self.stalled & ~self.barrier)

    def prefill_step(self, slot: int) -> None:
        """One chunk of prefill progress: the slot stays stalled (no
        decode issue) but is recorded as progressing, the warp-scheduler
        analogue of a memory-wait whose fill is streaming in."""
        self.prefill_progress[slot] += 1

    def prefill_done(self, slot: int) -> None:
        self.stalled[slot] = False

    def retire(self, slot: int) -> None:
        self.active[slot] = False
        self.stalled[slot] = False
        self.barrier[slot] = False
        self.visible[slot] = False
        self.prefill_progress[slot] = 0

    def schedulable(self) -> np.ndarray:
        return self.active & ~self.stalled & ~self.barrier

    def next_batch(self, width: int) -> List[int]:
        """Slots to decode this tick (the warp-issue analogue)."""
        return self._select_batch(width)
