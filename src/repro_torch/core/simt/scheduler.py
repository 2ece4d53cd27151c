"""Warp scheduler: the paper's 4-mask design (§IV-B, Fig 6).

Masks (all [W] bool tensors):
  active   — warp holds work (set by wspawn, cleared by tmc 0 / ecall)
  stalled  — temporarily unschedulable (memory miss, decode-stall);
             here: stalled_until > cycle
  barrier  — parked on a warp barrier until the release mask fires
  visible  — the hierarchical-scheduling window [18]: each cycle one warp
             is picked from `visible` and invalidated; when `visible`
             drains, it refills from active & ~stalled & ~barrier.

Pure mask algebra on bool tensors, the twin of
``repro.core.simt.scheduler``.  The lowest set index is computed
explicitly (``argmax`` on bool tensors is not supported on every
backend).
"""
from __future__ import annotations

from typing import Tuple

import torch


def schedulable(active, stalled, barrier):
    return active & ~stalled & ~barrier


def refill_if_empty(visible, active, stalled, barrier):
    """When the visible window holds no schedulable warp, refill it from
    the schedulable set (Fig 6a cycle 3; Fig 6c's wspawn pickup happens
    here too, because the spawned warps joined `active`).  Stalled /
    barrier-parked warps are masked out of the window every cycle
    (Fig 6b), so a window full of newly-stalled warps refills immediately
    instead of burning a bubble cycle."""
    sched = schedulable(active, stalled, barrier)
    masked = visible & sched
    return torch.where(masked.any(), masked, sched)


def first_set(mask: torch.Tensor) -> torch.Tensor:
    """Lowest index whose entry is True, or ``len(mask)`` when none is
    (a 0-dim int64 tensor on the mask's device)."""
    n = mask.shape[0]
    iota = torch.arange(n, device=mask.device)
    return torch.where(mask, iota, n).min()


def select(visible) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick the lowest-id visible warp; invalidate it (Fig 6a cycle 1->2).

    Returns (warp_id, new_visible).  warp_id == W (out of range) when no
    warp is schedulable this cycle (pure stall cycle)."""
    W = visible.shape[0]
    wid = first_set(visible)
    new_visible = visible & (torch.arange(W, device=visible.device) != wid)
    return wid, new_visible


def step_masks(visible, active, stalled, barrier):
    """One scheduling decision: refill-if-empty then select.
    Returns (warp_id, new_visible)."""
    visible = refill_if_empty(visible, active, stalled, barrier)
    return select(visible)
