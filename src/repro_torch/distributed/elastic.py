"""Elastic scaling & straggler mitigation: the twin of
``repro.distributed.elastic``.

Checkpoints are mesh-agnostic (``checkpoint/store.py`` saves whole
arrays), so an elastic re-scale restores the same tree under a
different mesh's placements.  This module keeps the books around that:

  * plan_rescale        — map an old mesh shape to a new one, validating
                          that the global batch stays divisible;
  * reshard_like        — place a restored host tree onto a new mesh
                          (``distribute_tensor``, the twin of
                          ``jax.device_put`` with a ``NamedSharding``);
  * StragglerPolicy     — the data-skip contract: workers that fall behind
                          a barrier deadline skip forward to the fleet's
                          step (the (seed, step)-addressed pipeline makes
                          that a cursor bump, not a data-shuffle);
  * PodMasks, Fleet     — the fleet's pod masks and per-step protocol
                          (host logic, copied).

Vortex framing: a pod is a warp — the fleet scheduler keeps an
active/stalled(straggler)/barrier(checkpoint-sync) mask over pods and
reschedules work exactly like the 4-mask warp scheduler (§IV-B).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor
from torch.utils import _pytree as pytree

from repro_torch.distributed import sharding as shd


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    global_batch: int

    @property
    def dp_old(self) -> int:
        return int(np.prod(self.old_shape[:-1]))

    @property
    def dp_new(self) -> int:
        return int(np.prod(self.new_shape[:-1]))

    def validate(self) -> None:
        if self.global_batch % self.dp_new:
            raise ValueError(
                f"global batch {self.global_batch} not divisible by new DP "
                f"width {self.dp_new}; adjust batch or pods")


def plan_rescale(old_mesh, new_mesh, global_batch: int) -> RescalePlan:
    """The meshes' shapes in axis order (``DeviceMesh.shape``)."""
    plan = RescalePlan(tuple(old_mesh.shape), tuple(new_mesh.shape),
                       global_batch)
    plan.validate()
    return plan


def reshard_like(host_tree: Any, spec_tree: Any, mesh, rules=None) -> Any:
    """Place a (restored, host-resident) tree onto `mesh` per its logical
    spec tree — the second half of an elastic rescale.  Each leaf
    becomes a DTensor whose local shard is the slice a ``NamedSharding``
    gives the rank's device; a dimension that does not divide its mesh
    axes stays whole (``tree_shardings_checked``).  A collective: every
    rank of the mesh calls it with the same tree; leaves move to the
    mesh's device type."""
    rules = rules or shd.train_rules(mesh)
    placements = shd.tree_shardings_checked(spec_tree, host_tree, mesh,
                                            rules)
    dev = torch.device(mesh.device_type)

    def put(leaf, pl):
        t = torch.as_tensor(np.asarray(leaf)) \
            if not isinstance(leaf, torch.Tensor) else leaf
        return distribute_tensor(t.to(dev), mesh, list(pl))
    return pytree.tree_map(put, host_tree, placements)


@dataclasses.dataclass
class StragglerPolicy:
    """Deadline-based straggler mitigation for the synchronous step.

    A worker that misses `deadline_s` for a step barrier marks itself
    stalled, skips its contribution (the fleet reduces over a masked mean),
    and fast-forwards its data cursor to the fleet step on rejoin."""
    deadline_s: float = 30.0
    max_consecutive_skips: int = 5

    def should_skip(self, barrier_wait_s: float, consecutive: int) -> bool:
        return (barrier_wait_s > self.deadline_s
                and consecutive < self.max_consecutive_skips)

    def rejoin_cursor(self, fleet_step: int) -> int:
        """(seed, step) addressing => rejoining is a cursor assignment."""
        return fleet_step


@dataclasses.dataclass
class PodMasks:
    """The fleet-level 4-mask scheduler state (pods as warps)."""
    n_pods: int

    def __post_init__(self):
        self.active = np.ones(self.n_pods, bool)
        self.stalled = np.zeros(self.n_pods, bool)
        self.barrier = np.zeros(self.n_pods, bool)

    def healthy(self) -> np.ndarray:
        return self.active & ~self.stalled & ~self.barrier

    def mark_straggler(self, pod: int) -> None:
        self.stalled[pod] = True

    def rejoin(self, pod: int) -> None:
        self.stalled[pod] = False

    def fail(self, pod: int) -> None:
        self.active[pod] = False


class Fleet:
    """PodMasks + StragglerPolicy glued into the per-step protocol the
    fleet train step consumes.

    Each step the launcher reports every pod's barrier wait via
    `note_waits`; pods past the policy deadline are marked stalled
    (skipped in the masked-mean reduce), pods that come back rejoin, and
    a pod that exhausts `max_consecutive_skips` is failed permanently.
    `healthy()` is the float mask handed to `make_fleet_train_step`.
    Transitions are counted in an optional obs registry
    (`fleet.pod_skips`, `fleet.pod_fails`) and the live healthy count is
    exported as the `fleet.pods_healthy` gauge.
    """

    def __init__(self, n_pods: int,
                 policy: Optional[StragglerPolicy] = None,
                 registry: Any = None):
        self.masks = PodMasks(n_pods)
        self.policy = policy or StragglerPolicy()
        self.metrics = registry
        self.consecutive = np.zeros(n_pods, np.int32)

    def note_waits(self, waits_s) -> np.ndarray:
        """Fold one step's per-pod barrier waits into the masks; returns
        the healthy mask for this step."""
        waits = np.asarray(waits_s, np.float64)
        for pod in range(self.masks.n_pods):
            if not self.masks.active[pod]:
                continue
            if self.policy.should_skip(float(waits[pod]),
                                       int(self.consecutive[pod])):
                self.masks.mark_straggler(pod)
                self.consecutive[pod] += 1
                if self.metrics is not None:
                    self.metrics.counter("fleet.pod_skips").inc()
            elif waits[pod] > self.policy.deadline_s:
                # still late but out of skip budget: the pod is gone
                self.masks.fail(pod)
                if self.metrics is not None:
                    self.metrics.counter("fleet.pod_fails").inc()
            else:
                if self.masks.stalled[pod]:
                    self.masks.rejoin(pod)
                self.consecutive[pod] = 0
        healthy = self.healthy()
        if self.metrics is not None:
            self.metrics.gauge("fleet.pods_healthy").set(int(healthy.sum()))
        return healthy

    def healthy(self) -> np.ndarray:
        return self.masks.healthy().astype(np.float32)

    def n_healthy(self) -> int:
        return int(self.masks.healthy().sum())
