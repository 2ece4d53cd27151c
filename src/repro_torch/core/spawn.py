"""grid_spawn: the twin of ``repro.core.spawn``, pocl_spawn over a mesh.

The paper's 5-step work-group mapping (§III-A.3), with the mesh's ranks
playing the warps:

  1. query resources           -> mesh axis sizes
  2. divide the work           -> ceil-split the flat grid over ranks
  3. assign ID ranges          -> each rank gets a contiguous id range
  4. spawn warps / set masks   -> every rank runs the per-rank program;
                                  out-of-range ids get a zero lane mask
  5. per-warp loop over ids    -> a loop over the rank's chunk, the
                                  kernel sees (global_id, valid_mask)

Kernels are functions f(carry, gids, valid) -> carry over tensors;
invalid lanes must be neutral (the mask predicates every write, like
the hardware thread mask).  The ids are int64 tensors on the carry's
device (the JAX package's are int32).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.launch import mesh as mesh_mod


def _device(carry) -> torch.device:
    leaves = [t for t in pytree.tree_leaves(carry)
              if isinstance(t, torch.Tensor)]
    return leaves[0].device if leaves else torch.device("cpu")


def grid_spawn(kernel: Callable, n_items: int, *, mesh=None,
               axis_names: Optional[Sequence[str]] = None,
               items_per_step: int = 1, init: Any = None) -> Callable:
    """Build a launcher for `kernel` over a flat grid of n_items.

    kernel(carry, gids [items_per_step], valid [items_per_step]) -> carry.
    Without a mesh the launcher runs the whole grid as one program and
    returns the final carry.  With a mesh each rank runs its chunk (its
    index flattened over `axis_names`, the last axis fastest) and the
    launcher returns the ranks' partial carries gathered over those
    axes, a leading [n_dev] dim on every leaf, for the caller to combine
    (like per-warp accumulators the host reduces after a launch).  The
    ids live on the carry's device."""
    n_dev = 1
    if mesh is not None:
        axis_names = tuple(axis_names or mesh.mesh_dim_names)
        n_dev = mesh_mod.axis_size(mesh, axis_names)
    chunk = math.ceil(n_items / n_dev)
    steps = math.ceil(chunk / items_per_step)

    def device_program(dev_id: int, carry):
        base = dev_id * chunk
        lanes = torch.arange(items_per_step, device=_device(carry))
        for i in range(steps):
            gids = base + i * items_per_step + lanes
            # valid = inside the global grid AND inside this rank's range
            # (ranges don't overlap even when items_per_step doesn't
            # divide the chunk)
            valid = (gids < n_items) & (gids < base + chunk)
            carry = kernel(carry, gids, valid)
        return carry

    if mesh is None:
        return lambda carry=init: device_program(0, carry)

    def launcher(carry=init):
        out = device_program(mesh_mod.axis_index(mesh, axis_names), carry)
        group = mesh_mod.axis_group(mesh, axis_names)

        def gather(t):
            t = torch.as_tensor(t).contiguous()
            parts = [torch.empty_like(t) for _ in range(n_dev)]
            dist.all_gather(parts, t, group=group)
            return torch.stack(parts)
        return pytree.tree_map(gather, out)

    return launcher


def spawn_ranges(n_items: int, n_dev: int) -> Tuple[Tuple[int, int], ...]:
    """Step 3 in host form: the contiguous [start, end) id range per
    device (used by tests and the data loader's shard addressing)."""
    chunk = math.ceil(n_items / max(n_dev, 1))
    return tuple((min(d * chunk, n_items), min((d + 1) * chunk, n_items))
                 for d in range(n_dev))
