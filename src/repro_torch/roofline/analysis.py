"""Roofline analysis of one step: the twin of ``repro.roofline.analysis``.

Three terms per (arch x shape x mesh) cell, all in seconds:

  compute    = FLOPs a device / peak bf16 FLOP/s
  memory     = bytes a device / HBM bandwidth
  collective = sum over collective ops of wire bytes / link bandwidth

The cost comes from ``op_cost``, in one of two kinds (``per_device``):
a walk of the partitioned step on one device's shards (the dense and
vlm families on a DTensor mesh), which is already a device's, as the
JAX package's per-partition counts are, its redundancy (work every
rank of an axis repeats) included, and ``hlo_flops_global`` is it times
``n_chips``; or a walk of the whole, unpartitioned step (the global
batch; the other families), which the compute and memory terms divide
by ``n_chips``, an ideal partition where every chip gets an equal
share of every op and nothing is computed twice.  The wire bytes are
already a device's in both
(``op_cost`` charges each collective with its per-device operand).  The
link rate is the chip's node-spanning one whenever ``n_chips`` exceeds
a node (``hw.Chip.link_bw``).

Collective wire bytes, ring models over the op's group size n
(``ring_wire_bytes``, which ``op_cost`` calls too):

  all-reduce         2 * s * (n-1)/n     (reduce-scatter + all-gather phases)
  all-gather         r * (n-1)/n         (r = result bytes a device)
  reduce-scatter     s * (n-1)/n
  all-to-all         s * (n-1)/n
  collective-permute s

where s is the per-device operand bytes.  The JAX package parses them
out of HLO text (``parse_collectives``); the port has no HLO, so that
parser has no twin: ``op_cost`` sees the c10d ops themselves.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict

from repro_torch.roofline.hw import H100, Chip

if TYPE_CHECKING:
    from repro_torch.roofline.op_cost import StepCost


def ring_wire_bytes(kind: str, s_bytes: float, r_bytes: float,
                    n: int) -> float:
    """Ring-model bytes one device sends for a collective of `kind`
    ('all-reduce', 'all-gather', 'reduce-scatter', 'all-to-all' or
    'collective-permute') over a group of `n`, operand `s_bytes` and
    result `r_bytes` a device; 0 for a group of one."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * s_bytes * (n - 1) / n
    if kind == "all-gather":
        return r_bytes * (n - 1) / n
    if kind in ("reduce-scatter", "all-to-all"):
        return s_bytes * (n - 1) / n
    return float(s_bytes)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    wire_bytes: float
    model_flops: float                   # 6 N D (global)
    hlo_flops_global: float              # the walk's count (global)
    op_bytes: Dict[str, float]
    op_counts: Dict[str, int]
    per_device: bool = False             # cost was one device's

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def total_s(self) -> float:
        # lower bound: perfect overlap -> max; no overlap -> sum.  The
        # max (roofline convention), with the parts kept visible.
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): remat and redundancy."""
        return self.model_flops / max(self.hlo_flops_global, 1.0)

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound."""
        if self.total_s <= 0:
            return 0.0
        per_chip = self.model_flops / max(self.n_chips, 1)
        return per_chip / self.total_s / self.chip.peak_bf16_flops

    # set post-init
    n_chips: int = 0
    chip: Chip = H100


def analyze(cost: "StepCost", *, n_chips: int, model_flops: float,
            chip: Chip = H100, per_device: bool = False) -> Roofline:
    """Roofline terms of a step on `n_chips`: `cost` is one device's
    (`per_device`, a partitioned walk) or the whole step's, spread
    evenly over the chips; its collectives are per device either way."""
    n = max(n_chips, 1)
    div = 1 if per_device else n
    flops, bytes_ = cost.flops / div, cost.bytes / div
    r = Roofline(
        compute_s=flops / chip.peak_bf16_flops,
        memory_s=bytes_ / chip.hbm_bw,
        collective_s=cost.wire_bytes / chip.link_bw(n_chips),
        flops_per_device=flops,
        bytes_per_device=bytes_,
        wire_bytes=cost.wire_bytes,
        model_flops=model_flops,
        hlo_flops_global=cost.flops * (n if per_device else 1),
        op_bytes=dict(cost.coll_op_bytes),
        op_counts={k: int(v) for k, v in cost.coll_op_counts.items()},
        per_device=per_device,
    )
    r.n_chips = n_chips
    r.chip = chip
    return r
