"""Hardware constants for the roofline model: the twin of
``repro.roofline.hw``.

``V5E`` and ``DTYPE_BYTES`` are the JAX package's (TPU v5e as its brief
gives it); the tests hold the port's arithmetic to JAX's with them.

``H100`` is the card the port runs on, an NVIDIA H100 SXM5 80GB at its
700 W limit, from NVIDIA's H100 Tensor Core GPU data sheet (SXM column):
989 TFLOP/s dense bf16 on the tensor cores (1979 is the sparse figure),
3.35 TB/s of HBM3 and 80 GB of it.  Its link rate is what one GPU sends
a direction: 450 GB/s over NVLink 4 (18 links of 25 GB/s) to the other
seven GPUs of an 8-GPU HGX/DGX H100 node (``link_bw``), and 50 GB/s for
a group that spans nodes (``internode_bw``: one 400 Gb/s ConnectX-7 NIC
a GPU, the DGX H100 layout).  A card may be set below 700 W and then
runs slower under load: a measured time names the card's power limit.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str = "tpu-v5e"
    peak_bf16_flops: float = 197e12      # FLOP/s per chip
    hbm_bw: float = 819e9                # bytes/s per chip
    ici_link_bw: float = 50e9            # bytes/s per link (brief's constant)
    hbm_bytes: float = 16e9              # capacity, for fit checks
    # the rate of a group that spans nodes (None: ici_link_bw everywhere)
    internode_bw: float | None = None
    node_chips: int = 0                  # chips a node (0: one domain)

    def link_bw(self, n_chips: int) -> float:
        """Bytes/s a chip sends a direction in a group of `n_chips`: the
        node's links up to ``node_chips``, the node-spanning rate past
        it."""
        if self.internode_bw is not None and n_chips > self.node_chips:
            return self.internode_bw
        return self.ici_link_bw


V5E = Chip()

H100 = Chip(name="h100-sxm5-80gb", peak_bf16_flops=989e12, hbm_bw=3.35e12,
            ici_link_bw=450e9, hbm_bytes=80e9, internode_bw=50e9,
            node_chips=8)

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "token": 0,
    "s4": 1, "u4": 1,
}
