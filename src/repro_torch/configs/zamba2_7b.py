"""zamba2-7b — hybrid: Mamba2 backbone + weight-shared attention blocks.

[arXiv:2411.15242; unverified]
81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64

Structure: 81 Mamba2 blocks; one weight-SHARED transformer block
(attention + MLP, single parameter set) is applied every 6 Mamba blocks
(zamba2's shared-block design).  SSM state carries long context, so
long_500k RUNS; for that cell the shared attention uses a sliding window
over the KV cache (windowed shared attention, documented in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, head_dim=64, expand=2, chunk=256),
    attn_every=6,
    rope_theta=10_000.0,
)
