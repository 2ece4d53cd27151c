"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed experts, top-6.

[arXiv:2401.06066; hf]
28L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=102400

Following the HF config, the first layer uses a dense FFN
(first_k_dense_replace=1, intermediate_size=10944); the remaining layers are
MoE with 2 shared experts that every token passes through (the "uniform
path" — Vortex's split-is-a-nop case) plus 64 routed experts top-6
(the "divergent path").
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_ff=1408,
                  first_k_dense=1, dense_d_ff=10944),
    rope_theta=10_000.0,
)
