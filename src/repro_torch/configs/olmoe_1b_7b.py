"""olmoe-1b-7b — MoE, 64 experts top-8, fine-grained expert FFN.

[arXiv:2409.02060; hf]
16L d_model=2048 16H (GQA kv=16) expert d_ff=1024 vocab=50304, 64e top-8
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,                 # per-expert hidden (kept for reference)
    vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff=1024),
    rope_theta=10_000.0,
)
