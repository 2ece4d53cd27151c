"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf]
24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.

The sliding window makes decode sub-quadratic (the KV cache is a ring of
4096 positions).  About 1.83B params: bf16 weights, an fp32 master copy,
fp32 AdamW moments and fp32 accumulated grads fit one 80 GB card, so it
is the port's full-width training config.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10_000.0,
)
