"""minitron-4b — width/depth-pruned Nemotron with a 256k vocabulary.

[arXiv:2407.14679; hf]
32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000

The 256k vocab stresses the vocab-sharded embedding / logits path.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256_000,
    rope_theta=10_000.0,
)
