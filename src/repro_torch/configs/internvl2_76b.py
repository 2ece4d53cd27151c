"""internvl2-76b — VLM: InternViT frontend (STUB) + 76B LLM backbone.

[arXiv:2404.16821; unverified]
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256

Per the brief the modality frontend is a stub: `input_specs()` provides
precomputed patch embeddings [B, num_patch_tokens, d_model] which the
backbone prepends to the token embeddings.  The backbone is the assigned
transformer.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128_256,
    num_patch_tokens=256,
    rope_theta=1_000_000.0,
)
