"""whisper-tiny — encoder-decoder audio transformer; conv frontend STUB.

[arXiv:2212.04356; unverified]
4L d_model=384 6H d_ff=1536 vocab=51865, enc-dec

Per the brief the conv frontend is a stub: `input_specs()` provides
precomputed frame embeddings [B, 1500, d_model] (30 s of audio after the
conv downsampler).  Encoder: 4 bidirectional layers with sinusoidal
positions; decoder: 4 causal layers with cross-attention.  Decode shapes
exercise the decoder self-attn KV cache at the assigned seq_len plus the
fixed 1500-frame cross-attention KV.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,               # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_layers=4,
    encoder_ctx=1500,
)
