"""Model configuration for the PyTorch port: a copy of
``repro.configs.base`` (the model dataclasses, ``ShapeConfig`` and
``TrainConfig``, and the dry run's four shape cells).
Configs are frozen dataclasses so they hash and can key caches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0          # routed experts
    top_k: int = 0
    num_shared: int = 0           # shared (always-on) experts (DeepSeek-MoE)
    d_ff: int = 0                 # per-expert hidden size (fine-grained)
    first_k_dense: int = 0        # first K layers use a dense FFN instead
    dense_d_ff: int = 0           # hidden size of those dense layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 0              # Mamba2 SSM state size
    d_conv: int = 4               # depthwise causal conv width
    head_dim: int = 64            # SSD head dim (P)
    expand: int = 2               # d_inner = expand * d_model
    chunk: int = 256              # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio | xlstm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # SWA window (h2o-danube)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # hybrid (zamba2): one weight-shared attention block applied every
    # `attn_every` mamba blocks.
    attn_every: int = 0
    # xlstm: block kinds, cycled over layers ('m' = mLSTM, 's' = sLSTM)
    xlstm_pattern: Tuple[str, ...] = ()
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_ctx: int = 1500       # whisper: 30s of audio at 50 fps
    # vlm: number of prepended patch-embedding tokens provided by the
    # (stubbed) vision frontend.
    num_patch_tokens: int = 0
    dtype: str = "bfloat16"

    # ---- derived ---------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.moe.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "xlstm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode path exists (SSM state, recurrence, or SWA)."""
        return (self.family in ("ssm", "hybrid", "xlstm")
                or self.sliding_window is not None)

    def param_count(self) -> int:
        """Total parameters (exact, from the port's spec builders)."""
        from repro_torch.models.api import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.api import count_params_analytic
        return count_params_analytic(self, active_only=True)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input-shape configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256,
                       kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32,
                          kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128,
                         kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1,
                        kind="decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The shape cells that are well-defined for an architecture:
    long_500k needs a sub-quadratic decode path (SSM, recurrence or a
    sliding window); the pure full-attention archs skip it."""
    out = []
    for s in ALL_SHAPES:
        if s.name == "long_500k" and not cfg.supports_long_context:
            continue
        out.append(s)
    return tuple(out)


# ---------------------------------------------------------------------------
# Training hyperparameters (the JAX package's defaults)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatch: Optional[int] = None   # grad-accum microbatch (None = off)
    remat: str = "full"                # full | dots | none
    seed: int = 0
    # fault tolerance
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    # skip the optimizer update when the global grad norm is non-finite
    # or exceeds this threshold (0.0 = spike skipping disabled; non-finite
    # grads are still applied as-is when disabled, preserving old behavior)
    grad_skip_threshold: float = 0.0
    # gradient compression across the pod (DP) axis
    grad_compression: str = "none"     # none | int8
