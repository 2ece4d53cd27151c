"""Architecture registry: ``--arch <id>`` resolution.

A copy of ``repro.configs.registry`` that lists only the architectures
whose family the port runs (the dense, MoE and hybrid-SSM families).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

# arch id -> module name (one file per architecture the port runs)
_ARCH_MODULES = {
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests: same family/topology, tiny sizes.
# ---------------------------------------------------------------------------

def reduced_config(arch: str) -> ModelConfig:
    """A small config of the same family for one-step CPU smoke tests."""
    cfg = get_config(arch)
    kw = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        num_patch_tokens=min(cfg.num_patch_tokens, 8),
        encoder_ctx=32 if cfg.is_encoder_decoder else cfg.encoder_ctx,
        encoder_layers=min(cfg.encoder_layers, 2),
        sliding_window=16 if cfg.sliding_window else None,
        attn_every=3 if cfg.attn_every else 0,
    )
    if cfg.is_moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8,
            top_k=min(cfg.moe.top_k, 2),
            d_ff=64, dense_d_ff=128 if cfg.moe.first_k_dense else 0)
    if cfg.ssm.d_state:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32, chunk=16)
    if cfg.family == "xlstm":
        kw["num_heads"] = 2
        kw["num_kv_heads"] = 2
    return cfg.replace(**kw)
