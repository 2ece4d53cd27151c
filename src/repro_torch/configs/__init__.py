from repro_torch.configs.base import (ModelConfig, MoEConfig, SSMConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config

__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "TrainConfig",
    "ARCH_IDS", "get_config", "reduced_config",
]
