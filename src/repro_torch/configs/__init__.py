from repro_torch.configs.base import (ALL_SHAPES, SHAPES_BY_NAME, ModelConfig,
                                      MoEConfig, SSMConfig, ShapeConfig,
                                      TrainConfig, applicable_shapes)
from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config

__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "TrainConfig",
    "ALL_SHAPES", "SHAPES_BY_NAME", "applicable_shapes",
    "ARCH_IDS", "get_config", "reduced_config",
]
