from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeSpec,
    get_config,
    list_configs,
    shape_applicable,
)

__all__ = [
    "SHAPES", "ModelConfig", "MoEConfig", "SSMConfig", "ShapeSpec",
    "get_config", "list_configs", "shape_applicable",
]
