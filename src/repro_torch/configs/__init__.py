from repro_torch.configs.base import (  # noqa: F401
    SHAPES, EncoderConfig, ModelConfig, MoEConfig, RGLRUConfig, RWKVConfig,
    ShapeConfig, VisionConfig, get_config, list_configs, register,
    shape_applicable, smoke_config,
)
