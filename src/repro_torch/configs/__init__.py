from repro_torch.configs.base import (  # noqa: F401
    EncoderConfig, ModelConfig, MoEConfig, RGLRUConfig, RWKVConfig,
    VisionConfig, get_config, list_configs, register, smoke_config,
)
