from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, RGLRUConfig, RWKVConfig, get_config, list_configs, register,
    smoke_config,
)
