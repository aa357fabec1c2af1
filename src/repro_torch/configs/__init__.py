from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, RGLRUConfig, RWKVConfig, get_config,
    list_configs, register, smoke_config,
)
