"""rwkv6-1.6b (Finch) — attention-free SSM with data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ModelConfig, RWKVConfig, register

RWKV6_1_6B = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # 2048 / head_dim 64
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    attn_kind="rwkv",
    mlp_act="sqrelu",      # rwkv channel-mix uses squared relu
    norm="layernorm",
    rwkv=RWKVConfig(head_dim=64),
    source="[arXiv:2404.05892; unverified]",
))
