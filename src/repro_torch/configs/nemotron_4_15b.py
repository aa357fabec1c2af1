"""nemotron-4-15b — dense; GQA, squared-ReLU MLP. [arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig, register

NEMOTRON_4_15B = register(ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    attn_kind="global",
    mlp_act="sqrelu",
    norm="layernorm",
    rope_theta=10000.0,
    source="[arXiv:2402.16819; unverified]",
))
