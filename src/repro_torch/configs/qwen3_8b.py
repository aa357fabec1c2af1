"""qwen3-8b — dense; GQA with qk-norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig, register

QWEN3_8B = register(ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    attn_kind="global",
    qk_norm=True,
    mlp_act="swiglu",
    rope_theta=1000000.0,
    source="[hf:Qwen/Qwen3-8B; hf]",
))
