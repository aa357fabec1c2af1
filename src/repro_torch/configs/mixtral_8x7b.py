"""mixtral-8x7b — MoE: 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

MIXTRAL_8X7B = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,            # per-expert hidden
    vocab_size=32000,
    attn_kind="swa",
    window=4096,
    mlp_act="swiglu",
    rope_theta=1000000.0,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=14336),
    source="[arXiv:2401.04088; hf]",
))
