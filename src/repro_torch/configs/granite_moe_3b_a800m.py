"""granite-moe-3b-a800m — MoE: 40 experts, top-8, d_expert=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

GRANITE_MOE_3B_A800M = register(ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,              # per-expert hidden
    vocab_size=49155,
    attn_kind="global",
    mlp_act="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8, d_expert=512),
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
))
