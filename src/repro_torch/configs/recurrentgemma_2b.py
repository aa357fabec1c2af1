"""recurrentgemma-2b (Griffin) — hybrid: RG-LRU recurrent blocks + local
attention in a 2:1 pattern. [arXiv:2402.19427; hf]"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig, register

RECURRENTGEMMA_2B = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,          # MQA on the local-attention blocks
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    attn_kind="hybrid_rglru",
    window=2048,
    mlp_act="geglu",
    rope_theta=10000.0,
    embed_scale=True,
    tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=2560, recurrent_per_attn=2, conv1d_width=4),
    source="[arXiv:2402.19427; hf]",
))
