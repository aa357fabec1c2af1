"""gemma2-9b — dense; local(4096)+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig, register

GEMMA2_9B = register(ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    attn_kind="local_global",
    window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_act="geglu",
    rope_theta=10000.0,
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    source="[arXiv:2408.00118; hf]",
))
