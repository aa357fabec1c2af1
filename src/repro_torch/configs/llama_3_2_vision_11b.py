"""llama-3.2-vision-11b — VLM; a gated cross-attention block after every
5th self-attention layer. The vision tower is a stub: requests carry
precomputed patch embeddings. [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]"""
from repro_torch.configs.base import ModelConfig, VisionConfig, register

LLAMA_3_2_VISION_11B = register(ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    attn_kind="global",
    mlp_act="swiglu",
    rope_theta=500000.0,
    vision=VisionConfig(cross_attn_every=5, n_patches=1601),
    source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
))
