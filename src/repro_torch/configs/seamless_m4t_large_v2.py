"""seamless-m4t-large-v2 — enc-dec multimodal (audio). The speech frontend
is a stub: requests carry precomputed frame embeddings.
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import EncoderConfig, ModelConfig, register

SEAMLESS_M4T_LARGE_V2 = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,           # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    attn_kind="global",
    mlp_act="sqrelu",      # relu-family FFN (conformer-style tower simplified)
    norm="layernorm",
    encoder=EncoderConfig(n_layers=24, n_frames=4096),
    source="[arXiv:2308.11596; hf]",
))
