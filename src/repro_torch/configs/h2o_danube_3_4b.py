"""h2o-danube-3-4b — dense; llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""
from repro_torch.configs.base import ModelConfig, register

H2O_DANUBE_3_4B = register(ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    attn_kind="swa",
    window=4096,
    mlp_act="swiglu",
    rope_theta=10000.0,
    source="[arXiv:2401.16818; unverified]",
))
