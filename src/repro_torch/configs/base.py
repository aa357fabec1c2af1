"""Model configuration for the port: the paged-family subset of the JAX
package's ``configs/base.py`` (own copy — the port imports nothing of
``repro``). Field names and derived quantities match the reference so a
config means the same model on both sides."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention flavour ---
    attn_kind: str = "global"       # global | swa | local_global
    window: Optional[int] = None    # sliding-window size when applicable
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qk_norm: bool = False
    rope_theta: float = 10000.0

    mlp_act: str = "swiglu"         # swiglu | geglu
    norm: str = "rmsnorm"
    post_norms: bool = False        # gemma2-style post-attn/post-ffw norms
    embed_scale: bool = False       # gemma-style sqrt(d_model) embedding scale
    tie_embeddings: bool = False

    source: str = ""

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (pad logits are masked)."""
        return ((self.vocab_size + 255) // 256) * 256

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, length n_layers."""
        kinds = []
        for i in range(self.n_layers):
            if self.attn_kind == "local_global":
                kinds.append("attn_local" if i % 2 == 0 else "attn_global")
            elif self.attn_kind == "swa":
                kinds.append("attn_local")
            else:
                kinds.append("attn_global")
        return tuple(kinds)

    def param_count(self) -> int:
        """Approximate parameter count N (dense attention towers)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        qkv = d * self.n_heads * self.head_dim \
            + 2 * d * self.n_kv_heads * self.head_dim
        o = self.n_heads * self.head_dim * d
        mlp = (3 if self.mlp_act in ("swiglu", "geglu") else 2) * d * f
        n = self.n_layers * (qkv + o + mlp) + v * d
        if not self.tie_embeddings:
            n += v * d
        return n

    def active_param_count(self) -> int:
        return self.param_count()


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from repro_torch.configs import qwen3_8b  # noqa: F401


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """The reference's CPU-runnable variant of the same family (same
    shrink rule as the JAX package, so smoke weights line up 1:1)."""
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=min(cfg.n_layers, 4),
        d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16, d_ff=128, vocab_size=512,
        window=16 if cfg.window else None)
