"""Model configuration for the port: the model half of the JAX package's
``configs/base.py`` (every family it serves: dense, MoE, recurrent,
hybrid, enc-dec and VLM), an own copy — the port imports nothing of
``repro``. Field names and derived quantities match
the reference so a config means the same model on both sides."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int          # per-expert FFN hidden size
    router_jitter: float = 0.0
    # tokens an expert keeps per capacity group, as a multiple of its fair
    # share (top_k / n_experts of the group); the rest are dropped for it
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower of an enc-dec model (seamless-m4t). The speech
    frontend is a stub: requests carry precomputed frame embeddings
    (1, n_frames, d_model)."""
    n_layers: int
    n_frames: int          # encoder sequence length


@dataclass(frozen=True)
class VisionConfig:
    """Cross-attention vision adapter of a VLM (llama-3.2-vision). The
    vision tower is a stub: requests carry precomputed patch embeddings
    (1, n_patches, d_model)."""
    cross_attn_every: int  # a cross block after every N self-attn layers
    n_patches: int


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    # interval (tokens) at which the engine checkpoints recurrent state so
    # prefix-cache hits can resume from the nearest boundary (DESIGN.md §4)
    state_ckpt_interval: int = 256


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int
    # block pattern: this many recurrent blocks per attention block
    recurrent_per_attn: int = 2
    conv1d_width: int = 4
    state_ckpt_interval: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention flavour ---
    attn_kind: str = "global"       # global | swa | local_global | hybrid_rglru | rwkv
    window: Optional[int] = None    # sliding-window size when applicable
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qk_norm: bool = False
    rope_theta: float = 10000.0

    mlp_act: str = "swiglu"         # swiglu | geglu | sqrelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    post_norms: bool = False        # gemma2-style post-attn/post-ffw norms
    embed_scale: bool = False       # gemma-style sqrt(d_model) embedding scale
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    rwkv: Optional[RWKVConfig] = None
    rglru: Optional[RGLRUConfig] = None

    source: str = ""

    @property
    def subquadratic(self) -> bool:
        """True when a 500k-token decode context has bounded (or
        mesh-shardable-bounded) attention state: SSM / hybrid / SWA /
        alternating local-global."""
        return self.attn_kind in ("rwkv", "hybrid_rglru", "swa",
                                  "local_global")

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (pad logits are masked)."""
        return ((self.vocab_size + 255) // 256) * 256

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, length n_layers."""
        kinds = []
        for i in range(self.n_layers):
            if self.attn_kind == "rwkv":
                kinds.append("rwkv")
            elif self.attn_kind == "hybrid_rglru":
                period = self.rglru.recurrent_per_attn + 1
                kinds.append("attn_local"
                             if i % period == self.rglru.recurrent_per_attn
                             else "rglru")
            elif self.attn_kind == "local_global":
                kinds.append("attn_local" if i % 2 == 0 else "attn_global")
            elif self.attn_kind == "swa":
                kinds.append("attn_local")
            else:
                kinds.append("attn_global")
        return tuple(kinds)

    def cross_attn_layers(self) -> Tuple[int, ...]:
        """Decoder layers a VLM's gated cross block follows (empty for
        every other model; an enc-dec model's cross blocks follow every
        layer, ``models/transformer.py::cross_schedule``)."""
        if self.vision is None:
            return ()
        k = self.vision.cross_attn_every
        return tuple(i for i in range(self.n_layers) if (i + 1) % k == 0)

    def param_count(self) -> int:
        """Approximate parameter count N, counted as the reference counts
        it per layer kind."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        qkv = d * self.n_heads * self.head_dim \
            + 2 * d * self.n_kv_heads * self.head_dim
        o = self.n_heads * self.head_dim * d
        n = 0
        for kind in self.layer_kinds():
            if kind == "rwkv":
                # time-mix (r,k,v,g,o + decay/aaa) + channel mix (k,v,r)
                n += 6 * d * d + 2 * d * f + d * f
            elif kind == "rglru":
                w = self.rglru.lru_width
                n += 2 * d * w + w * d + 2 * w * self.rglru.conv1d_width \
                    + self._mlp_params(d, f)
            else:
                n += qkv + o + self._mlp_params(d, f)
        # the cross blocks' attention (the reference leaves their norms and
        # the VLM blocks' MLPs out of the count)
        n += len(self.cross_attn_layers()) * (qkv + o)
        if self.encoder is not None:
            n += self.encoder.n_layers * (qkv + o + self._mlp_params(d, f))
            n += self.n_layers * (qkv + o)
        n += v * d
        if not self.tie_embeddings:
            n += v * d
        return n

    def _mlp_mult(self) -> int:
        return 3 if self.mlp_act in ("swiglu", "geglu") else 2

    def _mlp_params(self, d: int, f: int) -> int:
        if self.moe is not None:
            e = self.moe
            return e.n_experts * self._mlp_mult() * d * e.d_expert \
                + d * e.n_experts                               # + router
        return self._mlp_mult() * d * f

    def active_param_count(self) -> int:
        """Parameters a token runs through (MoE: its top-k experts only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        per = self._mlp_mult() * self.d_model * e.d_expert
        return self.param_count() \
            - (e.n_experts - e.top_k) * per * self.n_layers

    def tp_heads_ok(self, tp: int) -> bool:
        """The query heads split evenly over ``tp`` ranks (the reference's
        ``tp_heads_ok``, ``configs/base.py:205``)."""
        return self.n_heads % tp == 0


# ---------------------------------------------------------------------------
# Input shapes: every LM-family arch is paired with these four (the
# reference's ``configs/base.py:216-238``).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and why not when skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k decode context "
                       "skipped per assignment")
    return True, ""


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
    from repro_torch.configs import (  # noqa: F401
        gemma2_9b, granite_moe_3b_a800m, h2o_danube_3_4b,
        llama_3_2_vision_11b, mixtral_8x7b, nemotron_4_15b, qwen3_8b,
        recurrentgemma_2b, rwkv6_1_6b, seamless_m4t_large_v2,
    )


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """The reference's CPU-runnable variant of the same family (same
    shrink rule as the JAX package, so smoke weights line up 1:1)."""
    changes: dict = dict(
        name=cfg.name + "-smoke", n_layers=min(cfg.n_layers, 4),
        d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16, d_ff=128, vocab_size=512,
        window=16 if cfg.window else None)
    if cfg.moe is not None:
        # drop-free capacity: chunked prefill, decode and the teacher-forced
        # forward then agree exactly
        changes["moe"] = MoEConfig(n_experts=4, top_k=min(cfg.moe.top_k, 2),
                                   d_expert=32, capacity_factor=100.0)
    if cfg.encoder is not None:
        changes["encoder"] = EncoderConfig(n_layers=2, n_frames=24)
    if cfg.vision is not None:
        # n_layers stays a multiple of cross_attn_every (the reference's
        # group tower)
        changes["vision"] = VisionConfig(cross_attn_every=2, n_patches=16)
    if cfg.rwkv is not None:
        changes["rwkv"] = RWKVConfig(head_dim=16, state_ckpt_interval=8)
        changes["n_kv_heads"] = 4
    if cfg.rglru is not None:
        changes["rglru"] = RGLRUConfig(
            lru_width=64, recurrent_per_attn=cfg.rglru.recurrent_per_attn,
            conv1d_width=4, state_ckpt_interval=8)
        changes["n_layers"] = min(cfg.n_layers, 6)
        changes["n_kv_heads"] = 1
    return dataclasses.replace(cfg, **changes)
