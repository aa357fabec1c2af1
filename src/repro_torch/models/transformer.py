"""Paged-family transformer of the port (the dense-tower half of
``repro/models/transformer.py``): parameter init with the reference's
distributions, embedding / unembedding, the per-layer window schedule, the
two halves of an attention block that the runners wrap around their
attention kernels, and a teacher-forced dense ``forward`` for the tests.

Parameters are a plain dict mirroring the JAX pytree: per-layer tensors
are stacked on a leading layer axis under ``blocks``."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

GLOBAL_WINDOW = 2 ** 30  # sentinel "window" meaning full causal attention


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device="cuda") -> Dict[str, Any]:
    """Random weights with the reference's distributions
    (``transformer.py:82-125``), drawn from ``gen`` on ``device`` one layer
    at a time so a full-width model never holds an fp32 copy. Norm scales
    are fp32 zeros (the ``(1 + w)`` form)."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params on {dev}")
    if cfg.attn_kind not in ("global", "swa", "local_global"):
        raise NotImplementedError(f"attn_kind {cfg.attn_kind!r}")
    d, f, vp = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    nl, h, hkv, hd = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def stacked(shape, std):
        w = torch.empty((nl, *shape), dtype=dtype, device=dev)
        for i in range(nl):
            w[i] = normal(shape, std)
        return w

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    params: Dict[str, Any] = {
        "embed": normal((vp, d), 0.02),
        "final_norm": {"scale": zeros(d)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, vp), 1.0 / math.sqrt(d))
    attn = {"wq": stacked((d, h * hd), 1.0 / math.sqrt(d)),
            "wk": stacked((d, hkv * hd), 1.0 / math.sqrt(d)),
            "wv": stacked((d, hkv * hd), 1.0 / math.sqrt(d)),
            "wo": stacked((h * hd, d), 1.0 / math.sqrt(h * hd))}
    if cfg.qk_norm:
        attn["q_norm"] = zeros(nl, hd)
        attn["k_norm"] = zeros(nl, hd)
    blocks = {"ln1": {"scale": zeros(nl, d)}, "attn": attn,
              "ln2": {"scale": zeros(nl, d)},
              "mlp": {"w_gate": stacked((d, f), 1.0 / math.sqrt(d)),
                      "w_up": stacked((d, f), 1.0 / math.sqrt(d)),
                      "w_down": stacked((f, d), 1.0 / math.sqrt(f))}}
    if cfg.post_norms:
        blocks["ln1_post"] = {"scale": zeros(nl, d)}
        blocks["ln2_post"] = {"scale": zeros(nl, d)}
    params["blocks"] = blocks
    return params


def layer(params, li: int) -> dict:
    """Layer ``li``'s view of the stacked ``blocks`` tree (no copy)."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[li]
    return pick(params["blocks"])


def window_schedule(cfg: ModelConfig) -> List[int]:
    return [(cfg.window or GLOBAL_WINDOW) if kind == "attn_local"
            else GLOBAL_WINDOW for kind in cfg.layer_kinds()]


def embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def unembed(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """(…, D) -> (…, padded_vocab) logits, final softcap in fp32."""
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = (cap * torch.tanh(logits.float() / cap)).to(logits.dtype)
    return logits


def block_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor):
    """First half of an attention block: pre-norm + q/k/v (+ qk-norm,
    rope). x (B,S,D) -> q (B,S,H,hd), k/v (B,S,Hkv,hd)."""
    h = L.apply_norm(x, p["ln1"], cfg.norm)
    return L.attn_qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, positions, cfg.rope_theta, cfg.qk_norm)


def block_out(cfg: ModelConfig, p: dict, x: torch.Tensor,
              o: torch.Tensor) -> torch.Tensor:
    """Second half: output projection, residual, MLP, residual.
    o: (B,S,H,hd) attention output."""
    a = L.attn_out(p["attn"], o)
    if cfg.post_norms:
        a = L.apply_norm(a, p["ln1_post"], cfg.norm)
    x = x + a
    m = L.mlp_apply(p["mlp"], L.apply_norm(x, p["ln2"], cfg.norm),
                    cfg.mlp_act)
    if cfg.post_norms:
        m = L.apply_norm(m, p["ln2_post"], cfg.norm)
    return x + m


def forward(cfg: ModelConfig, params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced logits (B, S, padded_vocab) with naive masked
    attention — the counterpart of ``T.forward(attn_impl="naive")``."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed(cfg, params, tokens)
    for li, win in enumerate(window_schedule(cfg)):
        p = layer(params, li)
        q, k, v = block_qkv(cfg, p, x, positions)
        mask = L.causal_mask(positions, positions, win)
        o = L.attention(q, k, v, mask, cfg.attn_logit_softcap)
        x = block_out(cfg, p, x, o)
    return unembed(cfg, params, x)
