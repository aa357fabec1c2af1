"""Serving entry points of the slot family: cache init, prefill and
decode_step for the rwkv and hybrid-rglru towers (the counterpart of those
halves of ``repro/models/serving.py``).

Caches are dense per-slot tensors with the reference's layouts:
``length`` (B,) int32; rwkv ``state`` (L, B, H, hd, hd) fp32 and
``last_tm``/``last_cm`` (L, B, D); hybrid ``h`` (Lr, B, W) fp32, ``conv``
(Lr, B, cw-1, W) and the local-attention ``k``/``v`` (La, B, Smax, Hkv,
hd). Where the reference returns a new cache, ``prefill`` and
``decode_step`` update every tensor of ``cache`` IN PLACE (the slot runner
hands them views of one slot's rows) and return the same dict.

Ported branches: the engine's joint-over-cache chunked prefill
(``Smax <= 2048``) and the ring-buffer decode. The single-shot long
prefill branch (``Smax > 2048``) has no caller in the engine and is not
ported: ``init_cache`` refuses a hybrid cache longer than 2048.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.transformer import GLOBAL_WINDOW

Cache = Dict[str, Any]
JOINT_PREFILL_MAX = 2048      # the reference's joint-over-cache limit


def attn_layer_count(cfg: ModelConfig) -> int:
    return sum(1 for k in cfg.layer_kinds() if k.startswith("attn"))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, device) -> Cache:
    """Zeroed dense cache for ``batch`` slots of ``max_len`` tokens."""
    if cfg.attn_kind not in ("rwkv", "hybrid_rglru"):
        raise NotImplementedError(
            f"the port's slot caches cover rwkv and hybrid_rglru, not "
            f"{cfg.attn_kind!r}")
    cache: Cache = {"length": torch.zeros((batch,), dtype=torch.int32,
                                          device=device)}
    d = cfg.d_model
    if cfg.attn_kind == "rwkv":
        hd = cfg.rwkv.head_dim
        cache["state"] = torch.zeros((cfg.n_layers, batch, d // hd, hd, hd),
                                     dtype=torch.float32, device=device)
        cache["last_tm"] = torch.zeros((cfg.n_layers, batch, d), dtype=dtype,
                                       device=device)
        cache["last_cm"] = torch.zeros_like(cache["last_tm"])
        return cache
    if max_len > JOINT_PREFILL_MAX:
        raise NotImplementedError(
            f"max_len {max_len} > {JOINT_PREFILL_MAX}: the reference's "
            f"single-shot prefill branch is not ported")
    la = attn_layer_count(cfg)
    nr = cfg.n_layers - la
    w, cw = cfg.rglru.lru_width, cfg.rglru.conv1d_width
    cache["k"] = torch.zeros((la, batch, max_len, cfg.n_kv_heads,
                              cfg.head_dim), dtype=dtype, device=device)
    cache["v"] = torch.zeros_like(cache["k"])
    cache["h"] = torch.zeros((nr, batch, w), dtype=torch.float32,
                             device=device)
    cache["conv"] = torch.zeros((nr, batch, cw - 1, w), dtype=dtype,
                                device=device)
    return cache


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, cache: Cache,
            n_valid: Optional[int] = None,
            impl: str = "auto") -> Tuple[torch.Tensor, Cache]:
    """Process a prompt chunk starting at cache['length'] (per sequence).
    Returns (last-position logits (B, Vp), cache updated in place).

    ``n_valid`` (bucketed-prefill contract): only the first n_valid of the
    s chunk positions are real. Pad positions are exact identity steps in
    the recurrences, causally masked in attention (their KV writes land in
    slots a later chunk overwrites or decode masks), and excluded from the
    length and the logits."""
    b, s = tokens.shape
    nv = s if n_valid is None else n_valid
    start = cache["length"]
    positions = start[:, None] + torch.arange(s, dtype=torch.int32,
                                              device=tokens.device)[None, :]
    x = T.embed(cfg, params, tokens)
    if cfg.attn_kind == "rwkv":
        for li in range(cfg.n_layers):
            x = _rwkv_layer(cfg, T.layer(params, li), x, cache, li, n_valid,
                            impl)
    else:
        x = _rglru_prefill(cfg, params, x, positions, cache, nv, n_valid,
                           impl)
    cache["length"].add_(nv)
    logits = T.unembed(cfg, params, x[:, nv - 1:nv, :])
    return logits[:, 0, :], cache


def _rwkv_layer(cfg, p, x, cache, li, n_valid, impl):
    x, _, ltm, lcm = T.rwkv_block_apply(
        cfg, p, x, cache["state"][li], cache["last_tm"][li],
        cache["last_cm"][li], n_valid=n_valid, impl=impl)
    cache["last_tm"][li].copy_(ltm)
    cache["last_cm"][li].copy_(lcm)
    return x


def _cache_kpos(smax: int, start: torch.Tensor, s: int) -> torch.Tensor:
    """Positions of cache slots: slot i holds token i; unwritten slots get
    a huge sentinel so masks exclude them."""
    idx = torch.arange(smax, dtype=torch.int32, device=start.device)[None, :]
    valid = idx < (start + s)[:, None]
    return torch.where(valid, idx, torch.full_like(idx, GLOBAL_WINDOW + 1))


def _write_kv(ck, cv, k_new, v_new, start, nv: int) -> None:
    """Write a chunk's K/V at positions start..start+s-1 of each row, in
    place. Pad positions that fall past the end of the cache (a bucketed
    tail near max_len) are dropped, as the reference's scatter drops them:
    their write repeats the last real token's write instead, so no index
    runs out of range and no two writes of one slot disagree."""
    b, s = k_new.shape[:2]
    smax = ck.shape[1]
    off = torch.arange(s, device=start.device)[None, :]
    widx = start.long()[:, None] + off
    inside = widx < smax
    src = torch.where(inside, off, torch.full_like(off, nv - 1))
    widx = torch.where(inside, widx, start.long()[:, None] + nv - 1)
    bidx = torch.arange(b, device=start.device)[:, None].expand(b, s)
    ck[bidx, widx] = k_new.gather(1, _expand_like(src, k_new)).to(ck.dtype)
    cv[bidx, widx] = v_new.gather(1, _expand_like(src, v_new)).to(cv.dtype)


def _expand_like(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(
        *idx.shape, *x.shape[2:])


def _rglru_prefill(cfg, params, x, positions, cache, nv, n_valid, impl):
    start = cache["length"]
    win = cfg.window or GLOBAL_WINDOW
    ri = ai = 0
    for kind in cfg.layer_kinds():
        if kind == "rglru":
            x = _rglru_layer(cfg, params["rglru_blocks"][ri], x, cache, ri,
                             False, n_valid, impl)
            ri += 1
            continue
        p = params["attn_blocks"][ai]
        ck, cv = cache["k"][ai], cache["v"][ai]
        q, k_new, v_new = T.block_qkv(cfg, p, x, positions)
        _write_kv(ck, cv, k_new, v_new, start, nv)
        # joint continuation over the cache (the engine path)
        k_pos = _cache_kpos(ck.shape[1], start, x.shape[1])
        mask = L.causal_mask(positions, k_pos)
        mask &= k_pos[:, None, :] > (positions[:, :, None] - win)
        o = L.attention(q, ck.to(q.dtype), cv.to(q.dtype), mask,
                        cfg.attn_logit_softcap)
        x = T.block_out(cfg, p, x, o)
        ai += 1
    return x


def _rglru_layer(cfg, p, x, cache, ri, decode, n_valid, impl):
    x, h, conv = T.rglru_block_apply(cfg, p, x, cache["h"][ri],
                                     cache["conv"][ri], decode=decode,
                                     n_valid=n_valid, impl=impl)
    cache["h"][ri].copy_(h)
    cache["conv"][ri].copy_(conv)
    return x


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache: Cache,
                impl: str = "auto") -> Tuple[torch.Tensor, Cache]:
    """One decode step for every slot. token: (B,) int. Returns (logits
    (B, Vp), cache updated in place)."""
    lengths = cache["length"]
    positions = lengths[:, None]                                  # (B,1)
    x = T.embed(cfg, params, token[:, None].long())
    if cfg.attn_kind == "rwkv":
        for li in range(cfg.n_layers):
            x = _rwkv_layer(cfg, T.layer(params, li), x, cache, li, None,
                            impl)
    else:
        ri = ai = 0
        win = cfg.window or GLOBAL_WINDOW
        for kind in cfg.layer_kinds():
            if kind == "rglru":
                x = _rglru_layer(cfg, params["rglru_blocks"][ri], x, cache,
                                 ri, True, None, impl)
                ri += 1
            else:
                p = params["attn_blocks"][ai]
                o = _ring_decode_attention(cfg, p, x, positions,
                                           cache["k"][ai], cache["v"][ai],
                                           win, lengths)
                x = x + o
                x = x + L.mlp_apply(p["mlp"], L.apply_norm(x, p["ln2"],
                                                           cfg.norm),
                                    cfg.mlp_act)
                ai += 1
    lengths.add_(1)
    logits = T.unembed(cfg, params, x)
    return logits[:, 0, :], cache


def _ring_decode_attention(cfg, p, x, positions, k_cache, v_cache, win,
                           lengths):
    """One self-attention block in decode mode over a rotating buffer
    (``serving.py:352-371``): slot j holds the newest token t = j (mod
    Smax); the whole buffer is attended and masks do the rest. While a
    sequence is shorter than Smax this is the plain linear cache."""
    b = x.shape[0]
    smax = k_cache.shape[1]
    h = L.apply_norm(x, p["ln1"], cfg.norm)
    q, k_new, v_new = L.attn_qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim, positions, cfg.rope_theta,
                                 cfg.qk_norm)
    bidx = torch.arange(b, device=x.device)
    lm1 = lengths.long()                       # position of the new token
    k_cache[bidx, lm1 % smax] = k_new[:, 0].to(k_cache.dtype)
    v_cache[bidx, lm1 % smax] = v_new[:, 0].to(v_cache.dtype)
    j = torch.arange(smax, device=x.device)[None, :]
    delta = torch.remainder(lm1[:, None] - j, smax)
    t = lm1[:, None] - delta                   # token id held by each slot
    k_pos = torch.where(t >= 0, t, torch.full_like(t, GLOBAL_WINDOW + 1))
    mask = L.causal_mask(positions.long(), k_pos)
    mask &= k_pos[:, None, :] > (positions.long()[:, :, None] - win)
    o = L.attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype), mask,
                    cfg.attn_logit_softcap)
    return L.attn_out(p["attn"], o)
