"""Serving entry points of the slot family: cache init, prefill and
decode_step for the rwkv, hybrid-rglru and cross-attention (enc-dec, VLM)
towers (the counterpart of those halves of ``repro/models/serving.py``).

Caches are dense per-slot tensors with the reference's layouts:
``length`` (B,) int32; rwkv ``state`` (L, B, H, hd, hd) fp32 and
``last_tm``/``last_cm`` (L, B, D); hybrid ``h`` (Lr, B, W) fp32, ``conv``
(Lr, B, cw-1, W); the attention layers' ``k``/``v`` (La, B, Smax, Hkv,
hd); the cross blocks' ``cross_k``/``cross_v`` (Lc, B, P, Hkv, hd), P the
patches or frames. Where the reference returns a new cache, ``prefill``
and ``decode_step`` update every tensor of ``cache`` IN PLACE (the slot
runner hands them views of one slot's rows) and return the same dict.

Ported branches: the engine's joint-over-cache chunked prefill
(``Smax <= 2048``) and the ring-buffer decode, which is the reference's
linear-cache decode while a sequence is shorter than Smax (the engine
refuses a request that would outgrow its slot). The single-shot long
prefill branch (``Smax > 2048``) has no caller in the engine and is not
ported: ``init_cache`` refuses an attention cache longer than 2048.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import one_rank
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.transformer import GLOBAL_WINDOW

Cache = Dict[str, Any]
JOINT_PREFILL_MAX = 2048      # the reference's joint-over-cache limit


def attn_layer_count(cfg: ModelConfig) -> int:
    return sum(1 for k in cfg.layer_kinds() if k.startswith("attn"))


def extra_inputs(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                 device) -> Dict[str, torch.Tensor]:
    """The modality-stub inputs a request carries when it brings none:
    zero patch embeddings (VLM) or frame embeddings (enc-dec), as
    ``repro/models/model_factory.py::extra_inputs`` makes them."""
    out: Dict[str, torch.Tensor] = {}
    if cfg.vision is not None:
        out["vision_embeds"] = torch.zeros(
            (batch, cfg.vision.n_patches, cfg.d_model), dtype=dtype,
            device=device)
    if cfg.encoder is not None:
        out["frames"] = torch.zeros((batch, cfg.encoder.n_frames,
                                     cfg.d_model), dtype=dtype, device=device)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, device) -> Cache:
    """Zeroed dense cache for ``batch`` slots of ``max_len`` tokens."""
    if cfg.attn_kind not in ("rwkv", "hybrid_rglru", "global"):
        raise NotImplementedError(
            f"the port's slot caches cover rwkv, hybrid_rglru and global "
            f"attention towers, not {cfg.attn_kind!r}")
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
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    cache["k"] = torch.zeros((la, batch, max_len, hkv, hd), dtype=dtype,
                             device=device)
    cache["v"] = torch.zeros_like(cache["k"])
    if cfg.attn_kind == "hybrid_rglru":
        nr = cfg.n_layers - la
        w, cw = cfg.rglru.lru_width, cfg.rglru.conv1d_width
        cache["h"] = torch.zeros((nr, batch, w), dtype=torch.float32,
                                 device=device)
        cache["conv"] = torch.zeros((nr, batch, cw - 1, w), dtype=dtype,
                                    device=device)
    mem = None
    if cfg.vision is not None:
        mem = (len(cfg.cross_attn_layers()), cfg.vision.n_patches)
    if cfg.encoder is not None:
        mem = (cfg.n_layers, cfg.encoder.n_frames)
    if mem is not None:
        cache["cross_k"] = torch.zeros((mem[0], batch, mem[1], hkv, hd),
                                       dtype=dtype, device=device)
        cache["cross_v"] = torch.zeros_like(cache["cross_k"])
    return cache


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, cache: Cache,
            n_valid: Optional[int] = None, impl: str = "auto",
            vision_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Process a prompt chunk starting at cache['length'] (per sequence).
    Returns (last-position logits (B, Vp), cache updated in place).

    ``n_valid`` (bucketed-prefill contract): only the first n_valid of the
    s chunk positions are real. Pad positions are exact identity steps in
    the recurrences, causally masked in attention (their KV writes land in
    slots a later chunk overwrites or decode masks), and excluded from the
    length and the logits.

    A cross-attention tower refills its cross cache from the modality
    memory at every chunk, as the reference does (``serving.py:113-118``):
    a VLM from ``vision_embeds`` (its cross cache is kept when they are
    None), an enc-dec model from ``frames`` run through the whole encoder
    each time."""
    b, s = tokens.shape
    nv = s if n_valid is None else n_valid
    start = cache["length"]
    positions = start[:, None] + torch.arange(s, dtype=torch.int32,
                                              device=tokens.device)[None, :]
    x = T.embed(cfg, [params], tokens, one_rank(tokens.device))
    if cfg.vision is not None and vision_embeds is not None:
        _fill_cross_cache(cfg, params, vision_embeds, cache)
    if cfg.encoder is not None:
        if frames is None:
            raise ValueError(f"{cfg.name}: an enc-dec prefill needs frames")
        _fill_cross_cache(cfg, params, T.encode(cfg, params, frames), cache)
    if cfg.attn_kind == "rwkv":
        for li in range(cfg.n_layers):
            x = _rwkv_layer(cfg, T.layer(params, li), x, cache, li, n_valid,
                            impl)
    elif cfg.attn_kind == "hybrid_rglru":
        x = _rglru_prefill(cfg, params, x, positions, cache, nv, n_valid,
                           impl)
    else:
        cross = T.cross_schedule(cfg)
        for li, win in enumerate(T.window_schedule(cfg)):
            p = T.layer(params, li)
            x = _attn_layer_prefill(cfg, p, x, positions, cache["k"][li],
                                    cache["v"][li], start, nv, win)
            x = _cross_after(cfg, params, cross.get(li), x, cache)
    cache["length"].add_(nv)
    logits = T.unembed(cfg, [params], x[:, nv - 1:nv, :],
                       one_rank(x.device))
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


def _attn_layer_prefill(cfg, p, x, positions, ck, cv, start, nv, win):
    """One attention block of a chunk: write its K/V into the layer's
    cache rows, then attend jointly over the cache (the engine path)."""
    mesh = one_rank(x.device)
    (q, k_new, v_new), = T.block_qkv(cfg, [p], x, [positions], mesh)
    _write_kv(ck, cv, k_new, v_new, start, nv)
    k_pos = _cache_kpos(ck.shape[1], start, x.shape[1])
    mask = L.causal_mask(positions, k_pos)
    mask &= k_pos[:, None, :] > (positions[:, :, None] - win)
    o = L.attention(q, ck.to(q.dtype), cv.to(q.dtype), mask,
                    cfg.attn_logit_softcap)
    return T.block_out(cfg, [p], x, [o], mesh)


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
        x = _attn_layer_prefill(cfg, params["attn_blocks"][ai], x, positions,
                                cache["k"][ai], cache["v"][ai], start, nv,
                                win)
        ai += 1
    return x


def _fill_cross_cache(cfg, params, mem, cache) -> None:
    """Project the modality memory (B, P, D) through every cross block's
    K/V weights into the cross cache, in place (``serving.py:282-291``)."""
    for ci in range(cache["cross_k"].shape[0]):
        k, v = T.memory_kv(cfg, T.layer(params, ci, "cross_blocks")["attn"],
                           mem)
        cache["cross_k"][ci].copy_(k)
        cache["cross_v"][ci].copy_(v)


def _cross_after(cfg, params, block, x, cache):
    """The cross block ``block`` = (index, gated) of ``T.cross_schedule``
    that follows a decoder layer (None: no block there), over the cached
    modality K/V."""
    if block is None:
        return x
    ci, gated = block
    return T.cross_block_apply(cfg, T.layer(params, ci, "cross_blocks"), x,
                               cache["cross_k"][ci], cache["cross_v"][ci],
                               gated)


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
    mesh = one_rank(token.device)
    x = T.embed(cfg, [params], token[:, None].long(), mesh)
    if cfg.attn_kind == "rwkv":
        for li in range(cfg.n_layers):
            x = _rwkv_layer(cfg, T.layer(params, li), x, cache, li, None,
                            impl)
    elif cfg.attn_kind == "hybrid_rglru":
        ri = ai = 0
        win = cfg.window or GLOBAL_WINDOW
        for kind in cfg.layer_kinds():
            if kind == "rglru":
                x = _rglru_layer(cfg, params["rglru_blocks"][ri], x, cache,
                                 ri, True, None, impl)
                ri += 1
            else:
                p = params["attn_blocks"][ai]
                x = T.block_out(cfg, [p], x, [_ring_decode_attention(
                    cfg, p, x, positions, cache["k"][ai], cache["v"][ai],
                    win, lengths, mesh)], mesh)
                ai += 1
    else:
        # the reference's unrolled tower with its cross blocks
        # (serving.py:387-445)
        cross = T.cross_schedule(cfg)
        for li, win in enumerate(T.window_schedule(cfg)):
            p = T.layer(params, li)
            x = T.block_out(cfg, [p], x, [_ring_decode_attention(
                cfg, p, x, positions, cache["k"][li], cache["v"][li], win,
                lengths, mesh)], mesh)
            x = _cross_after(cfg, params, cross.get(li), x, cache)
    lengths.add_(1)
    logits = T.unembed(cfg, [params], x, mesh)
    return logits[:, 0, :], cache


def _ring_decode_attention(cfg, p, x, positions, k_cache, v_cache, win,
                           lengths, mesh):
    """One self-attention block's attention in decode mode over a rotating
    buffer (``serving.py:352-371``): slot j holds the newest token t = j
    (mod Smax); the whole buffer is attended and masks do the rest. While
    a sequence is shorter than Smax this is the plain linear cache
    (``serving.py:373-384``). Returns the heads' output (B, 1, H, hd),
    before the output projection."""
    b = x.shape[0]
    smax = k_cache.shape[1]
    (q, k_new, v_new), = T.block_qkv(cfg, [p], x, [positions], mesh)
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
    return L.attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype), mask,
                       cfg.attn_logit_softcap)
