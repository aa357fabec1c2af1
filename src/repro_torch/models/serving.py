"""Serving entry points of the slot family: cache init, prefill and
decode_step for the rwkv, hybrid-rglru and cross-attention (enc-dec, VLM)
towers (the counterpart of those halves of ``repro/models/serving.py``),
over the ranks of a TE's ``launch.mesh.EngineMesh``.

Caches are dense per-slot tensors with the reference's layouts:
``length`` (B,) int32; rwkv ``state`` (L, B, H, hd, hd) fp32 and
``last_tm``/``last_cm`` (L, B, D); hybrid ``h`` (Lr, B, W) fp32, ``conv``
(Lr, B, cw-1, W); the attention layers' ``k``/``v`` (La, B, Smax, Hkv,
hd); the cross blocks' ``cross_k``/``cross_v`` (Lc, B, P, Hkv, hd), P the
patches or frames. A TE holds them as a list of rank caches, one per rank
(one at tp 1), split by ``launch.sharding.engine_cache_specs``: rank r
holds the r-th part of the attention layers' sequence, of the rwkv heads
and of the RG-LRU width; a replicated leaf (``length``, the token-shift
inputs, the cross cache) is one tensor on rank 0's device that every
rank's cache refers to, read and written through rank 0's. Where the
reference returns a new cache, ``prefill`` and ``decode_step`` update
every tensor IN PLACE (the slot runner hands them views of one slot's
rows) and return the same list.

Attention over a sequence-split cache: each new K/V position is written
into the rank holding it (the query and K/V heads, split by the weights,
are gathered first), each rank attends over its own key slice with the
masks on global positions, and the slices' outputs are merged by a
log-sum-exp combine on rank 0: the reference's flash-decode via GSPMD
psum (``sharding.py:11-13``). A merge of one part is the identity, so a
tp-1 TE computes what one tree on one device computes, bit for bit.

Ported branches: the engine's joint-over-cache chunked prefill
(``Smax <= 2048``) and the ring-buffer decode, which is the reference's
linear-cache decode while a sequence is shorter than Smax (the engine
refuses a request that would outgrow its slot). The single-shot long
prefill branch (``Smax > 2048``) has no caller in the engine and is not
ported: ``init_cache`` refuses an attention cache longer than 2048.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import EngineMesh
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


def cache_like(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, device="meta") -> Cache:
    """The whole dense cache for ``batch`` slots of ``max_len`` tokens,
    zeroed on ``device`` (on the meta device, the default: its leaves'
    shapes and dtypes alone)."""
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


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, mesh: EngineMesh) -> List[Cache]:
    """Zeroed dense caches for ``batch`` slots of ``max_len`` tokens, one
    per rank of ``mesh``, split by ``engine_cache_specs``: each rank's
    part in storage of its own on its device (the kernels take a rank's
    state as a whole tensor), a replicated leaf once on rank 0's."""
    like = cache_like(cfg, batch, max_len, dtype)
    specs = SH.engine_cache_specs(cfg, like, mesh.tp)
    parts = {k: SH.rank_zeros(v.shape, v.dtype, specs[k], mesh)
             for k, v in like.items()}
    return [{k: parts[k][r] for k in like} for r in range(mesh.tp)]


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, ps: list, tokens: torch.Tensor,
            caches: List[Cache], mesh: EngineMesh,
            n_valid: Optional[int] = None, impl: str = "auto",
            vision_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, List[Cache]]:
    """Process a prompt chunk starting at the cache's length (per
    sequence) on the ranks' weights trees ``ps`` and caches ``caches``.
    Returns (last-position logits (B, Vp) on rank 0, the caches updated in
    place).

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
    c0 = caches[0]
    start = c0["length"]
    positions = start[:, None] + torch.arange(s, dtype=torch.int32,
                                              device=tokens.device)[None, :]
    x = T.embed(cfg, ps, tokens, mesh)
    if cfg.vision is not None and vision_embeds is not None:
        _fill_cross_cache(cfg, ps, vision_embeds, c0, mesh)
    if cfg.encoder is not None:
        if frames is None:
            raise ValueError(f"{cfg.name}: an enc-dec prefill needs frames")
        _fill_cross_cache(cfg, ps, T.encode(cfg, ps, frames, mesh), c0,
                          mesh)

    plan = _prefill_plan(caches, positions, s, mesh) if "k" in c0 else None

    def attend(lps, x, ai, win):
        return T.block_out(cfg, lps, x, _seq_attention(
            cfg, lps, x, positions, plan, ai, win, mesh), mesh)
    x = _tower(cfg, ps, x, caches, mesh, attend, n_valid, impl)
    c0["length"].add_(nv)
    logits = T.unembed(cfg, ps, x[:, nv - 1:nv, :], mesh)
    return logits[:, 0, :], caches


def _tower(cfg, ps, x, caches, mesh, attend, n_valid, impl):
    """Every layer of the tower, prefill and decode alike: rwkv blocks,
    the hybrid tower's RG-LRU and attention blocks, or the attention
    blocks of a cross tower, each followed by its cross block.
    ``attend(layer trees, x, attention layer index, window)`` runs one
    self-attention block."""
    if cfg.attn_kind == "rwkv":
        for li in range(cfg.n_layers):
            x = _rwkv_layer(cfg, ps, x, caches, li, mesh, n_valid, impl)
        return x
    if cfg.attn_kind == "hybrid_rglru":
        win = cfg.window or GLOBAL_WINDOW
        ri = ai = 0
        for kind in cfg.layer_kinds():
            if kind == "rglru":
                x = _rglru_layer(cfg, [p["rglru_blocks"][ri] for p in ps], x,
                                 caches, ri, mesh, n_valid, impl)
                ri += 1
            else:
                x = attend([p["attn_blocks"][ai] for p in ps], x, ai, win)
                ai += 1
        return x
    cross = T.cross_schedule(cfg)
    for li, win in enumerate(T.window_schedule(cfg)):
        x = attend([T.layer(p, li) for p in ps], x, li, win)
        x = _cross_after(cfg, ps, cross.get(li), x, caches[0], mesh)
    return x


def _rwkv_layer(cfg, ps, x, caches, li, mesh, n_valid, impl):
    c0 = caches[0]
    x, ltm, lcm = T.rwkv_block_apply(
        cfg, [T.layer(p, li) for p in ps], x,
        [c["state"][li] for c in caches], c0["last_tm"][li],
        c0["last_cm"][li], mesh, n_valid=n_valid, impl=impl)
    c0["last_tm"][li].copy_(ltm)
    c0["last_cm"][li].copy_(lcm)
    return x


def _rglru_layer(cfg, lps, x, caches, ri, mesh, n_valid, impl):
    x, hs, convs = T.rglru_block_apply(
        cfg, lps, x, [c["h"][ri] for c in caches],
        [c["conv"][ri] for c in caches], mesh, n_valid=n_valid, impl=impl)
    for c, h, conv in zip(caches, hs, convs):
        c["h"][ri].copy_(h)
        c["conv"][ri].copy_(conv)
    return x


def _held_kv(caches):
    """The stacked k and v (La, B, Sr, Hkv, hd) of every rank holding a
    distinct part of the attention layers' sequence, and Sr."""
    ks = SH.held([c["k"] for c in caches])
    return ks, SH.held([c["v"] for c in caches]), ks[0].shape[2]


def _cache_kpos(lo: int, n: int, start: torch.Tensor,
                s: int) -> torch.Tensor:
    """Positions of the cache slots lo..lo+n-1 after a chunk of ``s``
    tokens from ``start``: slot i holds token i; unwritten slots get a
    huge sentinel so masks exclude them."""
    idx = lo + torch.arange(n, dtype=torch.int32,
                            device=start.device)[None, :]
    valid = idx < (start + s)[:, None]
    return torch.where(valid, idx, torch.full_like(idx, GLOBAL_WINDOW + 1))


def _prefill_plan(caches, positions, s: int, mesh) -> List[dict]:
    """What every attention layer of a prefill chunk shares, once per rank
    holding a part of the sequence (positions lo..lo+Sr-1): that rank's
    k/v, where the chunk's K/V land in its part and its keys' positions.
    The chunk writes positions start..start+s-1 of each row; a position
    outside the part, or past the end of the cache (a bucketed tail near
    max_len, which the reference's scatter drops), repeats the write of
    the nearest position inside it, so no index runs out of range and no
    two writes of one slot disagree; a row with no position inside the
    part writes a slot's own value back (``keep``)."""
    ks, vs, sr = _held_kv(caches)
    plan = []
    for r, (k, v, pos) in enumerate(zip(ks, vs, mesh.broadcast(positions))):
        lo = r * sr
        st = pos[:, :1].long()
        first = st.clamp(min=lo)
        last = (st + s - 1).clamp(max=lo + sr - 1)
        at = torch.minimum(torch.maximum(pos.long(), first), last)
        b = pos.shape[0]
        plan.append(dict(
            k=k, v=v, pos=pos, masks={},
            bidx=torch.arange(b, device=pos.device)[:, None].expand(b, s),
            local=(at - lo).clamp(0, sr - 1), src=(at - st).clamp(0, s - 1),
            keep=(first > last)[..., None, None],
            k_pos=_cache_kpos(lo, sr, pos[:, 0], s)))
    return plan


def _write(c, new, part) -> None:
    """A layer's new K or V (B, s, Hkv, hd) into one rank's part of the
    cache (B, Sr, Hkv, hd), in place, at the part's write slots."""
    val = new if part["src"] is None else \
        new.gather(1, _expand_like(part["src"], new))
    at = (part["bidx"], part["local"])
    c[at] = torch.where(part["keep"], c[at], val.to(c.dtype))


def _expand_like(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(
        *idx.shape, *x.shape[2:])


def _mask(part, win: int) -> torch.Tensor:
    """The part's attention mask under window ``win`` (causal on global
    positions), made once per window and pass."""
    m = part["masks"].get(win)
    if m is None:
        pos, kp = part["pos"], part["k_pos"]
        m = L.causal_mask(pos, kp)
        m &= kp[:, None, :] > (pos[:, :, None] - win)
        part["masks"][win] = m
    return m


def _attend(items, cap, mesh) -> torch.Tensor:
    """Attention of the queries over the key slices of ``items`` ((q, k,
    v, mask) on each rank holding a part), merged on rank 0 by a
    log-sum-exp combine: o = sum_r exp(lse_r - lse) o_r, lse the
    log-sum-exp of the slices' lse_r. Over one slice it is plain
    attention."""
    if len(items) == 1:
        return L.attention(*items[0], cap)
    outs = [L.attention_lse(*it, cap) for it in items]
    o = mesh.all_gather([x[0].float()[None] for x in outs], 0)
    lse = mesh.all_gather([x[1][None] for x in outs], 0)
    w = torch.exp(lse - torch.logsumexp(lse, 0))[..., None]
    return (w * o).sum(0).to(outs[0][0].dtype)


def _seq_attention(cfg, lps, x, positions, plan, ai, win, mesh):
    """One self-attention block's attention over attention layer ``ai``'s
    sequence-split cache, prefill or decode alike: its q/k/v heads
    gathered from ``block_qkv``'s ranks, the new K/V written into the
    parts (``plan``), each rank's queries over its part. Returns the
    heads' output as ``block_qkv``'s ranks hold it, before the output
    projection."""
    qkv = T.block_qkv(cfg, lps, x, mesh.broadcast(positions), mesh)
    q, k_new, v_new = (mesh.all_gather(list(t), 2) for t in zip(*qkv))
    items = []
    for part, qr, kr, vr in zip(plan, *(mesh.broadcast(t)
                                        for t in (q, k_new, v_new))):
        ck, cv = part["k"][ai], part["v"][ai]
        _write(ck, kr, part)
        _write(cv, vr, part)
        items.append((qr, ck.to(q.dtype), cv.to(q.dtype), _mask(part, win)))
    return mesh.scatter(_attend(items, cfg.attn_logit_softcap, mesh),
                        len(qkv), 2)


def _fill_cross_cache(cfg, ps, mem, c0, mesh) -> None:
    """Project the modality memory (B, P, D) through every cross block's
    K/V weights into the replicated cross cache, in place
    (``serving.py:282-291``)."""
    for ci in range(c0["cross_k"].shape[0]):
        k, v = T.memory_kv(
            cfg, [T.layer(p, ci, "cross_blocks")["attn"] for p in ps], mem,
            mesh)
        c0["cross_k"][ci].copy_(k)
        c0["cross_v"][ci].copy_(v)


def _cross_after(cfg, ps, block, x, c0, mesh):
    """The cross block ``block`` = (index, gated) of ``T.cross_schedule``
    that follows a decoder layer (None: no block there), over the cached
    modality K/V."""
    if block is None:
        return x
    ci, gated = block
    return T.cross_block_apply(
        cfg, [T.layer(p, ci, "cross_blocks") for p in ps], x,
        c0["cross_k"][ci], c0["cross_v"][ci], gated, mesh)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_step(cfg: ModelConfig, ps: list, token: torch.Tensor,
                caches: List[Cache], mesh: EngineMesh,
                impl: str = "auto") -> Tuple[torch.Tensor, List[Cache]]:
    """One decode step for every slot. token: (B,) int. Returns (logits
    (B, Vp) on rank 0, the caches updated in place)."""
    lengths = caches[0]["length"]
    positions = lengths[:, None]                                  # (B,1)
    x = T.embed(cfg, ps, token[:, None].long(), mesh)

    plan = _decode_plan(caches, positions, mesh) if "k" in caches[0] \
        else None

    def attend(lps, x, ai, win):
        return T.block_out(cfg, lps, x, _seq_attention(
            cfg, lps, x, positions, plan, ai, win, mesh), mesh)
    x = _tower(cfg, ps, x, caches, mesh, attend, None, impl)
    lengths.add_(1)
    logits = T.unembed(cfg, ps, x, mesh)
    return logits[:, 0, :], caches


def _decode_plan(caches, positions, mesh) -> List[dict]:
    """``_prefill_plan`` for a decode step over a rotating buffer
    (``serving.py:352-371``): slot j holds the newest token t = j (mod
    Smax); the whole buffer is attended and masks do the rest. While a
    sequence is shorter than Smax this is the plain linear cache
    (``serving.py:373-384``). The new token's K/V land in the rank
    holding its ring slot; the other ranks write their slot's own value
    back."""
    ks, vs, sr = _held_kv(caches)
    smax = sr * len(ks)
    plan = []
    for r, (k, v, pos) in enumerate(zip(ks, vs, mesh.broadcast(positions))):
        lo = r * sr
        pos = pos.long()
        lm1 = pos[:, 0]                          # position of the new token
        ring = lm1 % smax
        j = lo + torch.arange(sr, device=pos.device)[None, :]
        t = lm1[:, None] - torch.remainder(lm1[:, None] - j, smax)
        plan.append(dict(
            k=k, v=v, pos=pos, masks={}, src=None,
            bidx=torch.arange(pos.shape[0], device=pos.device)[:, None],
            local=(ring - lo).clamp(0, sr - 1)[:, None],
            keep=((ring < lo) | (ring >= lo + sr))[:, None, None, None],
            # the token id each slot holds
            k_pos=torch.where(t >= 0, t, torch.full_like(t,
                                                         GLOBAL_WINDOW + 1))))
    return plan
