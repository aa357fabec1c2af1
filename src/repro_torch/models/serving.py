"""Serving entry points over dense caches: cache init, prefill and
decode_step for every tower of the configs (the counterpart of
``repro/models/serving.py``): global, sliding-window and local/global
attention (dense or MoE), rwkv, hybrid-rglru and the cross-attention
(enc-dec, VLM) towers, over the ranks of a TE's ``launch.mesh.EngineMesh``.
The slot runner serves the last four through them; ``get_model`` and
``launch/steps.py`` expose them for every arch.

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
into the rank holding it (the K/V heads, split by the weights, are
gathered first), each rank attends over its own key slice with the masks
on global positions, and the slices' outputs are merged by a log-sum-exp
combine on rank 0: the reference's flash-decode via GSPMD psum
(``sharding.py:11-13``). A merge of one part is the identity, so a tp-1 TE
computes what one tree on one device computes, bit for bit. A rank whose
slice holds no key a row may see gives that row a finite ``NEG`` log-sum-
exp, and so a merge weight of 0.

The reference's branches, all ported, at every tp:
  * prefill into a cache of ``Smax <= 2048`` attends jointly over the
    cache after writing the chunk's K/V (the engine's chunked prefill);
    past 2048 the single-shot branch attends over the chunk's fresh K/V
    by ``transformer.self_attention``, each rank of ``block_qkv`` over its
    own heads (the ``flash_prefill`` kernel on the card, one launch per
    such rank), and writes the cache apart. That branch ignores the
    cached prefix, so the port refuses it for a cache whose length is not
    0 (the reference would silently drop the prefix).
  * decode writes the new token at ``length`` of a linear cache, or at
    ``length mod Smax`` of a rotating buffer: the reference's choice
    (``serving.py:343-346``) takes the ring for ``swa`` and
    ``hybrid_rglru`` caches of at most ``ring_len(cfg)`` slots, which
    ``init_cache(..., ring=True)`` makes. With ``perf_flags.
    windowed_decode`` a linear windowed cache attends only its trailing
    window + 1 slots, each rank those of them in its part. The step reads
    nothing on the host: on a full linear cache the new token's K/V are
    dropped, as the reference's scatter drops them. ``check_room``
    refuses that case; the entry points a user calls (``get_model(...).
    decode_step``, ``steps.build_decode_step``) call it first, while the
    slot engine refuses a request that would outgrow its slot at
    admission.
  * decode attention stays plain masked attention: the reference runs no
    Pallas kernel there.
Every cache kind splits at tp > 1 (``swa``, ``local_global``, the ring,
past 2048 positions), as the reference's ``cache_specs`` splits it; a
length tp does not divide is replicated (one part, on rank 0).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import EngineMesh
from repro_torch.models import layers as L
from repro_torch.models import perf_flags as PF
from repro_torch.models import transformer as T
from repro_torch.models.transformer import GLOBAL_WINDOW

Cache = Dict[str, Any]
JOINT_PREFILL_MAX = 2048      # the reference's joint-over-cache limit


def attn_layer_count(cfg: ModelConfig) -> int:
    return sum(1 for k in cfg.layer_kinds() if k.startswith("attn"))


def ring_len(cfg: ModelConfig, align: int = 256) -> int:
    """Ring-buffer length of a windowed arch: the window plus one aligned
    chunk of slack (``serving.py:38-43``)."""
    if cfg.window is None:
        raise ValueError(f"{cfg.name} has no window")
    return ((cfg.window + align + align - 1) // align) * align


def is_ring(cfg: ModelConfig, smax: int) -> bool:
    """Whether decode treats an attention cache of ``smax`` slots as a
    rotating buffer: the reference's choice (``serving.py:343-346``),
    ``swa`` and ``hybrid_rglru`` caches of at most ``ring_len`` slots."""
    return (cfg.attn_kind in ("swa", "hybrid_rglru")
            and cfg.window is not None and cfg.window < 2 ** 20
            and smax <= ring_len(cfg))


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
               dtype: torch.dtype, device="meta", ring: bool = False
               ) -> Cache:
    """The whole dense cache for ``batch`` slots of ``max_len`` tokens,
    zeroed on ``device`` (on the meta device, the default: its leaves'
    shapes and dtypes alone). With ``ring`` (``swa`` and
    ``hybrid_rglru`` only) the attention cache is a rotating buffer of
    ``min(max_len, ring_len(cfg))`` slots, sized by the window and not by
    the context (``serving.py:45-57``)."""
    if cfg.attn_kind not in ("rwkv", "hybrid_rglru", "global", "swa",
                             "local_global"):
        raise NotImplementedError(f"attn_kind {cfg.attn_kind!r}")
    if ring and cfg.attn_kind not in ("swa", "hybrid_rglru"):
        raise ValueError(f"a ring cache needs an swa or hybrid_rglru arch, "
                         f"not {cfg.attn_kind!r}")
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
    s_alloc = min(max_len, ring_len(cfg)) if ring else max_len
    la = attn_layer_count(cfg)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    cache["k"] = torch.zeros((la, batch, s_alloc, hkv, hd), dtype=dtype,
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
               dtype: torch.dtype, mesh: EngineMesh,
               ring: bool = False) -> List[Cache]:
    """Zeroed dense caches for ``batch`` slots of ``max_len`` tokens (a
    rotating buffer of ``ring_len`` slots with ``ring``), one per rank of
    ``mesh``, split by ``engine_cache_specs``: each rank's part in
    storage of its own on its device (the kernels take a rank's state as
    a whole tensor), a replicated leaf once on rank 0's."""
    like = cache_like(cfg, batch, max_len, dtype, ring=ring)
    specs = SH.engine_cache_specs(cfg, like, mesh.tp)
    parts = {k: SH.rank_zeros(v.shape, v.dtype, specs[k], mesh)
             for k, v in like.items()}
    return [{k: parts[k][r] for k in like} for r in range(mesh.tp)]


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, ps: list, tokens: torch.Tensor,
            caches: List[Cache], mesh: EngineMesh,
            n_valid=None, impl: str = "auto",
            vision_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, attn_impl: str = "auto"
            ) -> Tuple[torch.Tensor, List[Cache]]:
    """Process a prompt chunk starting at the cache's length (per
    sequence) on the ranks' weights trees ``ps`` and caches ``caches``.
    Returns (last-position logits (B, Vp) on rank 0, the caches updated in
    place).

    ``n_valid`` (bucketed-prefill contract): only the first n_valid of the
    s chunk positions are real. Pad positions are exact identity steps in
    the recurrences, causally masked in attention (their KV writes land in
    slots a later chunk overwrites or decode masks), and excluded from the
    length and the logits. It is an int, or a 0-d int tensor on the
    cache's device (the slot prefill program's operand), which no
    function on this path reads on the host: the recurrences' mask is
    then always applied, the last real position is gathered at device
    indices and the length advanced by the tensor, giving the int's
    results bit for bit.

    A cross-attention tower refills its cross cache from the modality
    memory at every chunk, as the reference does (``serving.py:113-118``):
    a VLM from ``vision_embeds`` (its cross cache is kept when they are
    None), an enc-dec model from ``frames`` run through the whole encoder
    each time.

    A cache of more than 2048 positions takes the reference's single-shot
    branch (module docstring): attention over the chunk's fresh K/V by
    ``transformer.self_attention`` at ``attn_impl``, each rank of
    ``block_qkv`` over its own heads (past 2048 tokens one ``flash_prefill``
    launch per such rank on the card, under ``impl="auto"``); it raises
    unless every sequence starts at length 0. MoE blocks take the
    reference's capacity groups over the chunk's B x s rows."""
    b, s = tokens.shape
    nv = s if n_valid is None else n_valid
    c0 = caches[0]
    start = c0["length"]
    positions = start[:, None] + torch.arange(s, dtype=torch.int32,
                                              device=tokens.device)[None, :]
    x = T.embed(cfg, ps, tokens, mesh)
    if cfg.vision is not None and vision_embeds is not None:
        fill_cross_cache(cfg, ps, vision_embeds, c0, mesh)
    if cfg.encoder is not None:
        if frames is None:
            raise ValueError(f"{cfg.name}: an enc-dec prefill needs frames")
        fill_cross_cache(cfg, ps, T.encode(cfg, ps, frames, mesh,
                                           attn_impl=attn_impl), c0, mesh)

    plan, fresh = None, None
    if "k" in c0:
        plan = _prefill_plan(caches, positions, s, mesh)
        smax = _cache_len(caches)
        if smax > JOINT_PREFILL_MAX:
            if bool((start != 0).any()):
                raise ValueError(
                    f"a cache of {smax} > {JOINT_PREFILL_MAX} positions "
                    f"takes the single-shot prefill, which attends only "
                    f"over the chunk's own K/V: every sequence must start "
                    f"at length 0, got lengths {start.tolist()}")
            fresh = (attn_impl, impl)
    groups = T.moe_groups(b * s)

    def attend(lps, x, ai, win):
        return T.block_out(cfg, lps, x, _seq_attention(
            cfg, lps, x, positions, plan, ai, win, mesh, fresh), mesh,
            groups=groups)
    x = tower(cfg, ps, x, caches, mesh, attend, n_valid, impl)
    c0["length"].add_(nv)
    logits = T.unembed(cfg, ps, L.take_run(x, nv - 1, 1), mesh)
    return logits[:, 0, :], caches


def tower(cfg, ps, x, caches, mesh, attend, n_valid, impl):
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


def _cache_len(caches) -> int:
    """Smax: the attention cache's positions over all its parts."""
    ks, _, sr = _held_kv(caches)
    return sr * len(ks)


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


def _seq_attention(cfg, lps, x, positions, plan, ai, win, mesh,
                   fresh=None):
    """One self-attention block's attention over attention layer ``ai``'s
    sequence-split cache, prefill or decode alike: its K/V heads gathered
    from ``block_qkv``'s ranks and written into the parts (``plan``), then
    each rank's queries (all heads) over its part (the trailing window's
    columns there, in a windowed decode). ``fresh`` = (attn_impl, impl):
    the single-shot prefill, whose queries attend over the chunk's own
    K/V instead, each rank of ``block_qkv`` over its own heads
    (``fresh_heads``). Returns the heads' output as ``block_qkv``'s ranks
    hold it, before the output projection."""
    pos = mesh.broadcast(positions)
    qkv = T.block_qkv(cfg, lps, x, pos, mesh)
    k_new, v_new = (mesh.all_gather([t[i] for t in qkv], 2) for i in (1, 2))
    for part, kr, vr in zip(plan, mesh.broadcast(k_new),
                            mesh.broadcast(v_new)):
        _write(part["k"][ai], kr, part)
        _write(part["v"][ai], vr, part)
    if fresh is not None:
        return fresh_heads(cfg, qkv, pos, win, *fresh)
    q = mesh.all_gather([t[0] for t in qkv], 2)
    items = []
    for part, qr in zip(plan, mesh.broadcast(q)):
        ck, cv = part["k"][ai], part["v"][ai]
        if part.get("cols") is not None:
            at = (part["bidx"], part["cols"])
            ck, cv = ck[at], cv[at]
        items.append((qr, ck.to(q.dtype), cv.to(q.dtype), _mask(part, win)))
    o = _attend(items, cfg.attn_logit_softcap, mesh)
    return mesh.scatter(o, len(qkv), 2)


def fresh_heads(cfg: ModelConfig, qkv: list, positions: list, win: int,
                attn_impl: str, impl: str) -> list:
    """From-scratch attention of ``block_qkv``'s ranks (q, k, v at
    positions 0..S-1), each over its own heads by
    ``transformer.self_attention`` (past 2048 keys the dense
    ``flash_prefill`` kernel on the card, one launch per rank): the
    single-shot prefill's and the prefill builders' attention. Heads do
    not mix in attention, so no K/V crosses ranks."""
    return [T.self_attention(cfg, q, k, v, p, p, win, attn_impl, impl=impl,
                             from_scratch=True)
            for (q, k, v), p in zip(qkv, positions)]


def fill_cross_cache(cfg, ps, mem, c0, mesh) -> None:
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


def check_room(cfg: ModelConfig, caches: List[Cache]) -> None:
    """Raise if a linear attention cache has a sequence at its last
    position: a decode step would drop the new token's K/V (reference
    defect 2). Reads the lengths on the host."""
    if "k" not in caches[0]:
        return
    smax = _cache_len(caches)
    lengths = caches[0]["length"]
    if not is_ring(cfg, smax) and int(lengths.max()) >= smax:
        raise ValueError(
            f"the linear cache of {smax} positions is full (lengths "
            f"{lengths.tolist()}): decoding would drop the new token's "
            f"K/V; allocate room or a ring (init_cache(ring=True))")


def decode_step(cfg: ModelConfig, ps: list, token: torch.Tensor,
                caches: List[Cache], mesh: EngineMesh,
                impl: str = "auto") -> Tuple[torch.Tensor, List[Cache]]:
    """One decode step for every slot. token: (B,) int. Returns (logits
    (B, Vp) on rank 0, the caches updated in place). Nothing is read on
    the host: a row at the last position of a linear cache has its write
    dropped, as the reference's scatter drops it (``check_room`` refuses
    that case)."""
    lengths = caches[0]["length"]
    positions = lengths[:, None]                                  # (B,1)
    x = T.embed(cfg, ps, token[:, None].long(), mesh)

    plan = _decode_plan(cfg, caches, positions, mesh) \
        if "k" in caches[0] else None

    def attend(lps, x, ai, win):
        return T.block_out(cfg, lps, x, _seq_attention(
            cfg, lps, x, positions, plan, ai, win, mesh), mesh)
    x = tower(cfg, ps, x, caches, mesh, attend, None, impl)
    lengths.add_(1)
    logits = T.unembed(cfg, ps, x, mesh)
    return logits[:, 0, :], caches


def _decode_plan(cfg, caches, positions, mesh) -> List[dict]:
    """``_prefill_plan`` for a decode step (``serving.py:322-384``). The
    new token at position lm1 goes to slot lm1 of a linear cache (dropped
    past its end) or to slot lm1 mod Smax of a rotating buffer
    (``is_ring``), where slot j holds the newest token t = j (mod Smax);
    the whole cache is attended and masks do the rest, or, with
    ``perf_flags.windowed_decode`` on a linear windowed cache, only its
    trailing window + 1 columns: each rank gathers those of them in its
    part and masks the rest (a rank holding none of them gives fully
    masked rows, merged with weight 0). The new token's K/V land in the
    rank holding its slot; the other ranks write their slot's own value
    back."""
    ks, vs, sr = _held_kv(caches)
    smax = sr * len(ks)
    ring = is_ring(cfg, smax)
    static_win = cfg.window if cfg.attn_kind in ("swa", "hybrid_rglru") \
        else None
    span = None
    if (PF.get().windowed_decode and not ring and static_win is not None
            and static_win + 1 < smax):
        span = static_win + 1
    plan = []
    for r, (k, v, pos) in enumerate(zip(ks, vs, mesh.broadcast(positions))):
        lo = r * sr
        pos = pos.long()
        lm1 = pos[:, 0]                          # position of the new token
        at = lm1 % smax if ring else lm1         # its slot
        j = lo + torch.arange(sr, device=pos.device)[None, :]
        if ring:
            t = lm1[:, None] - torch.remainder(lm1[:, None] - j, smax)
        else:
            t = torch.where(j <= lm1[:, None], j, torch.full_like(j, -1))
        part = dict(
            k=k, v=v, pos=pos, masks={}, src=None, cols=None,
            bidx=torch.arange(pos.shape[0], device=pos.device)[:, None],
            local=(at - lo).clamp(0, sr - 1)[:, None],
            keep=((at < lo) | (at >= lo + sr))[:, None, None, None],
            # the token id each slot holds
            k_pos=torch.where(t >= 0, t, torch.full_like(t,
                                                         GLOBAL_WINDOW + 1)))
        if span is not None:
            cols = (lm1 - static_win).clamp(0, smax - span)[:, None] \
                + torch.arange(span, device=pos.device)[None, :]
            mine = (cols >= lo) & (cols < lo + sr) & (cols <= lm1[:, None])
            part.update(cols=(cols - lo).clamp(0, sr - 1), k_pos=torch.where(
                mine, cols, torch.full_like(cols, GLOBAL_WINDOW + 1)))
        plan.append(part)
    return plan
