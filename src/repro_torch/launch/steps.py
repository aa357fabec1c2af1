"""Step builders for the reference's shapes (the counterpart of
``repro/launch/steps.py``): one builder per step kind, each returning a
function over the port's weights tree (one rank).

  * ``build_train_step`` — ``training/train_loop.py::make_train_step``
    (forward with remat -> grads -> AdamW), re-exported.
  * ``build_prefill_step`` — prompt -> (last-position logits, cache) from
    scratch, one builder per family (dense and MoE, VLM, enc-dec, rwkv,
    hybrid). The cache holds each attention layer's fresh K/V stacked,
    with no scatter into a preallocated cache: what a PD-disaggregated
    prefill TE ships to a decode TE. Past 2048 tokens the attention is
    ``transformer.self_attention``'s blockwise route: the dense
    ``flash_prefill`` kernel on the card under ``impl="auto"``; the rwkv
    and hybrid towers run the WKV6 and RG-LRU kernels as serving does.
  * ``build_decode_step`` — ``serving.decode_step`` on one cache, after
    ``serving.check_room``.

The builders' caches hold exactly the prompt's S positions, so a decode
step on one has no room (the reference's scatter would drop the new
token's K/V; the port's decode refuses): ``decode_cache`` places one into
a cache with room, linear or a ring of ``ring_len`` slots.
``example_batch`` gives a cell's inputs on the meta device (shapes and
dtypes, nothing allocated) in place of the reference's
ShapeDtypeStructs."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import one_rank
from repro_torch.models import perf_flags as PF
from repro_torch.models import serving as S
from repro_torch.models import transformer as T
from repro_torch.training.train_loop import (  # noqa: F401
    make_train_step as build_train_step)

Cache = Dict[str, Any]


def example_batch(cfg: ModelConfig, shape: ShapeConfig,
                  dtype: torch.dtype = torch.bfloat16
                  ) -> Dict[str, torch.Tensor]:
    """Every model input of this cell as a meta-device tensor."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    out: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        out["tokens"] = meta((b, s), torch.int32)
        out["targets"] = meta((b, s), torch.int32)
        out["mask"] = meta((b, s), torch.float32)
    elif shape.kind == "prefill":
        out["tokens"] = meta((b, s), torch.int32)
    else:  # decode
        out["token"] = meta((b,), torch.int32)
    if cfg.vision is not None and shape.kind != "decode":
        out["vision_embeds"] = meta((b, cfg.vision.n_patches, cfg.d_model),
                                    dtype)
    if cfg.encoder is not None and shape.kind != "decode":
        out["frames"] = meta((b, cfg.encoder.n_frames, cfg.d_model), dtype)
    return out


def default_microbatches(cfg: ModelConfig) -> int:
    """Gradient-accumulation factor of the reference's train_4k step: MoE
    dispatch and the VLM's cross-attention memories need smaller live
    activation sets."""
    if cfg.vision is not None:
        return 8
    if cfg.moe is not None:
        return 4
    return 1


# ---------------------------------------------------------------------------
# Prefill (from scratch, cache as stacked fresh K/V)
# ---------------------------------------------------------------------------


def build_prefill_step(cfg: ModelConfig, attn_impl: str = "flash",
                       impl: str = "auto") -> Callable:
    """``prefill(params, tokens, extra) -> (logits (B, Vp), cache)`` for
    ``cfg``'s family; ``extra`` carries ``vision_embeds`` (VLM) or
    ``frames`` (enc-dec). Attention is naive up to 2048 tokens and
    blockwise past them unless ``attn_impl`` is "naive"; ``impl`` routes
    the blockwise attention and the recurrences (``ops``)."""
    if cfg.attn_kind == "rwkv":
        return _prefill_rwkv(cfg, impl)
    if cfg.attn_kind == "hybrid_rglru":
        return _prefill_hybrid(cfg, attn_impl, impl)
    return _prefill_attn(cfg, attn_impl, impl)


def _block_with_kv(cfg, p, x, positions, win, attn_impl, impl):
    """A pre-norm attention block that also returns its fresh K/V
    (``steps.py:150-166``)."""
    mesh = one_rank(x.device)
    (q, k, v), = T.block_qkv(cfg, [p], x, [positions], mesh)
    mode = "naive" if attn_impl == "naive" or q.shape[1] <= T.FLASH_SWITCH \
        else "flash"
    o = T.self_attention(cfg, q, k, v, positions, positions, win, mode,
                         impl=impl, from_scratch=True)
    del q
    b, s = x.shape[:2]
    return T.block_out(cfg, [p], x, [o], mesh,
                       groups=T.moe_groups(b * s)), k, v


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device).expand(b, s)


def _kv_out(cfg: ModelConfig, n: int, x: torch.Tensor) -> torch.Tensor:
    """Room for ``n`` layers' stacked K (or V) of the prompt in ``x``."""
    b, s = x.shape[:2]
    return torch.empty((n, b, s, cfg.n_kv_heads, cfg.head_dim),
                       dtype=x.dtype, device=x.device)


def _length(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.full((b,), s, dtype=torch.int32, device=tokens.device)


def _prefill_attn(cfg, attn_impl, impl):
    """The dense and MoE towers (``steps.py:169-187``), and the cross
    towers: a VLM's gated cross block after every ``cross_attn_every``
    layers over ``vision_embeds`` (``steps.py:190-228``), an enc-dec
    model's cross block after every layer over the encoded ``frames``
    (``steps.py:231-253``; the encoder blockwise at every length, as
    there)."""
    cross = T.cross_schedule(cfg)

    def prefill(params, tokens, extra):
        mesh = one_rank(tokens.device)
        positions = _positions(tokens)
        x = T.embed(cfg, [params], tokens, mesh)
        mem = extra.get("vision_embeds")
        if cfg.encoder is not None:
            mem = T.encode(cfg, [params], extra["frames"], mesh,
                           attn_impl="flash")
        ks, vs = _kv_out(cfg, cfg.n_layers, x), _kv_out(cfg, cfg.n_layers, x)
        cache: Cache = {}
        if cross:
            n_cross = len(cross)
            cache["cross_k"] = torch.empty(
                (n_cross, x.shape[0], mem.shape[1], cfg.n_kv_heads,
                 cfg.head_dim), dtype=x.dtype, device=x.device)
            cache["cross_v"] = torch.empty_like(cache["cross_k"])
        for li, win in enumerate(T.window_schedule(cfg)):
            x, ks[li], vs[li] = _block_with_kv(cfg, T.layer(params, li), x,
                                               positions, win, attn_impl,
                                               impl)
            if li in cross:
                ci, gated = cross[li]
                pc = T.layer(params, ci, "cross_blocks")
                mk, mv = T.memory_kv(cfg, [pc["attn"]], mem, mesh)
                x = T.cross_block_apply(cfg, [pc], x, mk, mv, gated, mesh)
                cache["cross_k"][ci], cache["cross_v"][ci] = mk, mv
        logits = T.unembed(cfg, [params], x[:, -1:], mesh)[:, 0]
        cache.update(k=ks, v=vs, length=_length(tokens))
        return logits, cache

    return prefill


def _prefill_rwkv(cfg, impl):
    """``steps.py:256-276``: every layer from zero states; the cache holds
    each layer's final state and token-shift inputs."""
    nh, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim

    def prefill(params, tokens, extra):
        mesh = one_rank(tokens.device)
        b = tokens.shape[0]
        x = T.embed(cfg, [params], tokens, mesh)
        dev = x.device
        state = torch.zeros((cfg.n_layers, b, nh, hd, hd),
                            dtype=torch.float32, device=dev)
        last = torch.zeros((cfg.n_layers, 2, b, cfg.d_model), dtype=x.dtype,
                           device=dev)
        zero = torch.zeros((b, cfg.d_model), dtype=x.dtype, device=dev)
        for li in range(cfg.n_layers):
            # the recurrence advances state[li] in place
            x, last[li, 0], last[li, 1] = T.rwkv_block_apply(
                cfg, [T.layer(params, li)], x, [state[li]], zero, zero, mesh,
                impl=impl)
        logits = T.unembed(cfg, [params], x[:, -1:], mesh)[:, 0]
        return logits, {"state": state, "last_tm": last[:, 0],
                        "last_cm": last[:, 1], "length": _length(tokens)}

    return prefill


def _prefill_hybrid(cfg, attn_impl, impl):
    """``steps.py:279-311``: RG-LRU blocks from zero states, local
    attention blocks at the window; the cache stacks the attention
    layers' K/V and the recurrent blocks' states and conv inputs."""
    w, cw = cfg.rglru.lru_width, cfg.rglru.conv1d_width
    win = cfg.window or T.GLOBAL_WINDOW

    def prefill(params, tokens, extra):
        mesh = one_rank(tokens.device)
        positions = _positions(tokens)
        b = tokens.shape[0]
        x = T.embed(cfg, [params], tokens, mesh)
        dev = x.device
        n_attn = S.attn_layer_count(cfg)
        n_rec = cfg.n_layers - n_attn
        ks, vs = _kv_out(cfg, n_attn, x), _kv_out(cfg, n_attn, x)
        # copied in: a block's conv state is a view of its whole
        # conv input (2.7 GB at 524,288 tokens of recurrentgemma-2b)
        hs = torch.empty((n_rec, b, w), dtype=torch.float32, device=dev)
        convs = torch.empty((n_rec, b, cw - 1, w), dtype=x.dtype,
                            device=dev)
        ri = ai = 0
        for kind in cfg.layer_kinds():
            if kind == "rglru":
                x, (hs[ri],), (convs[ri],) = T.rglru_block_apply(
                    cfg, [params["rglru_blocks"][ri]], x,
                    [torch.zeros((b, w), dtype=torch.float32, device=dev)],
                    [torch.zeros((b, cw - 1, w), dtype=x.dtype, device=dev)],
                    mesh, impl=impl)
                ri += 1
            else:
                x, ks[ai], vs[ai] = _block_with_kv(
                    cfg, params["attn_blocks"][ai], x, positions, win,
                    attn_impl, impl)
                ai += 1
        logits = T.unembed(cfg, [params], x[:, -1:], mesh)[:, 0]
        return logits, {"k": ks, "v": vs, "h": hs, "conv": convs,
                        "length": _length(tokens)}

    return prefill


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def build_decode_step(cfg: ModelConfig) -> Callable:
    """``decode(params, token, cache) -> (logits (B, Vp), cache)``: one
    ``serving.decode_step`` over one cache, updated in place; a full
    linear cache raises (``serving.check_room``)."""
    def decode(params, token, cache):
        S.check_room(cfg, [cache])
        logits, (cache,) = S.decode_step(cfg, [params], token, [cache],
                                         one_rank(token.device))
        return logits, cache

    return decode


def decode_cache(cfg: ModelConfig, prefill_cache: Cache, max_len: int,
                 ring: Optional[bool] = None) -> Cache:
    """A decode cache of ``max_len`` positions (a rotating buffer of
    ``min(max_len, ring_len)`` slots with ``ring``) holding a prefill
    builder's cache of S positions: a linear cache takes position t at
    slot t (S <= max_len), a ring the last ring_len positions at slot t
    mod ring_len; lengths, recurrent states and cross K/V are copied.
    ``ring=None`` takes the ring for ``swa`` and ``hybrid_rglru`` archs
    under ``perf_flags.ring_buffer_decode`` (the reference dry run's
    choice, ``dryrun.py:181-183``), else the linear cache."""
    if ring is None:
        ring = PF.get().ring_buffer_decode and \
            cfg.attn_kind in ("swa", "hybrid_rglru")
    src = prefill_cache
    ref = src["length"]
    b = ref.shape[0]
    leaf = src.get("k", src.get("last_tm"))
    dst, = S.init_cache(cfg, b, max_len, leaf.dtype, one_rank(ref.device),
                        ring=ring)
    for key, val in src.items():
        if key not in ("k", "v"):
            dst[key].copy_(val)
    if "k" in src:
        s, slots = src["k"].shape[2], dst["k"].shape[2]
        if not ring and s > slots:
            raise ValueError(f"{s} prompt positions do not fit a linear "
                             f"cache of {slots}")
        first = max(0, s - slots)
        t = torch.arange(first, s, device=ref.device)
        for key in ("k", "v"):
            dst[key].index_copy_(2, t % slots, src[key][:, :, first:])
    return dst
