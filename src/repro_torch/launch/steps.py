"""Step builders for the reference's shapes (the counterpart of
``repro/launch/steps.py``): one builder per step kind.

  * ``build_train_step`` — ``training/train_loop.py::make_train_step``
    (forward with remat -> grads -> AdamW), re-exported.
  * ``build_prefill_step`` — prompt -> (last-position logits, cache) from
    scratch, every family (dense and MoE, VLM, enc-dec, rwkv, hybrid)
    through one body: ``serving.tower``'s layers from zeroed caches, each
    attention layer's queries over the prompt's own fresh K/V
    (``serving.fresh_heads``: past 2048 tokens the dense ``flash_prefill``
    kernel on the card under ``impl="auto"``, one launch per rank of the
    heads), the rwkv and hybrid towers' WKV6 and RG-LRU as serving runs
    them. The cache holds position t of every attention layer at slot t,
    with no room: what a PD-disaggregated prefill TE ships to a decode
    TE. Given ``max_len`` (and ``ring``), each layer's K/V go straight
    into the decode cache ``decode_cache`` would make, as the layer makes
    them, so the stacked cache never exists (h2o-danube-3-4b's long_500k:
    48.3 GB stacked, a 4352-slot ring 0.40 GB).
  * ``build_decode_step`` — ``serving.decode_step``, after
    ``serving.check_room``.

Over a mesh (``mesh=EngineMesh``) the functions take the ranks' weights
trees (``sharding.shard``) and rank caches split by
``sharding.engine_cache_specs`` (the attention layers' sequence, the rwkv
heads, the RG-LRU width), as the reference's prefill step emits its cache
under ``cache_specs`` (``dryrun.py:167-172``); they return rank caches.
Without one they take one weights tree and one cache on the inputs'
device, as the reference's builders do: the mesh of one rank.

The builders' caches hold exactly the prompt's S positions, so a decode
step on one has no room (the reference's scatter would drop the new
token's K/V; the port's decode refuses): ``decode_cache`` places one into
a cache with room, linear or a ring of ``ring_len`` slots.
``example_batch`` gives a cell's inputs on the meta device (shapes and
dtypes, nothing allocated) in place of the reference's
ShapeDtypeStructs."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import EngineMesh, one_rank
from repro_torch.models import perf_flags as PF
from repro_torch.models import serving as S
from repro_torch.models import transformer as T
from repro_torch.training.train_loop import (  # noqa: F401
    make_train_step as build_train_step)



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
# Prefill (from scratch) and decode
# ---------------------------------------------------------------------------


def build_prefill_step(cfg: ModelConfig, attn_impl: str = "flash",
                       impl: str = "auto", mesh: Optional[EngineMesh] = None,
                       max_len: Optional[int] = None,
                       ring: bool = False) -> Callable:
    """``prefill(params, tokens, extra) -> (logits (B, Vp), cache)`` for
    ``cfg``'s family; ``extra`` carries ``vision_embeds`` (VLM) or
    ``frames`` (enc-dec). Attention is naive up to 2048 tokens and
    blockwise past them unless ``attn_impl`` is "naive"; ``impl`` routes
    the blockwise attention and the recurrences (``ops``). ``mesh``: the
    ranks (module docstring). ``max_len`` / ``ring``: the cache is
    ``decode_cache(cfg, cache, max_len, ring)``, placed as it is made
    (``ring=False``: linear, ``max_len`` at least the prompt's length)."""
    def prefill(ps, tokens, extra, mesh):
        b, s = tokens.shape
        caches = S.init_cache(cfg, b, s if max_len is None else max_len,
                              ps[0]["embed"].dtype, mesh, ring=ring)
        c0 = caches[0]
        x = T.embed(cfg, ps, tokens, mesh)
        if cfg.vision is not None:
            S.fill_cross_cache(cfg, ps, extra["vision_embeds"], c0, mesh)
        if cfg.encoder is not None:
            S.fill_cross_cache(cfg, ps, T.encode(
                cfg, ps, extra["frames"], mesh, attn_impl="flash"), c0, mesh)
        pos = mesh.broadcast(torch.arange(s, device=tokens.device).expand(
            b, s))
        mode = "naive" if attn_impl == "naive" or s <= T.FLASH_SWITCH \
            else "flash"
        groups = T.moe_groups(b * s)
        kv = {key: SH.held([c[key] for c in caches])
              for key in ("k", "v") if key in c0}

        def attend(lps, x, ai, win):
            # a pre-norm attention block that places its fresh K/V
            # (``steps.py:150-166``)
            qkv = T.block_qkv(cfg, lps, x, pos, mesh)
            outs = S.fresh_heads(cfg, qkv, pos, win, mode, impl)
            for i, key in ((1, "k"), (2, "v")):
                _place_kv([part[ai] for part in kv[key]],
                          mesh.all_gather([t[i] for t in qkv], 2), ring)
            del qkv
            return T.block_out(cfg, lps, x, outs, mesh, groups=groups)
        x = S.tower(cfg, ps, x, caches, mesh, attend, None, impl)
        c0["length"].fill_(s)
        return T.unembed(cfg, ps, x[:, -1:], mesh)[:, 0], caches

    if mesh is not None:
        return lambda ps, tokens, extra: prefill(ps, tokens, extra, mesh)

    def one_tree(params, tokens, extra):
        logits, (cache,) = prefill([params], tokens, extra,
                                   one_rank(tokens.device))
        return logits, cache
    return one_tree


def _place_kv(parts: List[torch.Tensor], new: torch.Tensor,
              ring: bool) -> None:
    """One layer's K or V of positions 0..S-1 (``new`` (B, S, Hkv, hd))
    into a cache's sequence parts (B, Sr, Hkv, hd), rank r's holding slots
    r*Sr..(r+1)*Sr-1 of ``slots``: position t at slot t of a linear cache
    (S <= slots), the last ``slots`` positions at slot t mod slots of a
    ring. Slices copied in place; slots no position reaches are kept."""
    s, sr = new.shape[1], parts[0].shape[1]
    slots = sr * len(parts)
    if not ring and s > slots:
        raise ValueError(f"{s} prompt positions do not fit a linear cache "
                         f"of {slots}")
    first = max(0, s - slots)
    for r, part in enumerate(parts):
        for lap in (first // slots, first // slots + 1):
            lo = lap * slots + r * sr      # the position at the part's slot 0
            a, b = max(first, lo), min(s, lo + sr)
            if a < b:
                part[:, a - lo:b - lo].copy_(new[:, a:b])


def build_decode_step(cfg: ModelConfig,
                      mesh: Optional[EngineMesh] = None) -> Callable:
    """``decode(params, token, cache) -> (logits (B, Vp), cache)``: one
    ``serving.decode_step`` over the cache, updated in place; a full
    linear cache raises (``serving.check_room``). ``mesh``: the ranks."""
    def decode(ps, token, caches, mesh):
        S.check_room(cfg, caches)
        return S.decode_step(cfg, ps, token, caches, mesh)

    if mesh is not None:
        return lambda ps, token, caches: decode(ps, token, caches, mesh)

    def one_tree(params, token, cache):
        logits, (cache,) = decode([params], token, [cache],
                                  one_rank(token.device))
        return logits, cache
    return one_tree


def decode_cache(cfg: ModelConfig, prefill_cache, max_len: int,
                 ring: Optional[bool] = None,
                 mesh: Optional[EngineMesh] = None):
    """A decode cache of ``max_len`` positions (a rotating buffer of
    ``min(max_len, ring_len)`` slots with ``ring``) holding a prefill
    builder's cache of S positions (``_place_kv``: a linear cache takes
    position t at slot t, S <= max_len; a ring the last ring_len
    positions at slot t mod ring_len); lengths, recurrent states and
    cross K/V are copied. ``ring=None`` takes the ring for ``swa`` and
    ``hybrid_rglru`` archs under ``perf_flags.ring_buffer_decode`` (the
    reference dry run's choice, ``dryrun.py:181-183``), else the linear
    cache. ``mesh``: rank caches in and out, each layer's K/V parts joined
    on rank 0 and split again over the new cache's."""
    if mesh is None:
        return _decode_cache(cfg, [prefill_cache], max_len, ring, one_rank(
            prefill_cache["length"].device))[0]
    return _decode_cache(cfg, prefill_cache, max_len, ring, mesh)


def _decode_cache(cfg, caches, max_len, ring, mesh):
    if ring is None:
        ring = PF.get().ring_buffer_decode and \
            cfg.attn_kind in ("swa", "hybrid_rglru")
    src = caches[0]
    leaf = src.get("k", src.get("last_tm"))
    dst = S.init_cache(cfg, src["length"].shape[0], max_len, leaf.dtype,
                       mesh, ring=ring)
    for key in src:
        got = SH.held([c[key] for c in caches])
        put = SH.held([c[key] for c in dst])
        if key not in ("k", "v"):
            for d, t in zip(put, got):
                d.copy_(t)
            continue
        for li in range(leaf.shape[0]):
            _place_kv([d[li] for d in put],
                      mesh.all_gather([t[li] for t in got], 1), ring)
    return dst
