"""Transformer towers of the port (``repro/models/transformer.py``):
parameter init with the reference's distributions, embedding /
unembedding, the per-layer window schedule, the two halves of an attention
block that the runners wrap around their attention kernels, the rwkv and
rglru blocks, the cross-attention blocks and the bidirectional encoder of
the enc-dec and VLM towers, the reference's self-attention switch
(``self_attention``: naive up to 2048 keys, blockwise flash past them, the
dense ``flash_prefill`` kernel on the card) and a teacher-forced
``forward``.

Parameters are a plain dict mirroring the JAX pytree: per-layer tensors
are stacked on a leading layer axis under ``blocks`` (dense, rwkv, enc-dec
and VLM towers; also ``enc_blocks`` and ``cross_blocks``); the hybrid
tower keeps per-kind lists ``rglru_blocks`` and ``attn_blocks``, as the
reference does."""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import one_rank, split_ranks
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import perf_flags as PF
from repro_torch.models import rglru as G
from repro_torch.models import rwkv6 as R

GLOBAL_WINDOW = 2 ** 30  # sentinel "window" meaning full causal attention
FLASH_SWITCH = 2048      # keys past which "auto" attention goes blockwise
FLASH_CHUNK = 1024       # keys per chunk of the blockwise form


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device="cuda") -> Dict[str, Any]:
    """Random weights with the reference's distributions
    (``transformer.py:40-125``), drawn from ``gen`` on ``device`` one layer
    at a time, so a full-width model never holds an fp32 copy or a second
    copy of its stacked layers. Norm scales and the VLM cross blocks'
    gates are fp32 (rmsnorm zeros in the ``(1 + w)`` form; layernorm ones
    and zero bias; gates zero, as the reference inits them). On the
    ``meta`` device (any generator) it allocates nothing: the tree's
    structure and shapes alone."""
    dev = resolve_device(device)
    if dev.type != "meta" and gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params on {dev}")
    if cfg.attn_kind not in ("global", "swa", "local_global", "rwkv",
                             "hybrid_rglru"):
        raise NotImplementedError(f"attn_kind {cfg.attn_kind!r}")
    d, vp = cfg.d_model, cfg.padded_vocab
    params: Dict[str, Any] = {
        "embed": _normal(gen, (vp, d), 0.02, dtype, dev),
        "final_norm": _init_norm(cfg, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (d, vp), 1.0 / math.sqrt(d), dtype,
                                    dev)
    if cfg.attn_kind == "rwkv":
        params["blocks"] = _stack_layers(cfg.n_layers, lambda: {
            "ln1": _init_norm(cfg, dev),
            "tm": R.init_rwkv_block(gen, d, cfg.d_ff, cfg.rwkv.head_dim,
                                    dtype, dev),
            "ln2": _init_norm(cfg, dev)})
    elif cfg.attn_kind == "hybrid_rglru":
        # heterogeneous tower: per-kind lists, as the reference keeps them
        params["rglru_blocks"], params["attn_blocks"] = [], []
        for kind in cfg.layer_kinds():
            if kind == "rglru":
                params["rglru_blocks"].append({
                    "ln1": _init_norm(cfg, dev),
                    "rec": G.init_rglru_block(gen, d, cfg.rglru.lru_width,
                                              cfg.rglru.conv1d_width, dtype,
                                              dev),
                    "ln2": _init_norm(cfg, dev),
                    "mlp": _init_mlp(cfg, gen, dtype, dev)})
            else:
                params["attn_blocks"].append(
                    _init_attn_block(cfg, gen, dtype, dev))
    else:
        params["blocks"] = _stack_layers(
            cfg.n_layers, lambda: _init_attn_block(cfg, gen, dtype, dev))
    if cfg.vision is not None:
        params["cross_blocks"] = _stack_layers(
            len(cfg.cross_attn_layers()),
            lambda: _init_attn_block(cfg, gen, dtype, dev, cross=True))
    if cfg.encoder is not None:
        params["enc_blocks"] = _stack_layers(
            cfg.encoder.n_layers,
            lambda: _init_attn_block(cfg, gen, dtype, dev))
        params["enc_final_norm"] = _init_norm(cfg, dev)
        params["cross_blocks"] = _stack_layers(cfg.n_layers, lambda: {
            "ln": _init_norm(cfg, dev),
            "attn": _init_attn(cfg, gen, dtype, dev, qk_norm=False)})
    return params


def meta_params(cfg: ModelConfig) -> Dict[str, Any]:
    """``cfg``'s weights tree on the meta device: its structure and leaf
    shapes, nothing allocated."""
    return init_params(cfg, torch.Generator(), torch.float32, "meta")


def _normal(gen, shape, std, dtype, dev) -> torch.Tensor:
    if dev.type == "meta":          # shapes only: nothing to draw
        return torch.empty(shape, dtype=dtype, device=dev)
    return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)


def _init_norm(cfg: ModelConfig, dev) -> dict:
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=dev),
                "bias": torch.zeros((d,), dtype=torch.float32, device=dev)}
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=dev)}


def _init_mlp(cfg: ModelConfig, gen, dtype, dev) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": _normal(gen, (d, f), 1.0 / math.sqrt(d), dtype, dev),
         "w_down": _normal(gen, (f, d), 1.0 / math.sqrt(f), dtype, dev)}
    if cfg.mlp_act in ("swiglu", "geglu"):
        p["w_gate"] = _normal(gen, (d, f), 1.0 / math.sqrt(d), dtype, dev)
    return p


def _init_attn(cfg: ModelConfig, gen, dtype, dev, qk_norm: bool) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = {"wq": _normal(gen, (d, h * hd), 1.0 / math.sqrt(d), dtype, dev),
            "wk": _normal(gen, (d, hkv * hd), 1.0 / math.sqrt(d), dtype, dev),
            "wv": _normal(gen, (d, hkv * hd), 1.0 / math.sqrt(d), dtype, dev),
            "wo": _normal(gen, (h * hd, d), 1.0 / math.sqrt(h * hd), dtype,
                          dev)}
    if qk_norm:
        attn["q_norm"] = torch.zeros((hd,), dtype=torch.float32, device=dev)
        attn["k_norm"] = torch.zeros((hd,), dtype=torch.float32, device=dev)
    return attn


def _init_attn_block(cfg: ModelConfig, gen, dtype, dev,
                     cross: bool = False) -> dict:
    """A self-attention block, or (``cross``) a VLM's gated cross block:
    the same layout with fp32 scalar gates and a dense MLP."""
    p = {"ln1": _init_norm(cfg, dev),
         "attn": _init_attn(cfg, gen, dtype, dev, cfg.qk_norm)}
    if cross:
        p["gate_attn"] = torch.zeros((), dtype=torch.float32, device=dev)
        p["gate_mlp"] = torch.zeros((), dtype=torch.float32, device=dev)
    p["ln2"] = _init_norm(cfg, dev)
    if cfg.moe is not None and not cross:
        p["moe"] = M.init_moe(gen, cfg.d_model, cfg.moe, cfg.mlp_act, dtype,
                              dev)
    else:
        p["mlp"] = _init_mlp(cfg, gen, dtype, dev)
    if cfg.post_norms:
        p["ln1_post"] = _init_norm(cfg, dev)
        p["ln2_post"] = _init_norm(cfg, dev)
    return p


def _stack_layers(n: int, make) -> dict:
    """``n`` layers drawn by ``make()``, stacked leaf by leaf on a leading
    layer axis and written into the stacked tensors one layer at a time."""
    first = make()

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
        out[0] = t
        return out

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    stacked = alloc(first)
    for i in range(1, n):
        put(stacked, make(), i)
    return stacked


def layer(params, li: int, key: str = "blocks") -> dict:
    """Layer ``li``'s view of the stacked ``params[key]`` tree (no
    copy)."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[li]
    return pick(params[key])


def window_schedule(cfg: ModelConfig) -> List[int]:
    return [(cfg.window or GLOBAL_WINDOW) if kind == "attn_local"
            else GLOBAL_WINDOW for kind in cfg.layer_kinds()]


# ------------------------------------------------- the block bodies
# ``ps`` is the list of the ranks' weights trees (or one layer's views of
# them) and ``mesh`` the TE's ``launch.mesh.EngineMesh``; a caller with
# one tree passes ``[p]`` and ``one_rank(device)``. A split product's
# partials go through ``mesh.all_reduce`` and vocab slices through
# ``mesh.all_gather``, the identity over one rank, so a tp-1 TE keeps its
# arithmetic bit for bit. Which ranks take part in a product is read off
# the shards' widths: all of them when it splits, rank 0 alone when it is
# replicated (``launch.mesh.split_ranks``). Activations live on rank 0's
# device.


def embed(cfg: ModelConfig, ps: list, tokens: torch.Tensor,
          mesh) -> torch.Tensor:
    """Token ids -> (…, D) embeddings. A vocab-split table (every
    ``padded_vocab`` a multiple of 256 splits over any tp up to 256) is a
    masked lookup per rank, all-reduced: a token's row comes from the one
    rank holding it, the others add zeros. A table split on ``d_model``
    (a wider tp) gathers each rank's columns."""
    rows, cols = ps[0]["embed"].shape
    toks = mesh.broadcast(tokens)
    parts = []
    for r, p in enumerate(split_ranks(ps, cfg.padded_vocab * cfg.d_model,
                                       rows * cols)):
        t = toks[r] - (r * rows) % cfg.padded_vocab
        ok = ((t >= 0) & (t < rows))[..., None]
        parts.append(p["embed"][t.clamp(0, rows - 1)].masked_fill(~ok, 0))
    x = mesh.all_gather(parts, -1) if cols < cfg.d_model \
        else mesh.all_reduce(parts)
    if cfg.embed_scale:
        # the scale is rounded to the embedding's dtype first, as in the
        # reference (a bf16 model multiplies by bf16(sqrt(d)))
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed(cfg: ModelConfig, ps: list, x: torch.Tensor,
            mesh) -> torch.Tensor:
    """(…, D) -> (…, padded_vocab) logits: the final norm once, each
    rank's vocab slice (the untied head's shard, or the tied table's shard
    transposed), gathered before the final softcap in fp32. A tied table
    split on ``d_model`` gives partial sums over each rank's columns,
    all-reduced."""
    h = L.apply_norm(x, ps[0]["final_norm"], cfg.norm)
    heads = [p["embed"].T if cfg.tie_embeddings else p["lm_head"]
             for p in ps]
    d, v = heads[0].shape
    hs = mesh.broadcast(h)
    parts = [(hr if d == cfg.d_model else hr[..., r * d:(r + 1) * d]) @ w
             for r, (hr, w) in enumerate(zip(
                 hs, split_ranks(heads, cfg.padded_vocab * cfg.d_model,
                                  d * v)))]
    logits = mesh.all_reduce(parts) if d < cfg.d_model \
        else mesh.all_gather(parts, -1)
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = (cap * torch.tanh(logits.float() / cap)).to(logits.dtype)
    return logits


def block_qkv(cfg: ModelConfig, ps: list, x: torch.Tensor,
              positions: list, mesh) -> list:
    """First half of an attention block: pre-norm, then q/k/v (+ qk-norm,
    rope) on every rank holding a head slice. x (B,S,D), ``positions``
    one per rank -> [(q (B,S,H/tp,hd), k/v (B,S,Hkv/tp,hd))] per such
    rank (one whole triple when attention replicates). qk-norm is per
    head, so it shards with the heads."""
    h = L.apply_norm(x, ps[0]["ln1"], cfg.norm)
    hd = cfg.head_dim
    width = ps[0]["attn"]["wq"].shape[-1]
    return [L.attn_qkv(p["attn"], hr, width // hd,
                       p["attn"]["wk"].shape[-1] // hd, hd, pos,
                       cfg.rope_theta, cfg.qk_norm)
            for p, hr, pos in zip(split_ranks(ps, cfg.n_heads * hd, width),
                                  mesh.broadcast(h), positions)]


def block_out(cfg: ModelConfig, ps: list, x: torch.Tensor, os: list,
              mesh, groups: int = 1) -> torch.Tensor:
    """Second half: output projection, residual, MLP (or MoE, over
    ``groups`` capacity groups), residual. ``os``: the attention outputs
    (B,S,H/tp,hd) of ``block_qkv``'s ranks, whose output projections'
    partials are all-reduced; the split MLP's are too. gemma2's post-norms
    apply to the reduced sums. The engine's passes take one group, as the
    reference's paged runner does."""
    a = mesh.all_reduce([L.attn_out(p["attn"], o) for p, o in zip(ps, os)])
    if cfg.post_norms:
        a = L.apply_norm(a, ps[0]["ln1_post"], cfg.norm)
    x = x + a
    h = L.apply_norm(x, ps[0]["ln2"], cfg.norm)
    m = _ffn(cfg, ps, h, mesh, groups)
    if cfg.post_norms:
        m = L.apply_norm(m, ps[0]["ln2_post"], cfg.norm)
    return x + m


def _ffn(cfg: ModelConfig, ps: list, h: torch.Tensor, mesh,
         groups: int = 1) -> torch.Tensor:
    """A block's FFN over its normed input: the MoE (over ``groups``
    capacity groups), or the dense MLP whose ``d_ff`` slices' partials
    are all-reduced."""
    if "moe" in ps[0]:
        return M.moe_apply([p["moe"] for p in ps], h, cfg.moe, cfg.mlp_act,
                           mesh, groups=groups)
    w = ps[0]["mlp"]["w_up"].shape[-1]
    return mesh.all_reduce([L.mlp_apply(p["mlp"], hr, cfg.mlp_act)
                            for p, hr in zip(split_ranks(ps, cfg.d_ff, w),
                                             mesh.broadcast(h))])


def self_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
                   window: Optional[int], attn_impl: str = "auto",
                   causal: bool = True, impl: str = "auto",
                   from_scratch: bool = False) -> torch.Tensor:
    """Self-attention of q (B,Sq,H,hd) over k/v (B,Sk,Hkv,hd) by the
    reference's switch (``transformer.py:148-175``): ``attn_impl`` "naive"
    (masked, materialised scores), "flash" (blockwise), or "auto" (naive
    up to ``FLASH_SWITCH`` keys, blockwise past them; with
    ``perf_flags.banded_swa_prefill`` an ``swa`` arch's causal prefill
    takes the banded form instead). A non-causal call (the encoder)
    attends to every key.

    The blockwise route is the Pallas ``flash_prefill``'s function: a
    causal ``from_scratch`` attention (q and k at positions 0..S-1) on
    CUDA tensors under ``impl="auto"`` launches the dense ``flash_prefill``
    kernel, with the window and the softcap (it refuses autograd: a loss
    passes ``impl="scan"``), and raises for other positions; ``impl="ref"``
    or ``"scan"`` and CPU tensors run the plain blockwise function. The
    kernel is causal only, so a non-causal call past the switch is plain at
    every route."""
    if attn_impl not in ("naive", "flash", "auto"):
        raise ValueError(f"attn_impl must be 'naive', 'flash' or 'auto', "
                         f"got {attn_impl!r}")
    sk = k.shape[1]
    cap = cfg.attn_logit_softcap
    if attn_impl == "naive" or (attn_impl == "auto" and sk <= FLASH_SWITCH):
        mask = L.causal_mask(q_pos, k_pos, window) if causal else None
        return L.attention(q, k, v, mask, cap)
    if causal and ops._route(q, impl) == "cuda":
        if not from_scratch:
            raise NotImplementedError(
                "the flash_prefill kernel attends positions 0..S-1 of a "
                "from-scratch prefill; pass impl='ref' for other positions")
        return ops.flash_prefill(
            q, k, v, softcap=cap,
            window=None if window is None or window >= GLOBAL_WINDOW
            else window)
    if (PF.get().banded_swa_prefill and cfg.attn_kind == "swa" and causal
            and cfg.window is not None and cfg.window + 1024 < sk
            and q.shape[1] == sk):
        return L.banded_swa_attention(q, k, v, cfg.window, cap)
    return L.flash_attention(q, k, v, q_pos, k_pos, window, cap,
                             chunk=min(FLASH_CHUNK, sk), causal=causal)


def attn_block_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     positions: torch.Tensor, window: int,
                     attn_impl: str = "auto", impl: str = "auto",
                     from_scratch: bool = False) -> torch.Tensor:
    """A whole attention block over the block's own tokens (the
    teacher-forced path), its attention by ``self_attention``."""
    mesh = one_rank(x.device)
    (q, k, v), = block_qkv(cfg, [p], x, [positions], mesh)
    o = self_attention(cfg, q, k, v, positions, positions, window,
                       attn_impl, impl=impl, from_scratch=from_scratch)
    return block_out(cfg, [p], x, [o], mesh,
                     groups=moe_groups(x.shape[0] * x.shape[1]))


def moe_groups(tokens: int) -> int:
    """The teacher-forced forward's capacity groups (the reference's
    ``_moe_groups``): the most of 16, 8, 4, 2 that splits ``tokens``
    evenly with at least 64 tokens per group, else 1."""
    for g in (16, 8, 4, 2, 1):
        if tokens % g == 0 and tokens // g >= 64:
            return g
    return 1


def rwkv_block_apply(cfg: ModelConfig, ps: list, x: torch.Tensor,
                     states: list, last_tm: torch.Tensor,
                     last_cm: torch.Tensor, mesh,
                     n_valid=None, impl: str = "auto"):
    """Pre-norm time mix + channel mix (``transformer.py:251-261``) over
    the ranks' layer trees ``ps``; each rank's state in ``states`` is
    advanced in place (``rwkv6.rwkv_time_mix``). Returns (x, last_tm,
    last_cm)."""
    tms = [p["tm"] for p in ps]
    h = L.apply_norm(x, ps[0]["ln1"], cfg.norm)
    y, _, last_tm = R.rwkv_time_mix(tms, h, cfg.rwkv.head_dim, states,
                                    last_tm, mesh, n_valid=n_valid,
                                    impl=impl)
    x = x + y
    h = L.apply_norm(x, ps[0]["ln2"], cfg.norm)
    y, last_cm = R.rwkv_channel_mix(tms, h, last_cm, mesh, cfg.d_ff,
                                    n_valid=n_valid)
    return x + y, last_tm, last_cm


def rglru_block_apply(cfg: ModelConfig, ps: list, x: torch.Tensor,
                      h0s: list, convs: list, mesh,
                      n_valid=None, impl: str = "auto"):
    """Pre-norm recurrent block + MLP (``transformer.py:264-272``) over the
    ranks' layer trees ``ps`` and their (B, W_r) states and conv inputs.
    Returns (x, [h per rank], [conv state per rank]) for the ranks holding
    channels (``rglru.rglru_block_apply``)."""
    h = L.apply_norm(x, ps[0]["ln1"], cfg.norm)
    y, hs, convs = G.rglru_block_apply([p["rec"] for p in ps], h, h0s,
                                       convs, mesh, n_valid=n_valid,
                                       impl=impl)
    x = x + y
    h = L.apply_norm(x, ps[0]["ln2"], cfg.norm)
    return x + _ffn(cfg, ps, h, mesh), hs, convs


def cross_block_apply(cfg: ModelConfig, ps: list, x: torch.Tensor,
                      mem_k: torch.Tensor, mem_v: torch.Tensor,
                      gated: bool, mesh) -> torch.Tensor:
    """Cross-attention block (``transformer.py:222-240``) over the ranks'
    layer trees ``ps``: each rank's queries (its ``wq`` heads) attend to
    every position of the modality memory's mem_k/mem_v (B, P, Hkv, hd,
    replicated) at the KV heads of its group, and the output projections'
    partials are all-reduced. A VLM block (``gated``) adds its attention
    and its MLP through tanh gates; an enc-dec block adds its attention
    alone."""
    p0 = ps[0]
    h = L.apply_norm(x, p0["ln1"] if "ln1" in p0 else p0["ln"], cfg.norm)
    b, s, _ = h.shape
    hd = cfg.head_dim
    width = p0["attn"]["wq"].shape[-1]
    hr = width // hd                          # query heads per rank
    kr = hr * cfg.n_kv_heads // cfg.n_heads   # their KV heads
    parts = []
    for r, (p, hb, mk, mv) in enumerate(zip(
            split_ranks(ps, cfg.n_heads * hd, width), mesh.broadcast(h),
            mesh.broadcast(mem_k), mesh.broadcast(mem_v))):
        q = (hb @ p["attn"]["wq"]).reshape(b, s, hr, hd)
        g = slice(r * kr, (r + 1) * kr)
        parts.append(L.attn_out(p["attn"], L.attention(
            q, mk[:, :, g].to(q.dtype), mv[:, :, g].to(q.dtype), None,
            cfg.attn_logit_softcap)))
    o = mesh.all_reduce(parts)
    if not gated:
        return x + o
    x = x + torch.tanh(p0["gate_attn"]).to(o.dtype) * o
    m = _ffn(cfg, ps, L.apply_norm(x, p0["ln2"], cfg.norm), mesh)
    return x + torch.tanh(p0["gate_mlp"]).to(m.dtype) * m


def memory_kv(cfg: ModelConfig, ps_attn: list, mem: torch.Tensor, mesh):
    """Project the modality memory (B, P, D) into the cross K/V (B, P,
    Hkv, hd), no rope (``transformer.py:243-248``): each rank's KV heads
    from its ``wk``/``wv`` shards, gathered on rank 0."""
    b, s, _ = mem.shape
    hd = cfg.head_dim
    width = ps_attn[0]["wk"].shape[-1]
    ranks = split_ranks(ps_attn, cfg.n_kv_heads * hd, width)
    mems = mesh.broadcast(mem)

    def proj(name):
        return mesh.all_gather([(m @ p[name]).reshape(b, s, width // hd, hd)
                                for p, m in zip(ranks, mems)], 2)
    return proj("wk"), proj("wv")


def encode(cfg: ModelConfig, ps: list, frames: torch.Tensor,
           mesh, remat: bool = False, attn_impl: str = "auto"
           ) -> torch.Tensor:
    """Bidirectional encoder over precomputed frame embeddings (B, F, D)
    (``transformer.py:490-519``) on the ranks' trees ``ps``: each layer's
    heads split as a decoder block's (``block_qkv`` / ``block_out``), its
    attention non-causal by ``self_attention`` (naive up to 2048 frames,
    the plain blockwise form past them at every route: the kernel is
    causal only). ``remat`` recomputes each layer in the backward
    (``_maybe_remat``)."""
    b, f, _ = frames.shape
    pos = mesh.broadcast(torch.arange(f, device=frames.device).expand(b, f))

    def enc_layer(x, lps):
        return block_out(cfg, lps, x, [
            self_attention(cfg, q, k, v, p, p, None, attn_impl,
                           causal=False)
            for (q, k, v), p in zip(block_qkv(cfg, lps, x, pos, mesh), pos)],
            mesh)

    blk = _maybe_remat(enc_layer, remat)
    x = frames
    for li in range(cfg.encoder.n_layers):
        x = blk(x, [layer(p, li, "enc_blocks") for p in ps])
    return L.apply_norm(x, ps[0]["enc_final_norm"], cfg.norm)


def _maybe_remat(fn, remat: bool):
    """Per-block rematerialization (the reference's ``_maybe_remat``):
    with ``remat`` the backward keeps only each block's input and
    recomputes the block. The forward draws no random numbers, so no RNG
    state is saved."""
    if not remat:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            vision_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, attn_impl: str = "auto",
            impl: str = "auto", remat: bool = False) -> torch.Tensor:
    """Teacher-forced logits (B, S, padded_vocab) with zero initial
    recurrent states — the counterpart of ``T.forward``, its
    self-attention by ``attn_impl`` ("naive", "flash" or "auto": naive up
    to 2048 keys, blockwise past them; ``self_attention``). A VLM runs
    its cross blocks only when given ``vision_embeds`` (as the reference's
    tower choice does); an enc-dec model needs ``frames``. ``impl``
    routes the two recurrences (``ops.wkv6`` / ``ops.rglru``) and the
    blockwise attention (the ``flash_prefill`` kernel on CUDA tensors
    when ``positions`` is left to its default 0..S-1): under autograd
    pass "scan" (the train step's route: the recurrences in the
    reference's sequence forms, attention plain) or "ref" (the per-token
    loops), since the CUDA kernels have no backward and refuse it.
    ``remat`` recomputes each block in the backward (a decoder layer with
    the cross block that follows it, as one). Used by the train loop, the
    tests and the on-card greedy oracle."""
    b, s = tokens.shape
    from_scratch = positions is None
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    mesh = one_rank(tokens.device)
    x = embed(cfg, [params], tokens, mesh)
    dev = x.device
    if cfg.attn_kind == "rwkv":
        nh, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim

        def rwkv_layer(x, lp):
            # the zero states are made inside the block: ops.wkv6 writes
            # the final state over its input on every route (the chunked
            # form of impl "scan" reads it through a copy), and a
            # recomputed block must start from zeros again
            state = torch.zeros((b, nh, hd, hd), dtype=torch.float32,
                                device=dev)
            last = torch.zeros((b, cfg.d_model), dtype=x.dtype, device=dev)
            return rwkv_block_apply(cfg, [lp], x, [state], last, last, mesh,
                                    impl=impl)[0]

        blk = _maybe_remat(rwkv_layer, remat)
        for li in range(cfg.n_layers):
            x = blk(x, layer(params, li))
    elif cfg.attn_kind == "hybrid_rglru":
        w, cw = cfg.rglru.lru_width, cfg.rglru.conv1d_width

        def rglru_layer(x, lp):
            return rglru_block_apply(
                cfg, [lp], x,
                [torch.zeros((b, w), dtype=torch.float32, device=dev)],
                [torch.zeros((b, cw - 1, w), dtype=x.dtype, device=dev)],
                mesh, impl=impl)[0]

        def attn_layer(x, lp):
            return attn_block_apply(cfg, lp, x, positions,
                                    cfg.window or GLOBAL_WINDOW, attn_impl,
                                    impl, from_scratch)

        rec_blk = _maybe_remat(rglru_layer, remat)
        att_blk = _maybe_remat(attn_layer, remat)
        ri = ai = 0
        for kind in cfg.layer_kinds():
            if kind == "rglru":
                x = rec_blk(x, params["rglru_blocks"][ri])
                ri += 1
            else:
                x = att_blk(x, params["attn_blocks"][ai])
                ai += 1
    else:
        mem, cross = vision_embeds, cross_schedule(cfg)
        if cfg.encoder is not None:
            if frames is None:
                raise ValueError(f"{cfg.name}: an enc-dec model needs frames")
            mem = encode(cfg, [params], frames, mesh, remat=remat,
                         attn_impl=attn_impl)

        def dec_layer(x, lp, win, pc, gated):
            x = attn_block_apply(cfg, lp, x, positions, win, attn_impl, impl,
                                 from_scratch)
            if pc is None:
                return x
            return cross_block_apply(cfg, [pc], x,
                                     *memory_kv(cfg, [pc["attn"]], mem, mesh),
                                     gated, mesh)

        blk = _maybe_remat(dec_layer, remat)
        for li, win in enumerate(window_schedule(cfg)):
            ci, gated = cross.get(li, (None, False))
            pc = None if ci is None or mem is None \
                else layer(params, ci, "cross_blocks")
            x = blk(x, layer(params, li), win, pc, gated)
    return unembed(cfg, [params], x, mesh)


def cross_schedule(cfg: ModelConfig) -> Dict[int, tuple]:
    """Decoder layer -> (cross block index, gated) for every layer a cross
    block follows: each of a VLM's cross layers (gated blocks), every
    layer of an enc-dec model (ungated)."""
    if cfg.encoder is not None:
        return {li: (li, False) for li in range(cfg.n_layers)}
    return {li: (ci, True) for ci, li in enumerate(cfg.cross_attn_layers())}
