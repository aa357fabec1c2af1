"""Sharding rules (the port's copy of ``repro/launch/sharding.py``): one
set of rules for the production mesh of the dry run and for a TE's tensor
parallelism.

A spec (``PSpec``) gives, for each dim of a leaf, the mesh axes that
split it: None, an axis name or a tuple of names, as a JAX
``PartitionSpec`` lists them. ``param_specs`` (train adds FSDP over
``data``), ``cache_specs``, ``batch_spec``, ``block_param_specs`` and
``prune_unsplittable`` are the reference's, matched on the same path
strings (``['blocks']['attn']['wq']``), so a test holds the two leaf by
leaf; ``shard_shape`` is one device's block under a spec.

A TE is the one-axis case: its ranks form the model axis of a 1 x tp
mesh, and its spec of a leaf is the dim that splits over them (``Spec``,
None for a replicated leaf): ``engine_param_specs`` and
``engine_cache_specs`` are ``model_dim`` of the pruned production rules
at that width, where

  * attention projections split their heads only when ``attn_shardable``
    (query AND KV heads divide tp: the pool splits by whole KV heads);
    otherwise attention and the pool replicate;
  * the FFN (dense or each expert's) splits ``d_ff`` / ``d_expert``; the
    embedding splits the vocab (else ``d_model``), the untied head the
    vocab; norms, routers and gates replicate;
  * ``prune_unsplittable`` replicates any split that does not divide.

A TE's weights are a list of rank trees, one per rank (one at tp 1). A
page run is a list of per-rank runs, and a slot TE's dense caches a list
of rank caches (``engine_cache_specs``: the sequence of the attention
layers' K/V, the rwkv state's heads and the RG-LRU width split; a
replicated leaf is one tensor on rank 0's device that every rank's cache
refers to, as the replicated pool is). ``shard`` turns a full tree into rank
trees; ``reshard`` moves the shards of one tensor to another mesh, joining
and re-splitting them when the layouts differ (P at tp 4 -> D at tp 2 joins
adjacent head shards pairwise): a cross-tp migration (DistFlow) and a fork
onto a sharded TE both use it."""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import EngineMesh

TP = 16   # the production mesh's model-axis width
Spec = Optional[int]
Axis = Union[None, str, Tuple[str, ...]]
PSpec = Tuple[Axis, ...]


def attn_shardable(cfg: ModelConfig, tp: int) -> bool:
    """Shard attention only when query AND KV heads both split evenly:
    the paged pool splits by whole KV heads (``sharding.py:33``)."""
    return cfg.tp_heads_ok(tp) and cfg.n_kv_heads % tp == 0


def walk(tree, fn: Callable[[str, Any], Any], path: str = ""):
    """``fn(path, leaf)`` over a weights tree, keeping its structure; the
    path is JAX's ``keystr`` of the leaf (``['a']['b']``, ``[0]``)."""
    if isinstance(tree, dict):
        return {k: walk(v, fn, f"{path}['{k}']") for k, v in tree.items()}
    if isinstance(tree, list):
        return [walk(v, fn, f"{path}[{i}]") for i, v in enumerate(tree)]
    return fn(path, tree)


def _zip_map(fn, specs, trees: List[Any]):
    """``fn(spec, [leaf of each tree])`` over trees of ``specs``'
    structure, the result shaped as they are."""
    if isinstance(specs, dict):
        return {k: _zip_map(fn, specs[k], [t[k] for t in trees])
                for k in specs}
    if isinstance(specs, list):
        return [_zip_map(fn, specs[i], [t[i] for t in trees])
                for i in range(len(specs))]
    return fn(specs, trees)


def param_specs(cfg: ModelConfig, params_like, mode: str,
                dp: Tuple[str, ...], tp: int = TP,
                heads_ok: Optional[bool] = None) -> Any:
    """The spec of every leaf of ``params_like`` (``sharding.py:43-127``):
    the ``model`` axis is tensor parallelism of width ``tp``; in
    ``mode="train"`` the weights are also FSDP-split over ``data`` on
    their ``d_model`` dim. ``dp``: the mesh's data-parallel axes (FSDP
    uses ``data`` alone). ``heads_ok`` overrides whether attention splits
    its heads (default ``cfg.tp_heads_ok(tp)``; the engine passes
    ``attn_shardable``)."""
    if heads_ok is None:
        heads_ok = cfg.tp_heads_ok(tp)
    fsdp = "data" if mode == "train" else None

    def spec_for(name: str, leaf) -> PSpec:
        dims: list = [None] * leaf.dim()

        def split(out_ax, in_ax):
            # the output dim (last) and the input dim (second last)
            dims[-1], dims[-2] = out_ax, in_ax
            return tuple(dims)

        if "embed" in name:
            if cfg.padded_vocab % tp == 0:
                dims[0] = "model"
                if fsdp and cfg.d_model % tp == 0:
                    dims[1] = fsdp
            else:
                dims[1] = "model"
            return tuple(dims)
        if "lm_head" in name:
            return split("model", fsdp)
        if any(k in name for k in ("['wq']", "['wk']", "['wv']")):
            return split("model" if heads_ok else None, fsdp)
        if "['wo']" in name:
            return split(fsdp, "model" if heads_ok else None)
        if any(k in name for k in ("['w_gate']", "['w_up']", "['cm_k']",
                                   "['wr']", "['wg']", "['cm_r']",
                                   "['w_in']", "['w_gate_in']")):
            return split("model", fsdp)  # ffn, rwkv projections, rglru width
        if any(k in name for k in ("['w_down']", "['cm_v']")) or \
                ("['w_out']" in name and "rec" in name):
            return split(fsdp, "model")
        if any(k in name for k in ("['wa']", "['wx']", "['conv_w']",
                                   "['conv_b']", "['lambda_p']")):
            dims[-1] = "model"
            return tuple(dims)
        return tuple(dims)  # norms, routers, loras, gates, bonus

    return walk(params_like, spec_for)


def cache_specs(cfg: ModelConfig, cache_like, shape: ShapeConfig,
                dp: Tuple[str, ...], tp: int = TP) -> Any:
    """The spec of every leaf of a dense cache (``sharding.py:130-158``):
    batches of 16 or more split over ``dp``; the attention layers' K/V
    sequence over ``model`` (over data x model at a smaller batch:
    context parallelism), the rwkv state's heads when they split, the
    RG-LRU width."""
    rows = dp if shape.global_batch >= 16 else None

    def spec_for(name: str, leaf) -> PSpec:
        if "length" in name:
            return (dp,) if rows else ()
        if "['k']" in name or "['v']" in name:
            return (None, dp, "model", None, None) if rows \
                else (None, None, ("data", "model"), None, None)
        if "cross_k" in name or "cross_v" in name:
            return (None, rows, None, None, None)
        if "['state']" in name:
            return (None, rows, "model" if cfg.tp_heads_ok(tp) else None,
                    None, None)
        if "last_tm" in name or "last_cm" in name:
            return (None, rows, None)
        if "['h']" in name:
            return (None, rows, "model")
        if "['conv']" in name:
            return (None, rows, None, "model")
        return ()

    return walk(cache_like, spec_for)


def batch_spec(shape: ShapeConfig, dp: Tuple[str, ...],
               ndim: int = 2) -> PSpec:
    """Token batches: the batch over the DP axes (``sharding.py:161``)."""
    if shape.global_batch < 16:
        return (None,) * ndim
    return (dp,) + (None,) * (ndim - 1)


def block_param_specs(cfg: ModelConfig, params_like, mode: str,
                      dp: Tuple[str, ...]) -> Dict[str, Any]:
    """Per-layer specs of the stacked towers, the layer dim stripped
    (``sharding.py:168``)."""
    full = param_specs(cfg, params_like, mode, dp)
    return {tower: walk(full[tower], lambda _, sp: sp[1:])
            for tower in ("blocks", "enc_blocks", "cross_blocks")
            if tower in full}


def _axes(entry: Axis) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _ways(entry: Axis, axis_sizes: Dict[str, int]) -> int:
    n = 1
    for a in _axes(entry):
        n *= axis_sizes[a]
    return n


def prune_unsplittable(spec_tree, arrays_like,
                       axis_sizes: Dict[str, int]) -> Any:
    """Replicate every entry whose axes do not divide their dim
    (``sharding.py:194``). ``axis_sizes``: the mesh's {axis: size}."""
    def prune(spec: PSpec, leaf) -> PSpec:
        dims = list(spec) + [None] * (leaf[0].dim() - len(spec))
        return tuple(None if ax is not None and
                     leaf[0].shape[i] % _ways(ax, axis_sizes) else ax
                     for i, ax in enumerate(dims))
    return _zip_map(prune, spec_tree, [arrays_like])


def shard_shape(shape, spec: PSpec, axis_sizes: Dict[str, int]) -> tuple:
    """One device's block of a leaf of ``shape`` under ``spec``: each dim
    cut by the product of its axes, rounded up (an uneven split is padded,
    as GSPMD pads it)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(-(-n // _ways(ax, axis_sizes))
                 for n, ax in zip(shape, dims))


def model_dim(spec: PSpec) -> Spec:
    """The dim a spec splits over ``model`` (None: no such dim)."""
    return next((i for i, ax in enumerate(spec) if "model" in _axes(ax)),
                None)


def _engine(specs, like, tp: int) -> Any:
    """The one-axis case: the ``model`` dims of ``specs`` pruned on a TE's
    1 x tp mesh."""
    pruned = prune_unsplittable(specs, like, {"data": 1, "model": tp})
    return _zip_map(lambda sp, _: model_dim(sp), pruned, [like])


def engine_param_specs(cfg: ModelConfig, params_like, tp: int) -> Any:
    """A TE's weight specs at width ``tp`` (``engine_param_shardings``,
    ``sharding.py:214``): ``param_specs`` in serve mode with
    ``attn_shardable``, pruned, as split dims."""
    return _engine(param_specs(cfg, params_like, "serve", ("data",), tp,
                               heads_ok=attn_shardable(cfg, tp)),
                   params_like, tp)


@functools.lru_cache(maxsize=None)
def te_param_specs(cfg: ModelConfig, tp: int) -> Any:
    """``engine_param_specs`` of ``cfg``'s own weights tree (its shapes,
    built on the meta device), once per (config, tp): what a TE, a fork
    and a warm upload shard by. Read-only."""
    from repro_torch.models.transformer import meta_params
    return engine_param_specs(cfg, meta_params(cfg), tp)


def engine_kv_pool_spec(cfg: ModelConfig, tp: int) -> Spec:
    """The paged pool (L, n_pages, page_size, Hkv, hd) splits whole KV
    heads (dim 3) when attention shards, else it replicates
    (``sharding.py:222``). At tp 1 the one rank holds every head."""
    return 3 if attn_shardable(cfg, tp) else None


def engine_kv_run_spec(cfg: ModelConfig, tp: int) -> Spec:
    """A migrated page run has the pool's rank, so the pool's spec applies
    verbatim (``sharding.py:230``)."""
    return engine_kv_pool_spec(cfg, tp)


def engine_cache_specs(cfg: ModelConfig, cache_like, tp: int) -> Any:
    """The split of every leaf of a slot TE's dense caches at width ``tp``
    (``engine_cache_shardings`` -> ``cache_specs`` at a slot batch,
    ``sharding.py:130-158,250-258``): the attention layers' ``k``/``v``
    (La, B, S, Hkv, hd) split the sequence, the reference's context
    parallelism inside a TE; the rwkv ``state`` (L, B, H, hd, hd) its
    heads when they split; the RG-LRU ``h`` (L, B, W) and ``conv`` (L, B,
    cw-1, W) the width; ``length``, ``last_tm``, ``last_cm`` and the cross
    cache replicate. ``prune_unsplittable`` applies. The reference splits
    16 or more slots over its data axis, of size 1 in a TE, so the model
    axis stands on these dims at any slot count."""
    rows = cache_like["length"].shape[0]
    shape = ShapeConfig("engine_slots", "decode", 0, rows)
    return _engine(cache_specs(cfg, cache_like, shape, ("data",), tp),
                   cache_like, tp)


def mesh_cache_specs(cfg: ModelConfig, cache_like, mesh: EngineMesh) -> Any:
    """``engine_cache_specs`` over ``mesh``'s ranks. A ``DeviceMesh`` (rank
    0 of a model axis, run alone) holds rank 0's part of the recurrent
    states (heads, width) at the axis's width and the attention K/V whole:
    the one-rank prefill builders place every position into it."""
    if mesh.ways == mesh.tp:
        return engine_cache_specs(cfg, cache_like, mesh.tp)
    specs = engine_cache_specs(cfg, cache_like, mesh.ways)
    return {k: None if k in ("k", "v") else d for k, d in specs.items()}


def engine_decode_state_device(mesh: EngineMesh) -> torch.device:
    """Where the decode hot loop's carried state lives
    (``engine_decode_state_sharding``, ``sharding.py:240``): the reference
    replicates these O(batch) vectors over the mesh; the port keeps them
    once, on rank 0's device, where sampling runs on the gathered
    logits, and each rank reads what it needs through ``broadcast``."""
    return mesh.device


# ---------------------------------------------------------------- placement
def place(t: torch.Tensor, dev: torch.device, *,
          copy: bool) -> torch.Tensor:
    """``t`` on ``dev``: itself when it already lies there and ``copy`` is
    False, else new contiguous storage (filled non-blocking)."""
    if t.device == dev and not copy:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, device=dev)
    out.copy_(t, non_blocking=True)
    return out


def split(t: torch.Tensor, dim: Spec, mesh: EngineMesh, *,
          copy: bool) -> List[torch.Tensor]:
    """One tensor as the mesh's ranks hold it: rank r's r-th slice of
    ``mesh.tp`` on ``dim``, or (``dim=None``) the whole tensor, once per
    distinct device and shared by the ranks there. ``copy=False`` keeps a
    slice that already lies on its rank's device as a view of ``t``;
    ``copy=True`` puts everything in new storage."""
    if dim is None:
        per_dev = {d: place(t, d, copy=copy) for d in mesh.distinct}
        return [per_dev[d] for d in mesh.devices]
    if t.shape[dim] % mesh.tp:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over tp={mesh.tp}")
    n = t.shape[dim] // mesh.tp
    return [place(t.narrow(dim, r * n, n), dev, copy=copy)
            for r, dev in enumerate(mesh.devices)]


def rank_zeros(shape, dtype: torch.dtype, dim: Spec,
               mesh: EngineMesh) -> List[torch.Tensor]:
    """A zeroed leaf of ``shape`` as the mesh's ranks hold it: rank r's
    slice on ``dim`` in storage of its own on its device, or (``dim=None``)
    one tensor on rank 0's device that every rank refers to."""
    if dim is None:
        return [torch.zeros(shape, dtype=dtype, device=mesh.device)] * mesh.tp
    part = list(shape)
    part[dim] //= mesh.ways
    return [torch.zeros(part, dtype=dtype, device=d) for d in mesh.devices]


def held(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """The entries of a rank list that hold distinct parts of one leaf:
    every rank's when the leaf splits (each part its own storage), rank
    0's alone when the ranks refer to one tensor (a replicated leaf)."""
    return parts[:1] if parts[-1].data_ptr() == parts[0].data_ptr() \
        else list(parts)


def shard(tree, specs, mesh: EngineMesh) -> List[Any]:
    """A full weights tree as ``mesh.tp`` rank trees of its structure. A
    slice already on its rank's device is a view of the given tensor (the
    TEs of a fleet share one weights tree and every TE's shards stay views
    of it on one card); elsewhere it is copied there."""
    parts = _zip_map(lambda s, ts: split(ts[0], s, mesh, copy=False),
                     specs, [tree])
    return [_zip_map(lambda _, p: p[0][r], specs, [parts])
            for r in range(mesh.tp)]


def reshard(shards: List[torch.Tensor], src_dim: Spec, dst_dim: Spec,
            dst: EngineMesh, *, copy: bool) -> List[torch.Tensor]:
    """The shards of one tensor (split on ``src_dim``, or one tensor the
    ranks share when None) as ``dst``'s ranks hold it on ``dst_dim``. At
    one layout (same split, same width) each shard goes to its rank's
    device; otherwise the shards are joined on ``src_dim`` (into new
    storage) and split again, each rank's slice a view of the join on its
    device. ``copy`` as in ``split``: True for a fork (every shard in new
    storage), False for a page run in flight (a run already on its
    destination device stays as it is)."""
    if src_dim == dst_dim and len(shards) == dst.tp and src_dim is not None:
        return [place(s, d, copy=copy) for s, d in zip(shards, dst.devices)]
    if src_dim is None:
        return split(shards[0], dst_dim, dst, copy=copy)
    dev = shards[0].device
    # the join is new storage already: its slices need no second copy
    whole = torch.cat([s if s.device == dev else
                       s.to(dev, non_blocking=True) for s in shards],
                      src_dim)
    return split(whole, dst_dim, dst, copy=False)


def reshard_tree(rank_trees: List[Any], src_specs, dst_specs,
                 dst: EngineMesh) -> List[Any]:
    """Every leaf of a sharded weights tree (``src_specs``) resharded onto
    ``dst`` (``dst_specs``) in new storage: a fork."""
    moved = _zip_map(
        lambda d, ls: reshard(ls[1:], ls[0], d, dst, copy=True),
        dst_specs, [src_specs, *rank_trees])
    return [_zip_map(lambda _, m: m[0][r], dst_specs, [moved])
            for r in range(dst.tp)]


def run_dim(cfg: ModelConfig, runs: List[torch.Tensor]) -> Spec:
    """The split of a page run (L, NP_run, P, Hkv, hd) read off its
    shape: on its KV heads when a rank's run holds fewer than all of
    them, else none (one rank, or a replicated pool)."""
    return 3 if runs[0].shape[3] < cfg.n_kv_heads else None
