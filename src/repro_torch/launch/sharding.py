"""Sharding rules of a TE's tensor parallelism (the port's own copy of the
``mode="serve"`` half of ``repro/launch/sharding.py``).

A spec here gives, for each leaf of a weights tree, the dimension that
splits over the mesh's ranks, or ``None`` for a replicated leaf: where the
reference writes ``P(None, "model")`` the port writes ``1``. The rules are
the reference's, matched on the same path strings (``['blocks']['attn']
['wq']``), so a test can hold the two leaf by leaf:

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
from typing import Any, Callable, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import EngineMesh

Spec = Optional[int]


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


def param_specs(cfg: ModelConfig, params_like, tp: int,
                heads_ok: bool) -> Any:
    """The split dimension of every leaf of ``params_like`` at width
    ``tp``: ``param_specs(..., mode="serve")`` of ``sharding.py:43-127``
    (no FSDP). ``heads_ok`` says whether attention splits its heads (the
    engine passes ``attn_shardable``)."""
    def spec_for(name: str, leaf) -> Spec:
        last, second_last = leaf.dim() - 1, leaf.dim() - 2
        if "embed" in name:
            return 0 if cfg.padded_vocab % tp == 0 else 1
        if "lm_head" in name:
            return last
        if any(k in name for k in ("['wq']", "['wk']", "['wv']")):
            return last if heads_ok else None
        if "['wo']" in name:
            return second_last if heads_ok else None
        if any(k in name for k in ("['w_gate']", "['w_up']", "['cm_k']")):
            return last
        if any(k in name for k in ("['w_down']", "['cm_v']")):
            return second_last
        if any(k in name for k in ("['wr']", "['wg']", "['cm_r']")):
            return last
        if any(k in name for k in ("['w_in']", "['w_gate_in']")):
            return last
        if "['w_out']" in name and "rec" in name:
            return second_last
        if any(k in name for k in ("['wa']", "['wx']")):
            return last
        if any(k in name for k in ("['conv_w']", "['conv_b']",
                                   "['lambda_p']")):
            return last
        return None     # norms, routers, loras, gates, bonus

    return walk(params_like, spec_for)


def prune_unsplittable(specs, params_like, tp: int) -> Any:
    """Replicate every split whose dimension ``tp`` does not divide
    (``sharding.py:194``)."""
    def prune(spec: Spec, leaf) -> Spec:
        return None if spec is None or leaf[0].shape[spec] % tp else spec
    return _zip_map(prune, specs, [params_like])


def engine_param_specs(cfg: ModelConfig, params_like, tp: int) -> Any:
    """A TE's weight specs at width ``tp`` (``engine_param_shardings``,
    ``sharding.py:214``)."""
    specs = param_specs(cfg, params_like, tp,
                        heads_ok=attn_shardable(cfg, tp))
    return prune_unsplittable(specs, params_like, tp)


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
    def spec_for(name: str, leaf) -> Spec:
        if name in ("['k']", "['v']"):
            return 2
        if name == "['state']":
            return 2 if cfg.tp_heads_ok(tp) else None
        if name == "['h']":
            return 2
        if name == "['conv']":
            return 3
        return None     # length, last_tm, last_cm, cross_k, cross_v

    return prune_unsplittable(walk(cache_like, spec_for), cache_like, tp)


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
    part[dim] //= mesh.tp
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
