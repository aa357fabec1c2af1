"""Flattening of the port's weights and optimizer trees (nested dicts and
lists, tensors at the leaves) in JAX's order: dict keys sorted, list items
in turn, each leaf named by its ``jax.tree_util.keystr`` path
(``['blocks']['wq']``, ``[0]``). The order matters where it is written
down or summed: a checkpoint's leaf numbering and shards, and the global
gradient norm's sum over leaves, match the reference's only in its
order."""
from __future__ import annotations

from typing import Any, Iterable, List, Tuple


def flatten_with_paths(tree, path: str = "") -> List[Tuple[str, Any]]:
    """[(keystr path, leaf)] in JAX's leaf order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_paths(tree[k], f"{path}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten_with_paths(v, f"{path}[{i}]")]
    return [(path, tree)]


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, new_leaves: Iterable) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves``, given in
    ``leaves(like)``'s order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}     # keep like's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
