"""Tree paths: the '/'-joined path of every leaf of a nested tree, and a
map over the leaves that keeps the tree's structure.

A tree is nested dicts, lists, tuples and NamedTuples; None is an empty
subtree and anything else is a leaf. A path joins the dict keys, list
indices and NamedTuple field names from the root, as the reference's
checkpoints and optimizer state name their leaves.
"""
from __future__ import annotations

from typing import Any


def tree_paths(tree: Any, prefix: str = "", *,
               sort_keys: bool = False) -> list[tuple[str, Any]]:
    """[(path, leaf)] of `tree` in depth-first order; dict keys in
    insertion order, or sorted with `sort_keys` (the order of the
    reference's tree flattening)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        keys = sorted(tree) if sort_keys else list(tree)
        items = [(str(k), tree[k]) for k in keys]
    elif hasattr(tree, "_fields"):                        # a NamedTuple
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [pair for k, v in items
            for pair in tree_paths(v, f"{prefix}/{k}" if prefix else k, sort_keys=sort_keys)]


def tree_map_with_path(fn, tree: Any, prefix: str = "") -> Any:
    """`tree` with each leaf replaced by fn(path, leaf); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f),
                                               f"{prefix}/{f}" if prefix else f)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


__all__ = ["tree_map_with_path", "tree_paths"]
