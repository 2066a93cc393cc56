"""Nested-dict trees of tensors (the port's stand-in for JAX pytrees of adapter
leaves). Leaves are visited in sorted-key order, so two trees of the same
structure flatten to matching lists (a frozen copy of
fairdiff_torch/utils/tree.py)."""

from __future__ import annotations

from typing import Any, Callable, Mapping


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_unflatten(tree: Any, leaves: list) -> Any:
    """A tree shaped like `tree` holding `leaves` in `tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
