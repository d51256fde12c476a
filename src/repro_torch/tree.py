"""Nested dicts and lists of tensors (the port's parameter, state and
optimizer trees), walked in the reference's order: dict keys sorted,
as ``jax.tree.leaves`` walks them."""
from __future__ import annotations

from typing import Any, Callable, Iterable, List


def tree_map(fn: Callable, *trees) -> Any:
    """``fn`` over the leaves of trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in sorted(t0)}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *z) for z in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves: Iterable) -> Any:
    """A tree shaped like ``like`` whose leaves are ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
