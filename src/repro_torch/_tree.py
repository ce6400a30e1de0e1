"""Nested dicts (and lists) of tensors as the port's pytrees: the
reference's ``jax.tree`` functions over parameter, gradient and
optimizer-state trees, with JAX's leaf order (dict keys sorted, lists in
order) and the checkpoints' leaf names (the keys and list indices on the
way to a leaf joined by ``/``). A tuple is a leaf."""
from __future__ import annotations

from typing import Any


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists; the first tree's
    structure decides what a leaf is (the others may hold dicts at its
    leaves, as ``jax.tree.map`` with ``is_leaf`` does)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in tree_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [item for i, v in enumerate(tree) for item in tree_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unzip(tree, n: int) -> tuple:
    """A tree of n-tuples -> n trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))
