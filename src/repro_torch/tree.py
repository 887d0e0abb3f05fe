"""Nested dicts of tensors as trees, in the reference's leaf order.

A JAX pytree of dicts flattens in sorted-key order, and
``jax.tree_util.keystr`` names a leaf by its key path
(``['params']['layers']['wq']``, ``['layers'][0]['w']`` under a list).
The optimizers, the train step and the checkpoint walk trees the same
way, so a leaf keeps its name and its place on both sides. Dicts and
lists are nodes (a list's entries in order, as jax flattens them);
anything else, a tuple too, is a leaf."""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map", "tree_leaves", "tree_leaves_with_path", "tree_unflatten"]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same places of
    ``rest``, whose structure is read only down to ``tree``'s leaves, as
    ``treedef.flatten_up_to`` does) → a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(keystr path, leaf)] in flatten order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves_with_path(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, list):
        out = []
        for i, t in enumerate(tree):
            out += tree_leaves_with_path(t, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(template, leaves) -> Any:
    """``leaves`` (in flatten order) placed into ``template``'s structure."""
    leaves = list(leaves)
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if len(tree_leaves(out)) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a template of {len(tree_leaves(out))}")
    return out
