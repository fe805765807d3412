"""Nested parameter trees: dicts and lists of tensors (a ``QTensor`` is one
leaf).  The port's stand-in for ``jax.tree``; leaves come in the trees'
own order."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn(leaf, *leaves)`` over the leaves of ``tree`` and the same
    leaves of each of ``rest``, in a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in the order :func:`tree_map` visits them."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves) -> object:
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
