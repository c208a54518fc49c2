"""Nested dict / list parameter trees: map and flatten.

Leaves are visited in the order ``jax.tree.leaves`` visits the
reference's trees (dict keys sorted, lists in order), so sums over
leaves add in the same order on both sides.
"""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    """Leaves of ``tree``, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped as ``tree`` holding ``leaves`` (given in
    :func:`tree_leaves` order) at its leaves."""
    return _unflatten(tree, iter(leaves))


def _unflatten(t, it):
    # module level, not a closure: a recursive closure is a reference
    # cycle, and its cell would keep the leaves alive until the cycle
    # collector runs (a step's shared gradients, into the next step)
    if isinstance(t, dict):
        out = {k: _unflatten(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_unflatten(x, it) for x in t)
    return next(it)


def tree_paths(tree, prefix=()):
    """Key paths of the leaves of ``tree`` (tuples of dict keys and list
    indices), in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k],
                                                            prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in tree_paths(t, prefix + (i,))]
    return [prefix]
