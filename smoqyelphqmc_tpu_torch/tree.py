"""A tree map over the nested dicts, lists and tuples the measurement pass
and the checkpoint carry (the port's stand-in for jax.tree_util.tree_map)."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """fn applied to every leaf of `tree` (and the matching leaves of `rest`,
    trees of the same structure); dict, list and tuple nodes are rebuilt and
    None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)
