"""Minimal pytree helpers for the port's streaming state.

State is a nest of dicts, tuples, lists and NamedTuples (``PC``) with tensor
or array leaves, the same structure the JAX package carries as a pytree.
"""

from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest, node_map=None):
    """Apply ``fn`` to every leaf of ``tree`` (and matching leaves of
    ``rest``). ``node_map(node, children)`` may rebuild a NamedTuple node
    as another type; by default its own type is kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            node_map=node_map) for k in tree}
    if isinstance(tree, (tuple, list)):
        kids = [tree_map(fn, t, *(r[i] for r in rest), node_map=node_map)
                for i, t in enumerate(tree)]
        if _is_namedtuple(tree):
            return (node_map(tree, kids) if node_map is not None
                    else type(tree)(*kids))
        return type(tree)(kids)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out
