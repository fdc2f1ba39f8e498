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
    """Leaves in ``jax.tree_util.tree_leaves`` order: dict keys sorted,
    tuples, lists and NamedTuples in order, None and empty nodes holding
    no leaf. Checkpoint files index leaves in this order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    if tree is None:
        return []
    return [tree]


def tree_structure(tree):
    """A comparable description of ``tree``'s nodes without its leaves
    (the ``jax.tree.structure`` of the nest): node types, dict keys and
    child counts; two nests with equal structures map together."""
    if isinstance(tree, dict):
        return (dict, tuple((k, tree_structure(tree[k]))
                            for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(tree_structure(t) for t in tree))
    return None if tree is None else "*"


def tree_unflatten(like, leaves):
    """Rebuild ``like``'s structure from ``leaves`` given in
    ``tree_leaves`` order (dict insertion order is kept)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            kids = {k: build(node[k]) for k in sorted(node)}
            return {k: kids[k] for k in node}
        if isinstance(node, (tuple, list)):
            kids = [build(t) for t in node]
            return (type(node)(*kids) if _is_namedtuple(node)
                    else type(node)(kids))
        if node is None:
            return None
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out
