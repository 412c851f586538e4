"""Parameter-tree helpers in the JAX package's flatten order.

A tree is nested dicts, lists, tuples and NamedTuples of tensors. Leaves
come out in the order ``jax.tree_util`` flattens the same structure: dict
keys sorted, lists and tuples by index, a NamedTuple's fields in their
declared order; ``None`` holds no leaf. A leaf's path is the list of its
keys, indices and field names, as ``jax.tree_util.tree_flatten_with_path``
gives them, so a checkpoint written by either package names its leaves
alike.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves_with_path(tree, is_leaf: Optional[Callable] = None
                     ) -> List[Tuple[list, Any]]:
    """[(path, leaf)] in the JAX flatten order; a node for which
    ``is_leaf`` holds is a leaf, as in ``jax.tree_util``."""
    out: List[Tuple[list, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if is_leaf is not None and is_leaf(node):
            out.append((path, node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [k])
        elif _is_namedtuple(node):
            for f in node._fields:
                walk(getattr(node, f), path + [f])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [i])
        else:
            out.append((path, node))
    walk(tree, [])
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree with the structure of ``like`` holding ``new_leaves`` (in the
    flatten order)."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}      # keep like's key order
        if _is_namedtuple(node):
            return type(node)(*[build(getattr(node, f))
                                for f in node._fields])
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree) -> Any:
    """``fn`` over the leaves of ``tree``, in a tree of its structure."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])
