"""Nested containers of tensors in the JAX package's flatten order.

A tree is a dict (entries in sorted key order, as ``jax.tree`` flattens
them), a list or tuple, a :class:`Node` dataclass (its fields in
declaration order), ``None`` (no leaves) or a leaf.  Leaf paths are the
strings the JAX checkpoint manager writes: dict keys, and the child's index
under a list, tuple or node (``"0/embed"`` is ``TrainState.params["embed"]``),
so leaf order and checkpoint layout match across the packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


class Node:
    """Base of the dataclasses that are tree nodes (``TrainState``,
    ``AdamWState``, ...): their fields, in order, are the children."""

    def children(self) -> tuple:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if isinstance(tree, Node):
        return [(str(i), v) for i, v in enumerate(tree.children())]
    raise TypeError(type(tree))


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, list, tuple, Node)) and tree is not None


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in flatten order."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(leaves_with_paths(child, f"{prefix}/{key}" if prefix
                                     else key))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def map_tree(fn: Callable, tree, *rest):
    """``fn`` applied leafwise over trees of one structure."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    kids = [map_tree(fn, c, *(r.children()[i] for r in rest))
            for i, c in enumerate(tree.children())]
    return type(tree)(*kids)


def unflatten_like(template, values: list):
    """A tree of ``template``'s structure with ``values`` as its leaves, in
    flatten order."""
    it = iter(values)
    out = map_tree(lambda _: next(it), _ordered(template))
    return out


def _ordered(tree):
    """``tree`` with its dicts rebuilt in sorted key order, so that
    :func:`map_tree` visits leaves in flatten order."""
    if isinstance(tree, dict):
        return {k: _ordered(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_ordered(v) for v in tree)
    if isinstance(tree, Node):
        return type(tree)(*(_ordered(c) for c in tree.children()))
    return tree
