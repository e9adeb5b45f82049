"""Paths and maps over the port's state trees.

A state tree is nested NamedTuples, dicts (string keys) and lists or
tuples, with tensors, Python numbers or None at the leaves: an
``SvaeTrainState``, ``AdamState``, ``GmmNat``, the mixtures' train states,
a metrics dict. A leaf's path joins the field names, keys and indices on
the way to it with dots (``nn_params.encoder.0.w``, ``pgm_nat.niw_nat.eta3``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def _children(tree) -> list | None:
    """(key, child) pairs of a node, or None for a leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """Every (path, leaf) of ``tree`` in a fixed order (fields, keys and
    indices as they stand)."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += flatten(child, f"{prefix}.{key}" if prefix else str(key))
    return out


def _rebuild(tree, leaves: Iterator):
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    values = [_rebuild(child, leaves) for _, child in kids]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*values)
    if isinstance(tree, dict):
        return {key: v for (key, _), v in zip(kids, values)}
    return type(tree)(values)


def unflatten(template, leaves) -> Any:
    """``template``'s structure with its leaves replaced, in ``flatten``'s
    order, by ``leaves``."""
    return _rebuild(template, iter(leaves))


def map_leaves(fn: Callable, tree) -> Any:
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    return unflatten(tree, [fn(leaf) for _, leaf in flatten(tree)])
