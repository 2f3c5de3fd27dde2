"""Flattening of nested values into their tensors and back.

The JAX package registers its objects as PyTrees and lets ``jax.tree_util``
walk them.  The port walks the same shapes itself: tuples, lists, dicts
and dataclasses (the geometry objects) are containers, every tensor is a
leaf, and anything else (numbers, strings, NumPy keys, callables) is kept
as static data of the structure.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def tree_flatten(tree) -> tuple[list, Any]:
    """``(tensors, spec)``: the tensors of ``tree`` in a fixed order and the
    structure that :func:`tree_unflatten` rebuilds ``tree`` from."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _flatten(tree, leaves: list):
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("leaf",)
    if isinstance(tree, (tuple, list)):
        return (type(tree), [_flatten(v, leaves) for v in tree])
    if isinstance(tree, dict):
        return (dict, [(k, _flatten(v, leaves)) for k, v in tree.items()])
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fields = [(f.name, _flatten(getattr(tree, f.name), leaves))
                  for f in dataclasses.fields(tree)]
        return ("dataclass", type(tree), fields)
    return ("static", tree)


def tree_unflatten(spec, leaves) -> Any:
    """Inverse of :func:`tree_flatten`, with ``leaves`` in place of the
    tensors."""
    it = iter(leaves)
    out = _unflatten(spec, it)
    rest = list(it)
    if rest:
        msg = f"{len(rest)} leaves left over"
        raise ValueError(msg)
    return out


def _unflatten(spec, it):
    tag = spec[0]
    if tag == "leaf":
        return next(it)
    if tag == "static":
        return spec[1]
    if tag == "dataclass":
        return spec[1](**{name: _unflatten(s, it) for name, s in spec[2]})
    if tag is dict:
        return {k: _unflatten(s, it) for k, s in spec[1]}
    return tag(_unflatten(s, it) for s in spec[1])


def tree_map(fn: Callable, *trees) -> Any:
    """``fn`` applied to the tensors at the same places of ``trees`` (which
    share one structure), in a tree of the first one's structure."""
    flat = [tree_flatten(t) for t in trees]
    spec = flat[0][1]
    return tree_unflatten(spec, [fn(*xs) for xs in zip(*(leaves for leaves, _ in flat))])
