"""Minimal pytrees for the port: nested dicts, lists and tuples of tensors.

Dicts flatten in SORTED key order, as ``jax.tree_util`` does, so a leaf's
position in the packed buffer (and hence its bits on the wire) is the
same in both packages.  ``None`` is an empty subtree, as in JAX.

The recursive walks are module functions that take their accumulator as
an argument: a nested function that calls itself is a reference cycle,
and one that holds the leaves would keep a model's worth of tensors
alive until Python's cyclic collector happens to run.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


class TreeDef:
    """Structure of a flattened tree; :meth:`unflatten` rebuilds it."""

    def __init__(self, spec):
        self._spec = spec

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and self._spec == other._spec

    def __repr__(self) -> str:
        return f"TreeDef({self._spec!r})"

    def unflatten(self, leaves) -> Any:
        it = iter(leaves)
        out = _build(self._spec, it)
        if next(it, None) is not None:
            raise ValueError("too many leaves for this tree structure")
        return out


def _build(spec, it) -> Any:
    kind = spec[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(s, it) for k, s in spec[1]}
    return spec[2]([_build(s, it) for s in spec[1]])


def _walk(t, leaves: List[Any]):
    if isinstance(t, dict):
        return ("dict", tuple((k, _walk(t[k], leaves)) for k in sorted(t)))
    if type(t) in (list, tuple):
        return ("seq", tuple(_walk(x, leaves) for x in t), type(t))
    if t is None:
        return ("none",)
    leaves.append(t)
    return ("leaf",)


def flatten(tree) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []
    return leaves, TreeDef(_walk(tree, leaves))


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    ls, td = flatten(tree)
    others = []
    for r in rest:
        lr, tr = flatten(r)
        if tr != td:
            raise ValueError(f"tree structures differ: {td} vs {tr}")
        others.append(lr)
    return td.unflatten([fn(*xs) for xs in zip(ls, *others)])
