"""Minimal pytrees for the port: nested dicts, lists and tuples of tensors.

Dicts flatten in SORTED key order, as ``jax.tree_util`` does, so a leaf's
position in the packed buffer (and hence its bits on the wire) is the
same in both packages.  ``None`` is an empty subtree, as in JAX.
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

        def build(spec):
            kind = spec[0]
            if kind == "leaf":
                return next(it)
            if kind == "none":
                return None
            if kind == "dict":
                return {k: build(s) for k, s in spec[1]}
            return spec[2]([build(s) for s in spec[1]])

        out = build(self._spec)
        if next(it, None) is not None:
            raise ValueError("too many leaves for this tree structure")
        return out


def flatten(tree) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            return ("dict", tuple((k, walk(t[k])) for k in sorted(t)))
        if type(t) in (list, tuple):
            return ("seq", tuple(walk(x) for x in t), type(t))
        if t is None:
            return ("none",)
        leaves.append(t)
        return ("leaf",)

    return leaves, TreeDef(walk(tree))


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
