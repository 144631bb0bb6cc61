"""Parameter metadata: shapes, init and dtype in one declarative record.

Counterpart of ``repro/models/params.py``.  Model builders return trees
whose leaves are :class:`P`; :func:`materialize` turns such a tree into
tensors.  :func:`pspecs` reads the logical axis names with a rule set
(``sharding.param_rules``) into each leaf's :class:`Spec`, JAX's
``PartitionSpec`` as a plain tuple; :func:`shard` cuts a whole leaf to
this rank's contiguous chunk (GSPMD's layout) and :func:`unshard`
gathers it back over the model axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import tree as T

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class P:
    """Declarative parameter: shape + logical axis names + init recipe."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]        # logical name per dim (or None)
    init: str = "normal"                   # normal | zeros | ones | scaled
    fan_in: Optional[int] = None           # for init="scaled": 1/sqrt(fan_in)
    dtype: Optional[str] = None            # override model dtype (norms=f32)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    def with_prefix(self, n: int, axis_name: str = "layers") -> "P":
        """Stack this param n times along a new leading axis."""
        return dataclasses.replace(
            self, shape=(n,) + self.shape, axes=(axis_name,) + self.axes)


def stack_tree(tree, n: int):
    """Add a leading ``layers`` axis of size n to every P in the tree."""
    return T.tree_map(lambda p: p.with_prefix(n), tree)


def leaf_dtype(p: P, default_dtype: str) -> torch.dtype:
    return DTYPES[p.dtype or default_dtype]


def _init_one(p: P, gen: torch.Generator, default_dtype: str,
              device: torch.device) -> torch.Tensor:
    dtype = leaf_dtype(p, default_dtype)
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "scaled":
        fan_in = p.fan_in or (p.shape[-2] if len(p.shape) >= 2
                              else p.shape[-1])
        std = 1.0 / math.sqrt(max(1, fan_in))
    else:
        std = 0.02
    # drawn in float32, scaled in place (one float32 copy of the leaf at a
    # time, the same bits as ``x * std``), then cast, as the JAX package
    # does
    x = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)


def materialize(tree, seed: int, default_dtype: str = "float32",
                device=torch.device("cpu")):
    """Tensors for a tree of :class:`P`, drawn in leaf order from one
    ``torch.Generator`` on ``device`` seeded with ``seed`` (not the JAX
    package's numbers: tests carry those across)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return T.tree_map(lambda p: _init_one(p, gen, default_dtype, device),
                      tree)


def count_params(tree) -> int:
    return sum(int(math.prod(p.shape)) if p.shape else 1
               for p in T.leaves(tree))


# ---------------------------------------------------------------------------
# Partition specs
# ---------------------------------------------------------------------------


class Spec(tuple):
    """A leaf's partition spec: per dim, a mesh axis name, a tuple of
    names, or ``None`` (replicated), as ``tuple(PartitionSpec)`` reads in
    the JAX package.  A tuple subclass, so that a tree of specs keeps the
    params' structure (``repro_torch.tree`` walks plain tuples only)."""

    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec names, in dim order."""
        out = []
        for e in self:
            if e is not None:
                out.extend((e,) if isinstance(e, str) else e)
        return tuple(out)


def _mesh_sizes(mesh) -> Dict[str, int]:
    if mesh is None:
        return {}
    return dict(mesh if isinstance(mesh, dict) else mesh.shape)


def pspecs(tree, rules: dict, mesh=None):
    """Each :class:`P` of ``tree`` mapped to its :class:`Spec` by
    ``rules`` (logical axis -> mesh axis, tuple of axes, or None; an
    unlisted axis is replicated), with JAX's two rules: a mesh axis
    appears at most once in a spec (a later dim that resolves to a used
    axis stays replicated), and, given ``mesh`` (a ``ClientMesh`` or a
    shape dict), a dim whose size the axes' product does not divide stays
    replicated (GQA's kv_heads on a wide model axis; an axis the mesh
    lacks counts as 1)."""
    sizes = _mesh_sizes(mesh)

    def spec_of(p: P) -> Spec:
        used, entries = set(), []
        for dim, name in zip(p.shape, p.axes):
            mesh_axes = rules.get(name) if name else None
            if mesh_axes is None:
                entries.append(None)
                continue
            if isinstance(mesh_axes, str):
                mesh_axes = (mesh_axes,)
            free = tuple(a for a in mesh_axes if a not in used)
            if not free or (sizes and dim % math.prod(sizes.get(a, 1)
                                                      for a in free)):
                entries.append(None)
                continue
            used.update(free)
            entries.append(free[0] if len(free) == 1 else free)
        return Spec(entries)

    return T.tree_map(spec_of, tree)


def _coords(mesh) -> Dict[str, int]:
    """This rank's index along every mesh axis (row-major device order)."""
    out, r = {}, mesh.rank
    for a, n in reversed(list(mesh.shape.items())):
        out[a], r = r % n, r // n
    return out


def model_split(specs) -> Tuple[bool, ...]:
    """Per leaf of a spec tree (flatten order), whether the model axis
    splits it."""
    from repro_torch.launch.mesh import MODEL_AXIS
    return tuple(MODEL_AXIS in s.axes() for s in T.leaves(specs))


def shard(tree, specs, mesh):
    """This rank's contiguous chunk of every whole leaf of ``tree`` along
    each dim its :class:`Spec` names (a tuple entry row-major over its
    axes), as GSPMD lays out a ``PartitionSpec``; replicated dims whole."""
    coords = _coords(mesh)

    def one(x, spec):
        for dim, e in enumerate(spec):
            if e is None:
                continue
            axes = (e,) if isinstance(e, str) else tuple(e)
            n_ax, idx = 1, 0
            for a in axes:
                n_ax, idx = n_ax * mesh.shape[a], idx * mesh.shape[a] \
                    + coords[a]
            size = x.shape[dim] // n_ax
            x = x.narrow(dim, idx * size, size)
        return x.contiguous()

    return T.tree_map(one, tree, specs)


def unshard(tree, specs, mesh):
    """The inverse of :func:`shard` over the model axis: every leaf
    all-gathered along its model dim (every rank of the model group must
    call it).  For tests, checkpoints and ``chip_smoke.py``."""
    from repro_torch.launch.mesh import FSDP_ITEM, MODEL_AXIS
    group = mesh.model

    def one(x, spec):
        for dim, e in enumerate(spec):
            if e is None:
                continue
            if e != MODEL_AXIS:
                raise NotImplementedError(
                    f"unshard over {e!r}: the FSDP sharding of the leaves "
                    f"is not ported yet: {FSDP_ITEM}")
            if group is not None:
                x = group.all_gather(x, dim)
        return x

    return T.tree_map(one, tree, specs)
