"""Parameter metadata: shapes, init and dtype in one declarative record.

Counterpart of ``repro/models/params.py``.  Model builders return trees
whose leaves are :class:`P`; :func:`materialize` turns such a tree into
tensors.  :func:`pspecs` reads the logical axis names with a rule set
(``sharding.param_rules``) into each leaf's :class:`Spec`, JAX's
``PartitionSpec`` as a plain tuple; :func:`shard` cuts a whole leaf to
this rank's contiguous chunk (GSPMD's layout), :func:`materialize_shards`
draws :func:`materialize`'s numbers one whole leaf at a time and keeps
only this rank's chunks, and :func:`unshard` gathers them back over the
model and FSDP axes.  :func:`split_kinds` says per leaf which axes split
it.
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


def _entry_axes(e) -> Tuple[str, ...]:
    return (e,) if isinstance(e, str) else tuple(e)


def split_kinds(specs, mesh) -> Tuple[Optional[str], ...]:
    """Per leaf of a spec tree (flatten order), which axes of ``mesh`` (a
    ``ClientMesh`` or a shape dict) above 1 split it: ``None`` (whole),
    ``"model"``, ``"data"`` (the FSDP axes, data[, pod]) or ``"both"``."""
    from repro_torch.launch.mesh import MODEL_AXIS
    sizes = _mesh_sizes(mesh)
    out = []
    for s in T.leaves(specs):
        axes = [a for a in s.axes() if sizes.get(a, 1) > 1]
        model = MODEL_AXIS in axes
        data = any(a != MODEL_AXIS for a in axes)
        out.append("both" if model and data else "model" if model
                   else "data" if data else None)
    return tuple(out)


def model_split(specs) -> Tuple[bool, ...]:
    """Per leaf of a spec tree (flatten order), whether the model axis
    splits it."""
    from repro_torch.launch.mesh import MODEL_AXIS
    return tuple(MODEL_AXIS in s.axes() for s in T.leaves(specs))


def _block(spec, leaf_shape, shape: Dict[str, int],
           coords: Dict[str, int]) -> Tuple[slice, ...]:
    out = []
    for dim, e in enumerate(spec):
        n_ax, idx = 1, 0
        for a in (() if e is None else _entry_axes(e)):
            n = shape.get(a, 1)
            n_ax, idx = n_ax * n, idx * n + coords.get(a, 0)
        size = leaf_shape[dim] // n_ax
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def shard_block(spec, leaf_shape, mesh) -> Tuple[slice, ...]:
    """The slices of a whole leaf of ``leaf_shape`` that ``mesh.rank``
    holds under ``spec`` (:func:`shard`'s layout)."""
    return _block(spec, leaf_shape, mesh.shape, _coords(mesh))


def _shard_leaf(x, spec, shape: Dict[str, int], coords: Dict[str, int]):
    return x[_block(spec, x.shape, shape, coords)].contiguous()


def shard(tree, specs, mesh):
    """This rank's contiguous chunk of every whole leaf of ``tree`` along
    each dim its :class:`Spec` names (a tuple entry row-major over its
    axes: ``("data", "pod")`` is ``data * pod_size + pod``), as GSPMD lays
    out a ``PartitionSpec``; replicated dims whole."""
    coords = _coords(mesh)
    return T.tree_map(lambda x, sp: _shard_leaf(x, sp, mesh.shape, coords),
                      tree, specs)


def materialize_shards(tree, specs, mesh, seed: int,
                       default_dtype: str = "float32",
                       device=torch.device("cpu")):
    """``shard(materialize(tree, seed, ...), specs, mesh)`` without the
    whole tree: each leaf is drawn whole on ``device`` in leaf order from
    the one generator (the same numbers), cut to this rank's chunk, and
    freed before the next, so a rank holds its shards and one whole
    leaf."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    coords = _coords(mesh)
    return T.tree_map(lambda p, sp: _shard_leaf(
        _init_one(p, gen, default_dtype, device), sp, mesh.shape,
        coords).clone(), tree, specs)


def unshard(tree, specs, mesh):
    """The inverse of :func:`shard`: every leaf all-gathered along its
    model dim over the model group and along its FSDP dim over the data
    group (every rank must call it).  For tests, checkpoints and
    ``chip_smoke.py``."""
    from repro_torch.launch.mesh import FSDP_ITEM_REMAINDER, MODEL_AXIS

    def one(x, spec):
        for dim, e in enumerate(spec):
            if e is None:
                continue
            axes = _entry_axes(e)
            if axes == (MODEL_AXIS,):
                group = mesh.model
            elif axes == tuple(a for a in mesh.fsdp_axes if a in axes):
                group = mesh.data
            else:
                raise NotImplementedError(
                    f"unshard over {e!r} on a mesh with FSDP axes "
                    f"{mesh.fsdp_axes}: {FSDP_ITEM_REMAINDER}")
            if group is not None:
                x = group.all_gather(x, dim)
        return x

    return T.tree_map(one, tree, specs)
