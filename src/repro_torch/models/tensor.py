"""The model axis's collectives for the tensor-parallel layers.

The JAX package writes each layer once, on global arrays, and GSPMD
inserts the collectives its ``PartitionSpec`` s imply.  The port splits
the leaves itself (``models/params.shard``) and writes the collectives
out, Megatron-style, as autograd functions of its own over a
:class:`~repro_torch.launch.mesh.ModelGroup`:

* :func:`copy` (Megatron's f): the identity forward, an all-reduce of the
  gradient backward.  It opens a split region: an activation (or a whole
  weight) that every rank holds and that each rank then uses only in
  part gets back only that part's gradient, and the backward sums them.
* :func:`reduce` (Megatron's g): an all-reduce forward, the identity
  backward.  It closes a split region: the partial sums of a row-split
  product (or a vocabulary-split lookup) become the whole activation.
* :func:`gather`: an all-gather along a dim forward, a reduce-scatter of
  the gradient backward.  A split output gathered for a computation every
  rank then runs whole, and of which each rank again uses only its part
  (the SSD's scan between a column- and a row-split product), gets
  partial gradients back: their sum, chunked, is the split output's.

Every product of an activation and a leaf goes through :func:`mm`, a
plain ``einsum`` on a tensor.  The 2-D serving of the ``fsdp`` plans
(:class:`Serve2D`) hands the layers each matrix leaf split along its
``embed`` dim over the data group as a :class:`Split2D`, which
:func:`mm` multiplies without gathering the leaf: the activations of
every batch row of the data group are gathered instead, each rank
multiplies them by its ``embed`` shard, and the partial products are
summed (``embed`` contracted) or gathered along ``embed`` (an output
dim) over the data group before each rank keeps its own rows.  A rank
never holds more of a leaf than its shard.

(``torch.distributed.nn``'s all-reduce has an all-reduce backward, not
the identity that g needs.)  So between ``copy`` and ``reduce`` (or a
``gather``'s consumer), gradients are partial on each rank; outside, every
rank holds the whole activation and its whole gradient, bit for bit the
same.  A bfloat16 all-reduce adds in float32 (``ModelGroup``).

The ``fsdp`` plans split the leaves' ``embed`` dim over the data group as
well (:class:`FSDP`), where each rank holds its own slice of the batch:
a leaf is all-gathered over the data group just before its layer uses it
(:func:`gather`, whose backward reduce-scatters the gradient: the sum of
every data rank's) and a leaf the data axes do not split goes through
:func:`copy` (its gradient all-reduced over them), so every rank ends
with its shard of the whole batch's gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch import tree as T


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        return group.all_reduce(x, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g, ctx.dim), None, None


def copy(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, gradient all-reduced backward (f); ``group``
    ``None`` (no model axis), or a :class:`Split2D` leaf (served, no
    gradient): ``x``."""
    if group is None or isinstance(x, Split2D):
        return x
    return _Copy.apply(x, group)


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward (g)."""
    return x if group is None else _Reduce.apply(x, group, "sum")


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` forward, reduce-scatter backward."""
    return x if group is None else _Gather.apply(x, group, dim)


def gather_or_copy(w: torch.Tensor, group, full: int,
                   dim: int = -1) -> torch.Tensor:
    """A leaf that every rank must use whole inside a split region: its
    shards gathered along ``dim`` when the model axis splits it (``full``
    the whole size there), else :func:`copy` of the replicated leaf."""
    if group is None:
        return w
    if w.shape[dim] != full:
        return gather(w, group, dim % w.dim())
    return copy(w, group)


def column(x: torch.Tensor, w: torch.Tensor, group, full: int,
           eq: str) -> torch.Tensor:
    """``einsum(eq, x, w)`` of a column-split ``w`` (``full`` columns
    whole) with its output gathered along the last dim: every rank gets
    the whole product.  ``x`` must already be inside the split region
    (:func:`copy`); a replicated ``w`` is multiplied whole."""
    if group is None:
        return mm(eq, x, w)
    if w.shape[-1] != full:
        return gather(mm(eq, x, w), group, -1 % x.dim())
    return mm(eq, x, copy(w, group))


def row(y: torch.Tensor, w: torch.Tensor, group, eq: str) -> torch.Tensor:
    """The partial product of this rank's chunk of ``y``'s last dim (``y``
    whole on every rank) and its rows of ``w`` (split on dim 0, or the
    same rows of a replicated ``w``), summed over the group (g)."""
    if group is None:
        return mm(eq, y, w)
    n = y.shape[-1]
    lo, hi = group.chunk(n)
    if w.shape[0] == n:
        w = copy(w, group)[lo:hi]
    return reduce(mm(eq, y[..., lo:hi], w), group)


@dataclasses.dataclass(frozen=True)
class FSDP:
    """The leaves' split over the FSDP axes: ``group`` the data group (a
    ``launch.mesh.ModelGroup``), ``specs`` the params' ``Spec`` tree and
    ``axes`` the FSDP axes, data[, pod]."""
    group: Any
    specs: Any
    axes: Tuple[str, ...]

    def use(self, x: torch.Tensor, spec, lead: int = 0) -> torch.Tensor:
        """``x`` as the layers take it: gathered over the data group along
        the dim its spec splits over the FSDP axes, else :func:`copy`.
        ``lead``: leading dims of ``spec`` that ``x`` lacks (a layer's
        slice of a stacked leaf)."""
        for dim, e in enumerate(tuple(spec)[lead:]):
            if e is not None and any(
                    a in self.axes for a in ((e,) if isinstance(e, str)
                                             else e)):
                return gather(x, self.group, dim)
        return copy(x, self.group)

    def tree(self, tree, specs, lead: int = 0):
        """:meth:`use` over a tree of leaves and its specs."""
        return T.tree_map(lambda x, sp: self.use(x, sp, lead), tree, specs)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the data group of a per-rank mean ``x`` (each
        rank's share of the batch the same size): ``x / size`` summed
        forward, the identity backward (each rank's gradient is then its
        share of the whole mean's, which the leaves' collectives sum)."""
        return reduce(x / self.group.size, self.group)


def mm(eq: str, x: torch.Tensor, w) -> torch.Tensor:
    """``einsum(eq, x, w)`` of an activation ``x`` (batch first) and a
    leaf ``w``: a :class:`Split2D` leaf by :meth:`Split2D.mm`."""
    if isinstance(w, Split2D):
        return w.mm(eq, x)
    return torch.einsum(eq, x, w)


class Split2D:
    """A matrix leaf of the 2-D serving form: ``shard``, this rank's shard
    (its model split, if any, as the tp layers take it), split along
    ``dim`` over ``ctx``'s data group.  The layers read its ``shape`` and
    ``dtype`` (the shard's), cast it (``to``) and merge its leading dims
    (``reshape``, the split dim last); :func:`mm` multiplies it."""

    def __init__(self, shard: torch.Tensor, dim: int, ctx: "Serve2D"):
        self.shard, self.dim, self.ctx = shard, dim, ctx

    @property
    def shape(self):
        return self.shard.shape

    @property
    def dtype(self):
        return self.shard.dtype

    def to(self, dtype) -> "Split2D":
        return Split2D(self.shard.to(dtype), self.dim, self.ctx)

    def reshape(self, *shape) -> "Split2D":
        last = self.shard.dim() - 1
        out = self.shard.reshape(*shape)
        if self.dim != last or out.shape[-1] != self.shard.shape[-1]:
            raise NotImplementedError(
                f"a reshape of a leaf split along dim {self.dim} to {shape}")
        return Split2D(out, out.dim() - 1, self.ctx)

    def mm(self, eq: str, x: torch.Tensor) -> torch.Tensor:
        """``einsum(eq, x, whole leaf)`` for this rank's batch rows: the
        rows of the data group gathered (none with the batch whole on
        every rank), multiplied by the shard, and then summed over the
        data group where ``eq`` contracts the split dim (this rank's
        slice of ``x`` along it), or gathered along it where it is an
        output dim; this rank's rows kept."""
        ins, out = eq.split("->")
        xs, ws = ins.split(",")
        c = ws[self.dim]
        data, rows = self.ctx.group, self.ctx.rows
        xa = x if rows is None else rows.all_gather(x, 0)
        if c in out:
            y = data.all_gather(torch.einsum(eq, xa, self.shard),
                                out.index(c))
        else:
            n = self.shard.shape[self.dim]
            y = data.all_reduce(torch.einsum(
                eq, xa.narrow(xs.index(c), n * data.index, n), self.shard))
        if rows is None:
            return y
        return y.narrow(0, rows.index * x.shape[0], x.shape[0])


@dataclasses.dataclass(frozen=True)
class Serve2D:
    """The 2-D serving of the ``fsdp`` plans: ``group`` the data group,
    ``specs`` the params' ``Spec`` tree, ``axes`` the FSDP axes, and
    ``rows`` the group over which the batch rows are split (JAX's
    ``("pod", "data")`` order; the same ranks as ``group``), or ``None``
    where every data rank holds the whole batch (the long shapes).  Its
    :meth:`use` and :meth:`tree` stand where :class:`FSDP`'s gather the
    leaves in training: a 1-D leaf (a norm scale) is gathered whole, a
    matrix leaf stays this rank's shard, as a :class:`Split2D`."""
    group: Any
    specs: Any
    axes: Tuple[str, ...]
    rows: Any = None

    def use(self, x: torch.Tensor, spec, lead: int = 0):
        for dim, e in enumerate(tuple(spec)[lead:]):
            if e is not None and any(
                    a in self.axes for a in ((e,) if isinstance(e, str)
                                             else e)):
                if x.dim() == 1:
                    return self.group.all_gather(x, 0)
                return Split2D(x, dim, self)
        return x

    def tree(self, tree, specs, lead: int = 0):
        return T.tree_map(lambda x, sp: self.use(x, sp, lead), tree, specs)


@dataclasses.dataclass(frozen=True)
class KVSplit:
    """The split-KV decode's cache sequence split: ``group`` the ranks of
    the cache's ``kv_seq`` axes (this rank holds slots ``[index * S_loc,
    (index + 1) * S_loc)`` of a leaf the axes split), ``model`` whether
    they include the model axis (then every rank attends with every query
    head, and keeps its own heads after the combine)."""
    group: Any
    model: bool = False
