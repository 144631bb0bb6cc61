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

(``torch.distributed.nn``'s all-reduce has an all-reduce backward, not
the identity that g needs.)  So between ``copy`` and ``reduce`` (or a
``gather``'s consumer), gradients are partial on each rank; outside, every
rank holds the whole activation and its whole gradient, bit for bit the
same.  A bfloat16 all-reduce adds in float32 (``ModelGroup``).
"""
from __future__ import annotations

import torch


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
    ``None`` (no model axis): ``x``."""
    return x if group is None else _Copy.apply(x, group)


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
        return torch.einsum(eq, x, w)
    if w.shape[-1] != full:
        return gather(torch.einsum(eq, x, w), group, -1 % x.dim())
    return torch.einsum(eq, x, copy(w, group))


def row(y: torch.Tensor, w: torch.Tensor, group, eq: str) -> torch.Tensor:
    """The partial product of this rank's chunk of ``y``'s last dim (``y``
    whole on every rank) and its rows of ``w`` (split on dim 0, or the
    same rows of a replicated ``w``), summed over the group (g)."""
    if group is None:
        return torch.einsum(eq, y, w)
    n = y.shape[-1]
    lo, hi = group.chunk(n)
    if w.shape[0] == n:
        w = copy(w, group)[lo:hi]
    return reduce(torch.einsum(eq, y[..., lo:hi], w), group)
