"""Quantizers of the quantized-FedAdam baselines (1-bit Adam,
Efficient-Adam).

Counterpart of ``repro/core/quantize.py``.  Every quantizer is blockwise
(one float32 scale per ``block`` elements of the flattened leaf, the last
block zero-padded) and comes with an exact dequantizer, so error-feedback
residuals are computable.  Plain PyTorch: the JAX package computes these
with jnp outside any kernel.

Scalars that divide a tensor enter as tensors on the tensor's device:
PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
which is not the correctly rounded quotient the CPU and XLA take.

Every leaf is quantized through its :class:`ShardBlocks`: a whole leaf
is one whose every dim is one part and whose group is none.  A leaf
split over a model axis or the FSDP axes (``view``, this rank's
:class:`ShardBlocks`) is quantized as the whole leaf: its elements are
laid at their places in the whole leaf's blocks (the rows of the blocks
this rank touches, zeros at every other rank's places), each rank
reduces them into the whole leaf's ``(nb,)`` per-block partials, the
leaf's group reduces that vector (the max exactly; the sum of 1-bit
Adam's L1 mean in another order than the whole leaf's row, for a block
that straddles ranks), and every element takes its block's scale.  The
elementwise steps are the whole leaf's, so Efficient-Adam's codes and
scales are bitwise the whole leaf's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.device import device_cache

_F32 = torch.float32


@device_cache(256)
def _layout(place: tuple, shape: tuple, block: int, device: torch.device):
    """Where a shard's elements lie in the whole leaf's blocks.  ``place``:
    per dim ``(index, parts)``, this rank's chunk of the dim; ``shape``:
    the shard's.  The shard is ``runs`` runs of ``run`` elements that are
    contiguous in the whole leaf's flattening (the dims after the last
    split one are whole).  Returns ``(rows, n_blocks, runs, run, base,
    step)``: the whole leaf's blocks this rank touches (ascending, on
    ``device``), how many blocks the whole leaf has, and each run's
    first place in the ``(len(rows), block)`` buffer of those blocks:
    ``base + r * step`` when the places are evenly spaced (``base`` an
    int, a strided view), else ``base`` an int64 tensor and ``step``
    None."""
    whole = [n * p for n, (_, p) in zip(shape, place)]
    split = [d for d, (_, p) in enumerate(place) if p > 1]
    last = split[-1] if split else 0
    strides = [math.prod(whole[d + 1:]) for d in range(len(whole))]
    run = math.prod(shape[last:])
    start = place[last][0] * shape[last] * strides[last] if split else 0
    offs = np.full((1,), start, np.int64)
    for d in range(last):
        i0 = place[d][0] * shape[d]
        offs = (offs[:, None] + (i0 + np.arange(shape[d], dtype=np.int64))
                * strides[d]).reshape(-1)
    first, final = offs // block, (offs + run - 1) // block
    lens = final - first + 1
    cover = np.repeat(first - np.cumsum(lens) + lens, lens) + \
        np.arange(int(lens.sum()), dtype=np.int64)
    rows = np.unique(cover)
    base = np.searchsorted(rows, first) * block + offs % block
    gaps = np.diff(base)
    rows_t = torch.from_numpy(rows).to(device)
    n_blocks = -(-math.prod(whole) // block)
    if len(base) == 1 or (gaps == gaps[0]).all():
        step = int(gaps[0]) if len(base) > 1 else run
        return rows_t, n_blocks, len(offs), run, int(base[0]), step
    return rows_t, n_blocks, len(offs), run, \
        torch.from_numpy(base).to(device), None


@dataclasses.dataclass(frozen=True)
class ShardBlocks:
    """This rank's shard of a split leaf on the whole leaf's quantizer
    blocks: ``group`` (a ``launch.mesh.ModelGroup``) holds the leaf's
    shards, ``place`` per dim ``(index, parts)``, ``shape`` the shard's
    (``sparsify.LeafSplit.blocks`` makes it); :meth:`whole` a whole
    leaf's."""
    group: object
    place: tuple
    shape: tuple
    block: int
    device: torch.device

    @classmethod
    def whole(cls, x: torch.Tensor, block: int) -> "ShardBlocks":
        """A whole leaf ``x``: one part per dim, no group."""
        return cls(None, ((0, 1),) * x.dim(), tuple(x.shape), block,
                   x.device)

    def _layout(self):
        return _layout(self.place, self.shape, self.block, self.device)

    @property
    def rows(self) -> torch.Tensor:
        """The whole leaf's blocks this rank touches, ascending."""
        return self._layout()[0]

    def _places(self, flat: torch.Tensor) -> torch.Tensor:
        """The shard's elements in ``flat`` (the blocks' buffer), as a
        ``(runs, run)`` view or gather."""
        _, _, runs, run, base, step = self._layout()
        if step is not None:
            return flat.as_strided((runs, run), (step, 1), base)
        idx = base[:, None] + torch.arange(run, device=flat.device)
        return flat[idx.reshape(-1)].reshape(runs, run)

    def blocks(self, x: torch.Tensor) -> torch.Tensor:
        """``(len(rows), block)`` float32: the shard ``x`` at its places in
        the whole leaf's blocks, zeros elsewhere."""
        rows, _, runs, run, base, step = self._layout()
        flat = torch.zeros((rows.numel() * self.block,), dtype=_F32,
                           device=x.device)
        src = x.reshape(runs, run)
        if step is not None:
            flat.as_strided((runs, run), (step, 1), base).copy_(src)
        else:
            idx = base[:, None] + torch.arange(run, device=x.device)
            flat[idx.reshape(-1)] = src.reshape(-1).to(_F32)
        return flat.view(-1, self.block)

    def shard(self, xb: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`blocks`: this rank's elements of a
        ``(len(rows), block)`` buffer, in the shard's shape."""
        return self._places(xb.reshape(-1)).reshape(self.shape)

    def reduce(self, part: torch.Tensor, op: str) -> torch.Tensor:
        """The whole leaf's ``(nb,)`` vector from this rank's per-row
        ``part``: zeros at the blocks it does not touch, then reduced
        (``"max"`` or ``"sum"``) over the group (a whole leaf's rows are
        all its blocks: ``part`` itself)."""
        if self.group is None:
            return part
        rows, n_blocks = self._layout()[:2]
        full = torch.zeros((n_blocks,), dtype=part.dtype,
                           device=part.device)
        full[rows] = part
        return self.group.all_reduce(full, op)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=_F32, device=like.device)


def sign_quant(x: torch.Tensor, block: int = 1024,
               view: Optional[ShardBlocks] = None) -> torch.Tensor:
    """1-bit sign quantization with a per-block L1 scale (1-bit Adam):
    ``+scale`` where x >= 0, ``-scale`` elsewhere, scale = mean |block|
    (padding zeros counted).  Two-valued per block, so a sign bitplane and
    one float32 per block carry it exactly (``core/wire.pack_sign``).
    ``view``: ``x`` is this rank's shard of a split leaf (the module
    docstring); ``None``: a whole leaf."""
    view = view or ShardBlocks.whole(x, block)
    xb = view.blocks(x)
    sums = view.reduce(xb.abs().sum(dim=1), "sum")
    scale = (sums / _scalar(float(block), sums))[view.rows]
    q = torch.where(xb >= 0, scale[:, None], -scale[:, None])
    return view.shard(q).to(x.dtype)


def uniform_encode(x: torch.Tensor, bits: int = 8, block: int = 1024,
                   view: Optional[ShardBlocks] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric b-bit uniform quantization with a per-block max scale, the
    encoder half: ``(codes, scales)``, int32
    codes of x's shape in ``[-qmax, qmax]`` (qmax = 2**(bits-1) - 1) and
    (nb,) float32 scales ``max|block| / qmax + 1e-30``.  ``view``: ``x``
    is this rank's shard of a split leaf; the scales are then the whole
    leaf's; ``None``: a whole leaf."""
    qmax = 2.0 ** (bits - 1) - 1.0
    view = view or ShardBlocks.whole(x, block)
    xb = view.blocks(x)
    amax = view.reduce(xb.abs().amax(dim=1), "max")
    scales = amax / _scalar(qmax, amax) + 1e-30
    q = torch.round(xb / scales[view.rows][:, None]).clamp_(-qmax, qmax) \
        .to(torch.int32)
    return view.shard(q), scales


def uniform_decode(codes: torch.Tensor, scales: torch.Tensor,
                   block: int = 1024,
                   view: Optional[ShardBlocks] = None) -> torch.Tensor:
    """Exact dequantizer of :func:`uniform_encode` (float32 result);
    ``view`` as there, ``scales`` the whole leaf's."""
    view = view or ShardBlocks.whole(codes, block)
    return view.shard(view.blocks(codes) * scales[view.rows][:, None])


def tree_sign_quant(tree, block: int = 1024, views=None):
    """``views``: per leaf (flatten order) its :class:`ShardBlocks` or
    ``None``."""
    leaves, td = T.flatten(tree)
    views = views or [None] * len(leaves)
    return td.unflatten([sign_quant(x, block, v)
                         for x, v in zip(leaves, views)])
