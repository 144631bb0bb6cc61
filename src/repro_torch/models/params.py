"""Parameter metadata: shapes, init and dtype in one declarative record.

Counterpart of ``repro/models/params.py``.  Model builders return trees
whose leaves are :class:`P`; :func:`materialize` turns such a tree into
tensors.  The logical axis names are kept for the JAX layout's sake: the
rules that read them (``pspecs``, the tensor and FSDP sharding of the
leaves) are the open half of ROADMAP §1.10.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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
