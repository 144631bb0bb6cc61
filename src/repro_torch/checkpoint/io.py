"""npz checkpoints of trees of tensors, path-keyed, with JSON metadata.

Counterpart of ``repro/checkpoint/io.py``, with its file format: each
leaf is stored under its joined tree path (dict keys, sequence indices as
numbers, joined by ``/``), a :class:`~repro_torch.core.fed.FedState` as
the dict of its fields with ``round`` a 0-d int32, and a bfloat16 leaf as
its raw 2-byte patterns (numpy's ``V2``, what numpy writes for JAX's
bfloat16).  Files therefore load across the two packages in both
directions.  On load, the dtype and device of each leaf come from
``like``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterator, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.fed import FedState

_RAW = {torch.bfloat16: np.dtype("V2")}


def _paths(tree, prefix: Tuple[str, ...]) -> Iterator[Tuple[str, Any]]:
    """``(joined path, leaf)`` in the order of the tree's flattening."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif type(tree) in (list, tuple):
        for i, x in enumerate(tree):
            yield from _paths(x, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf, np.int32 if isinstance(leaf, int) else None)
    x = leaf.detach().cpu()
    if x.dtype in _RAW:
        return x.view(torch.int16).numpy().view(_RAW[x.dtype])
    return x.numpy()


def _from_numpy(arr: np.ndarray, like):
    if not isinstance(like, torch.Tensor):
        return type(like)(arr)
    if like.dtype in _RAW:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return t.view(like.dtype).to(like.device)
    return torch.from_numpy(np.array(arr)).to(like.device, like.dtype)


def _npz(path) -> str:
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_pytree(tree: Any, path, meta: dict | None = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: _to_numpy(x) for k, x in _paths(tree, ())})
    if meta is not None:
        Path(str(path) + ".meta.json").write_text(json.dumps(meta, indent=1))


def load_pytree(like: Any, path) -> Any:
    """Load into the structure of ``like``, shapes checked."""
    out = []
    with np.load(_npz(path)) as data:
        for key, leaf in _paths(like, ()):
            arr = data[key]
            shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
                else ()
            if tuple(arr.shape) != shape:
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {shape}")
            out.append(_from_numpy(arr, leaf))
    return T.flatten(like)[1].unflatten(out)


def save_fed_state(state: FedState, path, meta: dict | None = None) -> None:
    save_pytree(state._asdict(), path, meta)


def load_fed_state(like: FedState, path) -> FedState:
    return FedState(**load_pytree(like._asdict(), path))
