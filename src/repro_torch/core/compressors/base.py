"""The ``Compressor`` protocol and registry (Section IV as an API).

Counterpart of ``repro/core/compressors/base.py``:

* ``Deltas``: the raw local update triple (trees of dW, dM, dV);
* ``Packed``: the compressed triple as dense carriers, encoder-side
  diagnostics (:data:`DIAG_KEYS`) and the wire payload;
* ``Compressor``: ``init_state(params) -> state``,
  ``compress(deltas, state, *, emit_wire=True) -> (packed, state, bits)``
  (``emit_wire=False``: no payload is built, ``packed.wire`` is None),
  ``unpack_wire``,
  the accounting methods, and the declarative tags ``transport``,
  ``local_update`` and ``server_update`` that ``core/fed.py`` dispatches
  on; ``split``, set by the round on a model axis or FSDP axes (a
  ``sparsify.LeafSplit``): each leaf the compressor sees is then this
  rank's shard, and what it computes is the whole leaf's (its masks,
  scales and norms; the bill of the whole leaves).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core import sparsify as S

_F32 = torch.float32

#: Canonical diagnostic keys every compressor reports.
DIAG_KEYS = ("err_w", "err_m", "err_v", "norm_dw", "norm_dm", "norm_dv")


class Deltas(NamedTuple):
    """The client's raw local update (Algorithm 2 step 3)."""
    W: Any
    M: Any
    V: Any


class Packed(NamedTuple):
    """A compressed update triple: dense carriers, diagnostics (never
    transported) and the :class:`~repro_torch.core.wire.WirePayload`."""
    W: Any
    M: Any
    V: Any
    diag: Dict[str, torch.Tensor]
    wire: Any = None


def tree_sub(a, b):
    """Elementwise a - b in float32, cast back to the leaf dtype."""
    return T.tree_map(lambda x, y: (x.to(_F32) - y.to(_F32)).to(x.dtype),
                      a, b)


def tree_add(a, b):
    return T.tree_map(lambda x, y: (x.to(_F32) + y.to(_F32)).to(x.dtype),
                      a, b)


def tree_zeros_like(t):
    return T.tree_map(torch.zeros_like, t)


def tree_size(t) -> int:
    return sum(x.numel() for x in T.leaves(t))


def diag_metrics(deltas: Deltas, recon: Deltas,
                 split: Optional[S.LeafSplit] = None
                 ) -> Dict[str, torch.Tensor]:
    """Default diagnostics: per-tensor compression error ``||d - C(d)||_2``
    (the Theorem-1 divergence terms) and the input norms; ``deltas`` is
    the error-feedback adjusted encoder input.  ``split``: the leaves are
    shards, and the norms the whole tree's (``sparsify.tree_norm``)."""
    nd = lambda d, r: S.tree_norm(tree_sub(d, r), split)
    return {
        "err_w": nd(deltas.W, recon.W),
        "err_m": nd(deltas.M, recon.M),
        "err_v": nd(deltas.V, recon.V),
        "norm_dw": S.tree_norm(deltas.W, split),
        "norm_dm": S.tree_norm(deltas.M, split),
        "norm_dv": S.tree_norm(deltas.V, split),
    }


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base class / protocol; see ``repro/core/compressors/base.py`` for
    the full contract.  The tags are class attributes; ``split`` is the
    one field every compressor has (the module docstring)."""

    name = "base"
    transport = "dense"
    local_update = "adam"
    server_update = "wmv"
    wire_layout = None
    split: Optional[S.LeafSplit] = dataclasses.field(default=None,
                                                     kw_only=True)

    def _whole_size(self, tree) -> int:
        """The size of ``tree``'s whole leaves (its shards' on a split
        mesh)."""
        return tree_size(tree) if self.split is None \
            else sum(self.split.sizes(tree))

    def init_state(self, params) -> Optional[Any]:
        """Per-client state for ONE client (``None``: stateless)."""
        return None

    def compress(self, deltas: Deltas, state, *,
                 emit_wire: bool = True) -> Tuple[Packed, Any, Any]:
        raise NotImplementedError

    def decompress(self, packed: Packed) -> Deltas:
        return Deltas(packed.W, packed.M, packed.V)

    def pack_wire(self, carriers: Deltas) -> Optional[Any]:
        return None

    def unpack_wire(self, wire, like) -> Deltas:
        raise NotImplementedError(f"{self.name} has no wire realization")

    def bits_per_client(self, d: int) -> int:
        raise NotImplementedError

    def wire_bits_per_client(self, sizes) -> Optional[int]:
        return None


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., Compressor]] = {}


def register(name: str):
    """Decorator: register ``factory(fed_config) -> Compressor``."""
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def available() -> Tuple[str, ...]:
    """Registered algorithm names, in registration order."""
    return tuple(_REGISTRY)


def check_algorithm(name: str) -> None:
    if name not in _REGISTRY:
        raise KeyError(f"no compressor registered for {name!r}; "
                       f"known: {sorted(_REGISTRY)}")


def make_compressor(fed) -> Compressor:
    """Build the compressor for ``fed.algorithm`` from its config."""
    check_algorithm(fed.algorithm)
    return _REGISTRY[fed.algorithm](fed)


def transport_of(algorithm: str) -> str:
    """Transport tag of an algorithm's compressor, without a round."""
    from repro_torch.core.fed import FedConfig
    return make_compressor(FedConfig(algorithm=algorithm)).transport
