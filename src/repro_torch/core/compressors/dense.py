"""Identity (dense) compressors: the FedAdam and FedSGD baselines.

Counterpart of ``repro/core/compressors/dense.py``.  Nothing is dropped:
the full triple (FedAdam) or W alone (FedSGD) crosses the uplink as
raveled float32 planes (``core/wire.pack_dense``), Section IV's 3Ndq and
Ndq bits per round.  Decoding is the identity, so the round skips the wire
round trip for this transport, as the JAX round does, and ``compress``
builds no payload (the jitted JAX round drops its unused one); the
uplink bits come from the layout (``wire_bits_per_client``), and
``pack_wire`` builds the payload on request.  On split leaves (``split``)
the carriers are the shards, folded as they lie, and the diagnostics'
norms the whole tree's.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import comm, wire
from repro_torch.core.compressors.base import (
    Compressor, Deltas, Packed, diag_metrics, register, tree_zeros_like)


@dataclasses.dataclass(frozen=True)
class DenseCompressor(Compressor):
    """Identity operator over ``n_tensors`` communicated tensors."""

    name: str = "fedadam"
    q_bits: int = 32
    n_tensors: int = 3                 # W, M, V (FedAdam) or W (FedSGD)
    local_update: str = "adam"
    server_update: str = "wmv"

    transport = "dense"
    wire_layout = "dense"

    def _wire_ok(self) -> bool:
        # the wire ships float32 planes: exact only at the paper's q = 32
        return self.q_bits == wire.VALUE_BITS

    def compress(self, deltas: Deltas, state, *, emit_wire: bool = True):
        packed = Packed(deltas.W, deltas.M, deltas.V,
                        diag_metrics(deltas, deltas, self.split), None)
        return packed, state, self.bits_per_client(
            self._whole_size(deltas.W))

    def pack_wire(self, carriers: Deltas):
        if not self._wire_ok():
            return None
        return wire.pack_dense(
            (carriers.W, carriers.M, carriers.V)[:self.n_tensors])

    def unpack_wire(self, payload, like) -> Deltas:
        planes = wire.unpack_dense(payload, like)
        if self.n_tensors == 3:
            return Deltas(*planes)
        return Deltas(planes[0], tree_zeros_like(like),
                      tree_zeros_like(like))

    def bits_per_client(self, d: int) -> int:
        if self.n_tensors == 3:
            return comm.bits_fedadam(d, 1, self.q_bits)
        return comm.bits_fedsgd(d, 1, self.q_bits)

    def wire_bits_per_client(self, sizes):
        if not self._wire_ok():
            return None
        return wire.dense_wire_bits(sizes, self.n_tensors)


@register("fedadam")
def _fedadam(fed) -> DenseCompressor:
    return DenseCompressor(name="fedadam", q_bits=fed.q_bits, n_tensors=3)


@register("fedsgd")
def _fedsgd(fed) -> DenseCompressor:
    return DenseCompressor(name="fedsgd", q_bits=fed.q_bits, n_tensors=1,
                           local_update="sgd", server_update="w_only")
