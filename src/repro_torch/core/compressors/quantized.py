"""Quantizing compressors with error feedback: the 1-bit Adam and
Efficient-Adam baselines (Sections IV and VII).

Counterpart of ``repro/core/compressors/quantized.py``.  Both are stateful:
the residual ``d - Q(d)`` is added back into the next round's input, so
``init_state`` always allocates the per-client residual tree.

* ``OneBitAdamCompressor``: sign quantization of the MOMENTUM delta with a
  per-block L1 scale (``local_update="momentum"``: one momentum step a
  round, V frozen after a dense warm-up; ``server_update="precond_m"``).
  Wire: the sign plane and per-block scales (``core/wire.pack_sign``).
* ``EfficientAdamCompressor``: b-bit uniform quantization of the WEIGHT
  delta; the local Adam moments persist per client and are never
  aggregated (``local_update="local_adam"``).  Wire: the codes at b bits
  and their scales (``core/wire.pack_bbit_codes``).

On the card each payload is one ``pack_words`` launch and its decode one
``unpack_words`` launch (``kernels/wirepack``); the quantizers around them
are plain PyTorch, as they are jnp in the JAX package.

On split leaves (``split``) each leaf is this rank's shard, quantized on
the whole leaf's blocks (``core/quantize.ShardBlocks``: one all-reduce
of the ``(nb,)`` block partials per leaf over its group); the residuals
stay shards, and no payload is built (the split rounds fold the
carriers).
"""
from __future__ import annotations

import dataclasses

from repro_torch import tree as T
from repro_torch.core import comm, quantize, wire
from repro_torch.core.compressors.base import (
    Compressor, Deltas, Packed, diag_metrics, register, tree_add, tree_sub,
    tree_zeros_like)


def _views(split, tree, block: int) -> list:
    """Per leaf of ``tree`` its ``quantize.ShardBlocks`` on a split mesh,
    else ``None``."""
    leaves = T.leaves(tree)
    if split is None:
        return [None] * len(leaves)
    return [split.blocks(i, x, block) for i, x in enumerate(leaves)]


@dataclasses.dataclass(frozen=True)
class OneBitAdamCompressor(Compressor):
    """1-bit Adam: error-feedback sign quantization of the momentum delta."""

    name: str = "onebit_adam"
    block: int = 1024
    q_bits: int = 32

    transport = "quantized"
    local_update = "momentum"
    server_update = "precond_m"
    wire_layout = "sign"

    def init_state(self, params):
        return {"err": tree_zeros_like(params)}

    def _wire_ok(self) -> bool:
        # one float32 scale per SCALE_BLOCK slots: only that block size
        # (and q = 32) matches the wire's layout
        return self.block == wire.SCALE_BLOCK \
            and self.q_bits == wire.VALUE_BITS

    def compress(self, deltas: Deltas, state, *, emit_wire: bool = True):
        assert state is not None, "1-bit Adam requires error-feedback state"
        dM = tree_add(deltas.M, state["err"])
        q = quantize.tree_sign_quant(dM, self.block,
                                     _views(self.split, dM, self.block))
        ef = Deltas(deltas.W, dM, deltas.V)
        packed = Packed(tree_zeros_like(q), q, tree_zeros_like(deltas.V),
                        diag_metrics(ef, Deltas(deltas.W, q, deltas.V),
                                     self.split),
                        wire.pack_sign(q) if emit_wire and self._wire_ok()
                        else None)
        return packed, {"err": tree_sub(dM, q)}, \
            self.bits_per_client(self._whole_size(deltas.W))

    def pack_wire(self, carriers: Deltas):
        # the M carrier is two-valued per block, so re-encoding a decoded
        # carrier gives the same signs and scales bitwise
        if not self._wire_ok():
            return None
        return wire.pack_sign(carriers.M)

    def unpack_wire(self, payload, like) -> Deltas:
        return Deltas(tree_zeros_like(like), wire.unpack_sign(payload, like),
                      tree_zeros_like(like))

    def bits_per_client(self, d: int) -> int:
        return comm.bits_onebit_adam(d, 1, self.q_bits, block=self.block)

    def wire_bits_per_client(self, sizes):
        if not self._wire_ok():
            return None
        return wire.sign_wire_bits(sizes)


@dataclasses.dataclass(frozen=True)
class EfficientAdamCompressor(Compressor):
    """Efficient-Adam: error-feedback b-bit quantization of the weight
    delta."""

    name: str = "efficient_adam"
    quant_bits: int = 8
    block: int = 1024
    q_bits: int = 32

    transport = "quantized"
    local_update = "local_adam"
    server_update = "w_only"
    wire_layout = "bbit"

    def init_state(self, params):
        return {"err": tree_zeros_like(params)}

    def _wire_ok(self) -> bool:
        return self.block == wire.SCALE_BLOCK \
            and self.q_bits == wire.VALUE_BITS \
            and self.quant_bits in (2, 4, 8)

    def _encode(self, tree):
        leaves, td = T.flatten(tree)
        views = _views(self.split, tree, self.block)
        return [quantize.uniform_encode(x, self.quant_bits, self.block, v)
                for x, v in zip(leaves, views)], leaves, td, views

    def _payload(self, enc):
        if not self._wire_ok():
            return None
        return wire.pack_bbit_codes([c for c, _ in enc], [s for _, s in enc],
                                    self.quant_bits)

    def compress(self, deltas: Deltas, state, *, emit_wire: bool = True):
        assert state is not None, \
            "Efficient-Adam requires error-feedback state"
        dW = tree_add(deltas.W, state["err"])
        # encode (codes and scales: the wire's arrays) and decode (the
        # dense carrier): the JAX package's tree_uniform_quant, bitwise
        enc, leaves, td, views = self._encode(dW)
        q = td.unflatten([
            quantize.uniform_decode(c, s, self.block, v).to(x.dtype)
            for (c, s), x, v in zip(enc, leaves, views)])
        ef = Deltas(dW, deltas.M, deltas.V)
        packed = Packed(q, tree_zeros_like(deltas.M),
                        tree_zeros_like(deltas.V),
                        diag_metrics(ef, Deltas(q, deltas.M, deltas.V),
                                     self.split),
                        self._payload(enc) if emit_wire else None)
        return packed, {"err": tree_sub(dW, q)}, \
            self.bits_per_client(self._whole_size(deltas.W))

    def pack_wire(self, carriers: Deltas):
        return self._payload(self._encode(carriers.W)[0])

    def unpack_wire(self, payload, like) -> Deltas:
        return Deltas(wire.unpack_bbit_codes(payload, like, self.quant_bits),
                      tree_zeros_like(like), tree_zeros_like(like))

    def bits_per_client(self, d: int) -> int:
        return comm.bits_efficient_adam(d, 1, self.q_bits,
                                        bits=self.quant_bits,
                                        block=self.block)

    def wire_bits_per_client(self, sizes):
        if not self._wire_ok():
            return None
        return wire.bbit_wire_bits(sizes, self.quant_bits)


@register("onebit_adam")
def _onebit(fed) -> OneBitAdamCompressor:
    return OneBitAdamCompressor(q_bits=fed.q_bits)


@register("efficient_adam")
def _efficient(fed) -> EfficientAdamCompressor:
    return EfficientAdamCompressor(quant_bits=fed.quant_bits,
                                   q_bits=fed.q_bits)
