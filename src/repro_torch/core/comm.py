"""Uplink/downlink communication accounting (bits) — Section IV & VII.

A copy of ``repro/core/comm.py`` (pure Python): the port imports nothing
of the JAX package.

The paper counts, per communication round, with q = float precision bits,
d = model dimension, k = alpha*d, N = #devices:

* FedAdam        : 3 N d q
* FedAdam-Top    : min{ 3N(kq + d),  3Nk(q + log2 d) }      (mask vs index)
* FedAdam-SSM    : min{ N(3kq + d),  Nk(3q + log2 d) }      (one mask/index)
* 1-bit Adam     : warm-up rounds 3Ndq; compressed rounds N(d + q*d/B)
                   (sign bits + one scale per block of B)
* Efficient-Adam : N(b*d + q*d/B) for b-bit two-way quantization

These are *accounting* functions (exact bit counts reported as metrics);
the on-mesh collective realization lives in core/aggregate.py.  The FL
round does NOT call :func:`bits_for` directly: each compressor in
core/compressors reports its own per-client bits through these formulas
(``Compressor.bits_per_client``), so the metric is produced by the same
object that produced the payload and cannot drift from the transport.
Per-algorithm formula derivations: docs/compressors.md.
"""
from __future__ import annotations

import math
from typing import Sequence


def _ceil_log2(d: int) -> int:
    """ceil(log2 d) index-representation bits.  d <= 1 needs ZERO bits
    (a single-slot index set is fully determined) — the old ``max(2, d)``
    clamp silently billed 1 bit for degenerate 1-element test trees."""
    if d <= 1:
        return 0
    return math.ceil(math.log2(d))


def bits_fedadam(d: int, n_clients: int, q: int = 32) -> int:
    return 3 * n_clients * d * q


def bits_fedadam_top(d: int, k: int, n_clients: int, q: int = 32) -> int:
    mask_repr = 3 * n_clients * (k * q + d)
    index_repr = 3 * n_clients * k * (q + _ceil_log2(d))
    return int(min(mask_repr, index_repr))


def bits_fedadam_ssm(d: int, k: int, n_clients: int, q: int = 32) -> int:
    mask_repr = n_clients * (3 * k * q + d)
    index_repr = n_clients * k * (3 * q + _ceil_log2(d))
    return int(min(mask_repr, index_repr))


def bits_fedsgd(d: int, n_clients: int, q: int = 32) -> int:
    return n_clients * d * q


def bits_onebit_adam(d: int, n_clients: int, q: int = 32,
                     warmup: bool = False, block: int = 1024) -> int:
    if warmup:
        return bits_fedadam(d, n_clients, q)
    return n_clients * (d + q * math.ceil(d / block))


def bits_efficient_adam(d: int, n_clients: int, q: int = 32,
                        bits: int = 8, block: int = 1024) -> int:
    return n_clients * (bits * d + q * math.ceil(d / block))


def bits_for(algorithm: str, d: int, k: int, n_clients: int, q: int = 32,
             warmup: bool = False, quant_bits: int = 8, *,
             sizes: "Sequence[int] | None" = None,
             alpha: "float | None" = None,
             mask_scope: str = "per_tensor",
             exact_topk: bool = True) -> int:
    """Uplink bits for ``n_clients`` clients of algorithm ``algorithm``.

    Without ``sizes`` this is the paper-analytic Section IV/VII count
    (the formulas above).  With ``sizes`` (the model's per-leaf element
    counts) it is the WIRE-EXACT count: ``8 * WirePayload.nbytes`` of
    the payload the registered compressor actually ships, including
    layout padding and static mask-capacity slack (core/wire.py) —
    mask schemes then also need ``alpha``/``mask_scope``/``exact_topk``.
    """
    if sizes is not None:
        return n_clients * _wire_bits_one(
            algorithm, sizes, alpha, mask_scope, exact_topk,
            warmup=warmup, quant_bits=quant_bits, q=q)
    if algorithm in ("fedadam",):
        return bits_fedadam(d, n_clients, q)
    if algorithm in ("fedadam_top",):
        return bits_fedadam_top(d, k, n_clients, q)
    if algorithm in ("fedadam_ssm", "ssm_m", "ssm_v", "fairness_top"):
        return bits_fedadam_ssm(d, k, n_clients, q)
    if algorithm == "fedsgd":
        return bits_fedsgd(d, n_clients, q)
    if algorithm == "onebit_adam":
        return bits_onebit_adam(d, n_clients, q, warmup=warmup)
    if algorithm == "efficient_adam":
        return bits_efficient_adam(d, n_clients, q, bits=quant_bits)
    raise ValueError(algorithm)


def _wire_bits_one(algorithm: str, sizes, alpha, mask_scope: str,
                   exact_topk: bool, *, warmup: bool, quant_bits: int,
                   q: int) -> int:
    """Wire-exact bits for ONE client (lazy import: wire pulls in torch,
    which this accounting module otherwise never needs)."""
    from repro_torch.core import wire
    if q != wire.VALUE_BITS:
        raise ValueError(
            f"the wire format ships f32 side streams; q={q} has no "
            f"wire-exact count (only q={wire.VALUE_BITS})")
    d = sum(int(n) for n in sizes)
    if algorithm == "fedadam" or (algorithm == "onebit_adam" and warmup):
        return wire.dense_wire_bits(sizes, 3)
    if algorithm == "fedsgd":
        return wire.dense_wire_bits(sizes, 1)
    if algorithm in ("fedadam_top", "fedadam_ssm", "ssm_m", "ssm_v",
                     "fairness_top"):
        if alpha is None:
            raise ValueError(
                f"wire-exact bits for {algorithm!r} need alpha")
        return wire.mask_wire_bits(sizes, alpha, mask_scope, exact_topk,
                                   shared=algorithm != "fedadam_top")
    if algorithm == "onebit_adam":
        return wire.sign_wire_bits(sizes)
    if algorithm == "efficient_adam":
        return wire.bbit_wire_bits(sizes, quant_bits)
    raise ValueError(algorithm)
