"""Wire-format word packing: b-bit codes <-> uint32 words.

Counterpart of ``repro/kernels/wirepack/{wirepack,ops}.py``.  Layout: an
(R, 128) int32 code buffer with R % 32 == 0 and codes in [0, 2**b);
every (32, 128) block becomes b word rows,
``word[i*b + q, c] = sum_t code[i*32 + q*T + t, c] << (t*b)`` with
T = 32 / b, wrapping in uint32.  On a CUDA tensor the wrappers launch the
kernels of ``csrc/wirepack.cu``; on a CPU tensor they run the plain
versions below.  Only the b=1 mask bitmap is on the FedAdam-SSM path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _lib
from repro_torch.kernels._check import cuda_arg, on_cpu, ptr, stream

LANES = 128
CODE_SUBLANES = 32
WORD_BITS = 32
SUPPORTED_BITS = (1, 2, 4, 8)

_U32 = 0xFFFFFFFF


def _check_bits(bits: int) -> int:
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")
    return WORD_BITS // bits


def _to_uint32(w64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the same bits as a uint32 tensor."""
    w = torch.where(w64 >= 2 ** 31, w64 - 2 ** 32, w64)
    return w.to(torch.int32).view(torch.uint32)


def pack_words_plain(codes: torch.Tensor, bits: int) -> torch.Tensor:
    T = _check_bits(bits)
    nb = codes.shape[0] // CODE_SUBLANES
    u = codes.to(torch.int64).reshape(nb, bits, T, LANES) & _U32
    shifts = torch.arange(T, device=codes.device) * bits
    w = (u << shifts[None, None, :, None]).sum(dim=2) & _U32
    return _to_uint32(w).reshape(nb * bits, LANES)


def unpack_words_plain(words: torch.Tensor, bits: int) -> torch.Tensor:
    T = _check_bits(bits)
    nb = words.shape[0] // bits
    w = words.view(torch.int32).to(torch.int64) & _U32
    shifts = torch.arange(T, device=words.device) * bits
    u = (w.reshape(nb, bits, 1, LANES) >> shifts[None, None, :, None]) \
        & ((1 << bits) - 1)
    return u.to(torch.int32).reshape(nb * CODE_SUBLANES, LANES)


def pack_words(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(R, 128) int32 codes (R % 32 == 0) -> (R*b/32, 128) uint32 words.
    ONE launch on the card."""
    _check_bits(bits)
    if on_cpu(codes):
        return pack_words_plain(codes, bits)
    R = codes.shape[0]
    if codes.dim() != 2 or codes.shape[1] != LANES or R % CODE_SUBLANES:
        raise ValueError(f"codes: expected (R, {LANES}) with R % "
                         f"{CODE_SUBLANES} == 0, got {tuple(codes.shape)}")
    cuda_arg("codes", codes, torch.int32)
    out = torch.empty((R * bits // CODE_SUBLANES, LANES), dtype=torch.int32,
                      device=codes.device)
    if out.numel():
        _lib.launch("repro_pack_words", ptr(codes), ptr(out), out.numel(),
                    bits, stream(codes.device))
        LAUNCHES["pack_words"] += 1
    return out.view(torch.uint32)


def unpack_words(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Exact inverse of :func:`pack_words`: uint32 words -> int32 codes.
    ONE launch on the card."""
    _check_bits(bits)
    if on_cpu(words):
        return unpack_words_plain(words, bits)
    Rw = words.shape[0]
    if words.dim() != 2 or words.shape[1] != LANES or Rw % bits:
        raise ValueError(f"words: expected (R*{bits}/32, {LANES}), "
                         f"got {tuple(words.shape)}")
    cuda_arg("words", words, torch.uint32)
    out = torch.empty((Rw // bits * CODE_SUBLANES, LANES), dtype=torch.int32,
                      device=words.device)
    if words.numel():
        _lib.launch("repro_unpack_words", ptr(words), ptr(out),
                    words.numel(), bits, stream(words.device))
        LAUNCHES["unpack_words"] += 1
    return out


def pack_mask_bits(support: torch.Tensor) -> torch.Tensor:
    """(R, 128) 0/1 support -> (R/32, 128) uint32 bitmap words."""
    return pack_words(support.to(torch.int32), 1)


def unpack_mask_bits(words: torch.Tensor) -> torch.Tensor:
    """Bitmap words back to the (R, 128) int32 0/1 support."""
    return unpack_words(words, 1)
