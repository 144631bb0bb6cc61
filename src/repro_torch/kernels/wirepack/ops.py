"""Wire-format word packing: b-bit codes <-> uint32 words.

Counterpart of ``repro/kernels/wirepack/{wirepack,ops}.py``.  Layout: an
(R, 128) int32 code buffer with R % 32 == 0 and codes in [0, 2**b);
every (32, 128) block becomes b word rows,
``word[i*b + q, c] = sum_t code[i*32 + q*T + t, c] << (t*b)`` with
T = 32 / b, wrapping in uint32.  On a CUDA tensor the wrappers launch the
kernels of ``csrc/wirepack.cu``; on a CPU tensor they run the plain
versions below.

Scheme wrappers over the one word kernel pair, each ONE launch (the sign,
offset and scale arithmetic around it is elementwise PyTorch, as it is
jnp in the JAX package), with plain versions beside them as
``repro/kernels/wirepack/ref.py`` has:

* ``pack_mask_bits`` / ``unpack_mask_bits``: the b=1 support bitmap
  (FedAdam-SSM, FedAdam-Top);
* ``pack_sign_scale`` / ``unpack_sign_scale``: a b=1 plane of ``x >= 0``
  plus ``max|x|`` per 1024-slot block (1-bit Adam);
* ``pack_bbit`` / ``unpack_bbit``: codes in [-qmax, qmax] shipped as
  ``code + qmax`` at b in {2, 4, 8} (Efficient-Adam).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _lib, predict
from repro_torch.kernels._check import cuda_arg, is_fake, on_cpu, ptr, stream

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
    if out.numel() and is_fake(codes):
        predict("pack_words", (codes,), (out,))
    elif out.numel():
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
    if words.numel() and is_fake(words):
        predict("unpack_words", (words,), (out,))
    elif words.numel():
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


#: Slots per float32 scale of the sign plane (the quantizers' block).
SCALE_BLOCK = 1024


def _sign_scale(xp, pack):
    x = xp.to(torch.float32)
    scales = x.abs().reshape(-1, SCALE_BLOCK).amax(dim=1)
    return pack((x >= 0).to(torch.int32), 1), scales


def _from_sign_scale(bits, scales):
    # per (block, slot): the block's scale broadcasts, never materialised
    s = scales[:, None]
    return torch.where(bits.reshape(-1, SCALE_BLOCK) == 1, s, -s) \
        .reshape(bits.shape)


def pack_sign_scale(xp: torch.Tensor):
    """(R, 128) carrier -> ``(words, scales)``: (R/32, 128) uint32 words of
    the plane ``x >= 0`` and (R*128/1024,) float32 per-block ``max|x|``.
    ONE launch on the card."""
    return _sign_scale(xp, pack_words)


def pack_sign_scale_plain(xp: torch.Tensor):
    return _sign_scale(xp, pack_words_plain)


def unpack_sign_scale(words: torch.Tensor, scales: torch.Tensor):
    """Inverse of :func:`pack_sign_scale`: the two-valued float32 carrier
    ``where(bit, +scale, -scale)`` of shape (R, 128).  ONE launch."""
    return _from_sign_scale(unpack_words(words, 1), scales)


def unpack_sign_scale_plain(words: torch.Tensor, scales: torch.Tensor):
    return _from_sign_scale(unpack_words_plain(words, 1), scales)


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def pack_bbit(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(R, 128) int32 codes in [-qmax, qmax] -> (R*b/32, 128) uint32 words
    of the offset codes ``code + qmax``.  ONE launch on the card."""
    return pack_words(codes + _qmax(bits), bits)


def pack_bbit_plain(codes: torch.Tensor, bits: int) -> torch.Tensor:
    return pack_words_plain(codes + _qmax(bits), bits)


def unpack_bbit(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bbit`: int32 signed codes.  ONE launch."""
    return unpack_words(words, bits) - _qmax(bits)


def unpack_bbit_plain(words: torch.Tensor, bits: int) -> torch.Tensor:
    return unpack_words_plain(words, bits) - _qmax(bits)
