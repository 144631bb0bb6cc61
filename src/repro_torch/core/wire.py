"""The uplink wire format: what a client's payload actually ships.

Counterpart of ``repro/core/wire.py``: the static layout math, every
scheme codec, and :func:`pack_bits_1d` / :func:`unpack_bits_1d`, the
per-shard bitmap of the multi-GPU transport (``core/aggregate.py``).  A
:class:`WirePayload` holds the transported arrays, uint32 bit-packed words
plus float32 value and scale streams, and :func:`payload_nbytes` is
measured from them, so ``uplink_bits == 8 * nbytes`` holds by
construction.

``mask_shared`` (FedAdam-SSM): ONE support bitmap (1 bit per aligned
parameter slot, packed by the ``wirepack`` kernel at b=1) and three
compacted float32 value streams of static capacity.  Every leaf is
zero-padded to 1024 elements and the buffer to 4096 (the (32, 128) row
group of the word packer).

``mask_independent`` (FedAdam-Top): three (bitmap, value stream) pairs,
each tensor's own support, each stream of the shared layout's capacity.

``sign`` (1-bit Adam): the plane ``x >= 0`` of the aligned carrier at b=1
and one float32 ``max|x|`` per 1024-slot block; exact for ``sign_quant``
carriers, which are two-valued per block.

``bbit`` (Efficient-Adam): the quantizer's codes packed at b in {2, 4, 8}
as ``code + qmax`` (layout padding encodes code 0) and its per-leaf
block scales.

``dense`` (FedAdam, FedSGD): one raveled float32 plane per tensor, no
padding.

The words, values and scales are byte-identical to the JAX package's for
the same carriers.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import quantize
from repro_torch.core import sparsify as S
from repro_torch import tree as T
from repro_torch.kernels.topk_mask.ref import overselect_bound
from repro_torch.kernels.wirepack.ops import (
    CODE_SUBLANES, LANES, SCALE_BLOCK, WORD_BITS, _to_uint32, pack_bbit,
    pack_mask_bits, pack_sign_scale, unpack_bbit, unpack_mask_bits,
    unpack_sign_scale)

_F32 = torch.float32

#: Elements per float32 scale block == the packed layout's padding quantum.
assert SCALE_BLOCK == S.PACK_BLOCK_ELEMS

#: Word-packer row-group granularity (32 rows x 128 lanes).
ALIGN_ELEMS = CODE_SUBLANES * LANES

#: All value/scale side streams ship as float32.
VALUE_BITS = 32


class WirePayload(NamedTuple):
    """A client's transported payload: uint32 ``words``, float32
    ``values`` and float32 ``scales``, each a tuple of tensors."""
    words: Tuple[torch.Tensor, ...]
    values: Tuple[torch.Tensor, ...]
    scales: Tuple[torch.Tensor, ...]


def payload_nbytes(payload: WirePayload) -> int:
    """Measured payload size in bytes, from the tensors' shapes/dtypes."""
    return sum(a.numel() * a.element_size() for part in payload for a in part)


# ---------------------------------------------------------------------------
# Static layout math (host ints)
# ---------------------------------------------------------------------------


def padded_total(sizes: Sequence[int]) -> int:
    """Packed-buffer elements: each leaf padded to SCALE_BLOCK."""
    return sum(-(-int(n) // SCALE_BLOCK) * SCALE_BLOCK for n in sizes)


def aligned_total(sizes: Sequence[int]) -> int:
    """:func:`padded_total` padded to the (32, 128) row-group quantum."""
    t = padded_total(sizes)
    return -(-t // ALIGN_ELEMS) * ALIGN_ELEMS


def mask_value_capacity(sizes: Sequence[int], alpha: float,
                        mask_scope: str = "per_tensor",
                        exact_topk: bool = True) -> int:
    """Static worst-case population of one top-k mask over leaves of
    ``sizes``: the capacity of each compacted value stream."""
    def cap_exact(n: int) -> int:
        if n <= S.BLOCK:
            return min(n, S.k_for(n, alpha))
        nb = -(-n // S.BLOCK)
        return min(n, nb * S.k_for(S.BLOCK, alpha))

    def cap_thresh(n: int) -> int:
        k = S.k_for(n, alpha)
        return min(n, k + overselect_bound(k, n))

    cap = cap_exact if exact_topk else cap_thresh
    if mask_scope == "per_tensor":
        return sum(cap(int(n)) for n in sizes)
    return cap(int(sum(int(n) for n in sizes)))


def mask_wire_bits(sizes: Sequence[int], alpha: float,
                   mask_scope: str = "per_tensor",
                   exact_topk: bool = True, *, shared: bool = True) -> int:
    """Wire bits of one client's mask payload: bitmap + 3 value streams
    (shared) or three (bitmap, stream) pairs (independent)."""
    t32 = aligned_total(sizes)
    cap = mask_value_capacity(sizes, alpha, mask_scope, exact_topk)
    if shared:
        return t32 + 3 * cap * VALUE_BITS
    return 3 * (t32 + cap * VALUE_BITS)


def sign_wire_bits(sizes: Sequence[int]) -> int:
    """1-bit Adam payload: sign bitplane + one scale per aligned block."""
    t32 = aligned_total(sizes)
    return t32 + VALUE_BITS * (t32 // SCALE_BLOCK)


def bbit_wire_bits(sizes: Sequence[int], bits: int) -> int:
    """Efficient-Adam payload: b bits per aligned slot + per-block scales."""
    t = padded_total(sizes)
    t32 = aligned_total(sizes)
    return bits * t32 + VALUE_BITS * (t // SCALE_BLOCK)


def dense_wire_bits(sizes: Sequence[int], n_tensors: int = 3) -> int:
    """Dense payload: raveled float32 planes, no padding."""
    return n_tensors * int(sum(int(n) for n in sizes)) * VALUE_BITS


# ---------------------------------------------------------------------------
# Aligned-buffer plumbing
# ---------------------------------------------------------------------------


def _pack_aligned(layout: S.PackedLayout, leaves) -> torch.Tensor:
    """Leaves -> the ALIGNED (R32, 128) buffer."""
    buf = layout.pack(leaves)
    rows = buf.shape[0]
    arows = -(-rows // CODE_SUBLANES) * CODE_SUBLANES
    if arows != rows:
        buf = torch.nn.functional.pad(buf, (0, 0, 0, arows - rows))
    return buf


def _unpack_aligned(layout: S.PackedLayout, buf, like_leaves) -> list:
    """Aligned buffer -> leaves cast to the template dtypes."""
    rows = layout.total // S.PACK_LANES
    leaves = layout.unpack(buf[:rows])
    return [x.to(t.dtype) for x, t in zip(leaves, like_leaves)]


def _compact(flat_support, pos, buf, capacity: int) -> torch.Tensor:
    """Gather the supported entries of ``buf`` into the first
    ``count <= capacity`` slots of a (capacity,) stream.  Slot
    ``capacity`` of the (capacity + 1) scratch is the drop slot for
    unsupported entries and for overflow past the capacity."""
    flat = buf.reshape(-1).to(_F32)
    idx = torch.where(flat_support & (pos < capacity), pos, capacity)
    out = torch.zeros((capacity + 1,), dtype=_F32, device=buf.device)
    out.scatter_(0, idx, flat)
    return out[:capacity]


def _expand(flat_support, pos, values, shape) -> torch.Tensor:
    """Inverse of :func:`_compact` (overflow slots decode to zero)."""
    cap = values.shape[0]
    taken = values[pos.clamp(0, cap - 1)]
    return torch.where(flat_support & (pos < cap), taken,
                       torch.zeros((), dtype=_F32, device=values.device)
                       ).reshape(shape)


def _support_positions(flat_support):
    """Rank of each supported slot in flat order (prefix sum - 1), in
    place on the one int64 buffer the sum needs."""
    return torch.cumsum(flat_support, 0, dtype=torch.int64).sub_(1)


def pack_bits_1d(bits) -> torch.Tensor:
    """(n,) bool/int bitmap -> (ceil(n/32),) uint32, bit ``i`` of word
    ``w`` = slot ``32 w + i`` (little-endian in the word, as the
    ``wirepack`` words).  Plain PyTorch on a vector of any length: the
    per-shard bitmap of the multi-GPU transport, whose leaves are 1-D and
    not (32, 128)-aligned, so the word kernel's lane-major layout does not
    apply (the JAX package's is plain jnp too)."""
    n = bits.shape[0]
    nw = -(-n // WORD_BITS)
    b = torch.nn.functional.pad(bits.to(torch.int64), (0, nw * WORD_BITS - n))
    shifts = torch.arange(WORD_BITS, device=b.device)
    return _to_uint32((b.reshape(nw, WORD_BITS) << shifts).sum(dim=1))


def unpack_bits_1d(words, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits_1d`: (nw,) uint32 -> (n,) int32 in
    {0, 1} (the word padding's tail cut off)."""
    shifts = torch.arange(WORD_BITS, device=words.device)
    w = words.view(torch.int32).to(torch.int64)
    return ((w[:, None] >> shifts) & 1).reshape(-1)[:n].to(torch.int32)


# ---------------------------------------------------------------------------
# Shared-mask codec
# ---------------------------------------------------------------------------


def pack_shared_mask(sW, sM, sV, capacity: int) -> WirePayload:
    """FedAdam-SSM wire: one bitmap of the UNION support of the three
    sparse carriers + three compacted value streams."""
    layout = S.plan_packed_layout(T.leaves(sW))
    # each tree's float32 copy lives only while its buffer is packed
    wp, mp, vp = (_pack_aligned(layout, [x.to(_F32) for x in T.leaves(t)])
                  for t in (sW, sM, sV))
    support = (wp != 0) | (mp != 0) | (vp != 0)
    words = pack_mask_bits(support)
    flat_sup = support.reshape(-1)
    pos = _support_positions(flat_sup)
    return WirePayload(
        words=(words,),
        values=(_compact(flat_sup, pos, wp, capacity),
                _compact(flat_sup, pos, mp, capacity),
                _compact(flat_sup, pos, vp, capacity)),
        scales=())


def unpack_shared_mask(payload: WirePayload, like):
    """Decode to the (sW, sM, sV) triple; ``like`` is any tree with the
    carrier's structure, shapes and dtypes."""
    leaves, td = T.flatten(like)
    layout = S.plan_packed_layout(leaves)
    support = unpack_mask_bits(payload.words[0])
    flat_sup = support.reshape(-1) == 1
    pos = _support_positions(flat_sup)
    return tuple(
        td.unflatten(_unpack_aligned(
            layout, _expand(flat_sup, pos, vals, support.shape), leaves))
        for vals in payload.values)


# ---------------------------------------------------------------------------
# Independent-mask codec
# ---------------------------------------------------------------------------


def _pack_own_support(tree, capacity: int):
    """One tree's bitmap words and compacted value stream.  Its float32
    staging and int64 positions are freed on return, before the next
    tree's are made."""
    leaves = T.leaves(tree)
    layout = S.plan_packed_layout(leaves)
    xp = _pack_aligned(layout, [x.to(_F32) for x in leaves])
    support = xp != 0
    words = pack_mask_bits(support)
    flat_sup = support.reshape(-1)
    return words, _compact(flat_sup, _support_positions(flat_sup), xp,
                           capacity)


def pack_independent_mask(sW, sM, sV, capacity: int) -> WirePayload:
    """FedAdam-Top wire: three (bitmap, value stream) pairs, each tensor's
    own support."""
    words, values = zip(*(_pack_own_support(t, capacity)
                          for t in (sW, sM, sV)))
    return WirePayload(words=tuple(words), values=tuple(values), scales=())


def _unpack_own_support(words, values, layout, leaves, td):
    support = unpack_mask_bits(words)
    flat_sup = support.reshape(-1) == 1
    buf = _expand(flat_sup, _support_positions(flat_sup), values,
                  support.shape)
    return td.unflatten(_unpack_aligned(layout, buf, leaves))


def unpack_independent_mask(payload: WirePayload, like):
    """Decode to the (sW, sM, sV) triple; ``like`` as for
    :func:`unpack_shared_mask`."""
    leaves, td = T.flatten(like)
    layout = S.plan_packed_layout(leaves)
    return tuple(_unpack_own_support(w, v, layout, leaves, td)
                 for w, v in zip(payload.words, payload.values))


# ---------------------------------------------------------------------------
# Sign, b-bit and dense codecs
# ---------------------------------------------------------------------------


def pack_sign(carrier) -> WirePayload:
    """1-bit Adam wire: the sign plane and per-block ``max|x|`` scales of
    the aligned carrier buffer (padding zeros never raise a max)."""
    leaves = [x.to(_F32) for x in T.leaves(carrier)]
    xp = _pack_aligned(S.plan_packed_layout(leaves), leaves)
    words, scales = pack_sign_scale(xp)
    return WirePayload(words=(words,), values=(), scales=(scales,))


def unpack_sign(payload: WirePayload, like):
    leaves, td = T.flatten(like)
    layout = S.plan_packed_layout(leaves)
    buf = unpack_sign_scale(payload.words[0], payload.scales[0])
    return td.unflatten(_unpack_aligned(layout, buf, leaves))


def pack_bbit_codes(codes_leaves, scales_leaves, bits: int) -> WirePayload:
    """Efficient-Adam wire: the int32 codes of every leaf word-packed at b
    bits in one launch, and the leaves' float32 scale streams."""
    layout = S.plan_packed_layout(codes_leaves)
    cp = _pack_aligned(layout, [c.to(torch.int32) for c in codes_leaves])
    return WirePayload(words=(pack_bbit(cp, bits),), values=(),
                       scales=tuple(s.to(_F32) for s in scales_leaves))


def unpack_bbit_codes(payload: WirePayload, like, bits: int):
    """Decode to the dequantized carrier tree (``uniform_decode`` of each
    leaf's codes with its shipped scales, cast to the leaf's dtype)."""
    leaves, td = T.flatten(like)
    layout = S.plan_packed_layout(leaves)
    cbuf = unpack_bbit(payload.words[0], bits)
    codes = layout.unpack(cbuf[:layout.total // S.PACK_LANES])
    return td.unflatten([
        quantize.uniform_decode(c, s, SCALE_BLOCK).to(t.dtype)
        for c, s, t in zip(codes, payload.scales, leaves)])


def _f32_plane(tree) -> torch.Tensor:
    """A tree's leaves raveled into one float32 plane, each leaf cast as
    it is copied into its slice (no float32 copy of a leaf is staged)."""
    leaves = T.leaves(tree)
    plane = torch.empty((sum(x.numel() for x in leaves),), dtype=_F32,
                        device=leaves[0].device)
    off = 0
    for x in leaves:
        plane[off:off + x.numel()].copy_(x.reshape(-1))
        off += x.numel()
    return plane


def pack_dense(trees: Sequence) -> WirePayload:
    """FedAdam/FedSGD wire: one raveled float32 plane per communicated
    tensor; its bytes equal the analytic count exactly."""
    return WirePayload(words=(), values=tuple(_f32_plane(t) for t in trees),
                       scales=())


def unpack_dense(payload: WirePayload, like):
    """Each plane back onto the ``like`` tree's structure and dtypes."""
    leaves, td = T.flatten(like)
    outs = []
    for plane in payload.values:
        rebuilt, off = [], 0
        for t in leaves:
            n = t.numel()
            rebuilt.append(plane[off:off + n].reshape(t.shape).to(t.dtype))
            off += n
        outs.append(td.unflatten(rebuilt))
    return tuple(outs)
