"""Top-k sparsification primitives (Definitions 1 and 2 of the paper).

Counterpart of ``repro/core/sparsify.py``.  Two mask constructions:

* ``topk_mask_exact``: the exact top-k indices.  Among equal magnitudes the
  lower index is kept, as ``lax.top_k`` keeps it: everything above the
  k-th magnitude, then the first of the elements equal to it by index
  (``torch.topk`` gives the k-th magnitude but does not say which of tied
  elements it keeps);
* ``topk_mask_threshold``: ``|x| >= tau`` with tau found by bisection, the
  plain reference of the threshold path.

Backend dispatch
----------------
:func:`resolve_backend` follows ``repro/core/sparsify.py:resolve_backend``:
config override, then the ``REPRO_TORCH_SPARSIFY_BACKEND`` environment
variable, then ``auto``, which picks ``kernel`` for CUDA tensors and
``reference`` for anything else.  ``kernel`` runs the PACKED pipeline
(:func:`tree_shared_compress_packed`): every leaf rides one (R, 128)
buffer and the whole cohort costs three launches on the card (histogram,
refine count, pick/apply).  On CPU tensors the same pipeline runs through
the kernels' plain versions, which is what the CPU tests hold against the
JAX package's kernel backend.  Mixed-dtype cohorts (a bfloat16 model with
float32 norm scales) and ``packed=False`` take the PER-LEAF fused path
(:func:`tree_shared_compress_fused`): for each leaf the selection passes of
``kernels/topk_mask`` (absmax, two counts) and one ``ssm_apply_ef`` pass.
FedAdam-Top's three independent masks take
:func:`tree_independent_compress_packed` on a uniform-dtype cohort (every
leaf of dW ++ dM ++ dV in one buffer, one tau segment per leaf and stream);
on a mixed-dtype tree they are threshold MASKS (``tree_topk_masks``), which
on the kernel backend run ``topk_mask`` per leaf: the selection passes and
the ``apply_mask`` kernel.

Leaves split over a model axis or the FSDP axes (:class:`LeafSplit`, the
tensor-parallel and the FSDP rounds) keep the per-tensor threshold of the
WHOLE leaf: ``k`` from its global size and the selection's counts reduced
over the group that holds its shards (``kernels/topk_mask/ops.select_tau``;
the bisection reference the same way).  They always take the per-leaf
path: the packed apply picks tau in its count's epilogue, where no
reduction fits.  Exact masks and the ``global`` scope raise there
(ROADMAP §1.10(a)).
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.kernels.packed_topk.ops import (
    BLOCK_ELEMS as PACK_BLOCK_ELEMS, LANES as PACK_LANES, packed_apply,
    packed_hist)
from repro_torch.kernels.packed_topk.ref import refine_taus
from repro_torch.kernels.ssm_apply.ops import ssm_apply_ef
from repro_torch.kernels.topk_mask.ops import select_tau, topk_mask
from repro_torch.kernels.topk_mask.ref import log2_taus

_F32 = torch.float32

#: Environment override for the port's sparsifier backend.  Its own name,
#: so that setting the JAX package's variable never flips the port.
SPARSIFY_BACKEND_ENV = "REPRO_TORCH_SPARSIFY_BACKEND"

_BACKENDS = ("auto", "kernel", "reference")


def resolve_backend(override: Optional[str] = None,
                    device: Optional[torch.device] = None) -> str:
    """``kernel`` | ``reference``.  Priority: explicit non-auto
    ``override`` > ``REPRO_TORCH_SPARSIFY_BACKEND`` > auto (CUDA ->
    kernel, anything else -> reference)."""
    choice = (override or "auto").lower()
    if choice == "auto":
        choice = os.environ.get(SPARSIFY_BACKEND_ENV, "auto").lower()
    if choice not in _BACKENDS:
        raise ValueError(f"sparsify backend {choice!r} not in {_BACKENDS}")
    if choice == "auto":
        dev = torch.device(device) if device is not None else None
        return "kernel" if dev is not None and dev.type == "cuda" \
            else "reference"
    return choice


def use_kernel_path(override: Optional[str] = None,
                    device: Optional[torch.device] = None) -> bool:
    return resolve_backend(override, device) == "kernel"


def k_for(n: int, alpha: float) -> int:
    """Number of kept elements for a tensor of n elements (>= 1)."""
    return max(1, int(round(alpha * n)))


@dataclasses.dataclass(frozen=True)
class LeafSplit:
    """How the leaves of a parameter-shaped tree lie on the mesh:
    ``groups`` per leaf (flatten order) the ``launch.mesh.ModelGroup``
    whose ranks hold its shards, one each (the model group, the FSDP
    data group, or the leaf group of every rank for a leaf split over
    both), or ``None`` for a leaf that is whole, and the same, on every
    rank.  A leaf split over the data axes alone is reduced over its
    data group only: the model ranks hold replicas of it."""
    groups: tuple

    def model(self, i: int):
        """Leaf ``i``'s group, or ``None`` for a whole leaf."""
        return self.groups[i]

    def numel(self, i: int, x: torch.Tensor) -> int:
        """Leaf ``i``'s whole size, ``x`` this rank's shard of it."""
        g = self.groups[i]
        return x.numel() * (1 if g is None else g.size)

    def sizes(self, tree) -> tuple:
        return tuple(self.numel(i, x) for i, x in enumerate(T.leaves(tree)))


def _whole_leaf_only(split, exact: bool, scope: str) -> None:
    if split is not None and (exact or scope != "per_tensor"):
        from repro_torch.launch.mesh import TENSOR_ITEM
        raise NotImplementedError(
            "on a model axis the masks are per-tensor threshold masks; "
            f"exact={exact}, scope={scope!r} are not ported: {TENSOR_ITEM}")


#: Leaves above BLOCK elements take exact top-k per BLOCK-sized tile.
BLOCK = 1 << 20


def _topk_rows(a: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of the k largest entries of each row of ``a`` (last
    dim), the lower index first among equal values: ``lax.top_k``'s set.
    Everything above the k-th value t, then the first ``k - count(a > t)``
    elements equal to t by index (a running count of the ties).  The
    comparisons are made again rather than held, so that beside ``a`` at
    most one int32 plane and one bool plane are alive."""
    t = torch.topk(a, k, dim=-1, sorted=False).values.amin(dim=-1,
                                                            keepdim=True)
    need = k - (a > t).sum(dim=-1, keepdim=True, dtype=torch.int32)
    first = (a == t).to(torch.int32).cumsum_(dim=-1) <= need
    return (a > t) | ((a == t) & first)


def blocked_topk_mask(x: torch.Tensor, alpha: float,
                      block: int = BLOCK) -> torch.Tensor:
    """Exact top-k within each BLOCK-sized tile of flat x.  The last tile
    is zero-padded, as JAX pads it, so padding slots tie with the leaf's
    zeros and lose to them by index."""
    flat = x.reshape(-1)
    n = flat.numel()
    nb = -(-n // block)
    a = torch.nn.functional.pad(flat, (0, nb * block - n)).abs() \
        .reshape(nb, block)
    mask = _topk_rows(a, k_for(block, alpha))
    return mask.reshape(-1)[:n].reshape(x.shape)


def topk_mask_exact(x: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of the k largest-|.| elements of x (ties: lower index
    kept)."""
    return _topk_rows(x.reshape(-1).abs(), k).reshape(x.shape)


def topk_mask_threshold(x: torch.Tensor, k: int, iters: int = 24, *,
                        model=None) -> torch.Tensor:
    """Bisection threshold mask (ties may push the count above k): tau in
    [0, max|x|] with count(|x| >= tau) ~ k.  ``model``: the group of a
    leaf split over a model axis, ``x`` this rank's shard: the max and
    each count are reduced over it (the counts as exact float64 sums), so
    tau is the whole leaf's."""
    a = x.abs().to(_F32)
    hi = a.max()
    lo = torch.zeros((), dtype=_F32, device=x.device)
    kf = torch.full((), float(k), dtype=_F32, device=x.device)
    if model is None:
        count = lambda t: (a >= t).to(_F32).sum()
    else:
        hi = model.all_reduce(hi, "max")
        count = lambda t: model.all_reduce(
            (a >= t).sum(dtype=torch.float64)).to(_F32)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        more = count(mid) > kf
        lo, hi = torch.where(more, mid, lo), torch.where(more, hi, mid)
    tau = torch.where(count(lo) >= kf, lo, hi)
    return a >= tau


def sparsify(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Top_k(x) = x . mask (Definition 1)."""
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


# ---------------------------------------------------------------------------
# Tree-level helpers
# ---------------------------------------------------------------------------


def _unravel_bool(mask_flat, like_tree):
    leaves, td = T.flatten(like_tree)
    out, off = [], 0
    for leaf in leaves:
        n = leaf.numel()
        out.append(mask_flat[off:off + n].reshape(leaf.shape))
        off += n
    return td.unflatten(out)


def tree_topk_masks(score_tree, alpha: float, scope: str = "per_tensor",
                    exact: bool = True, backend: Optional[str] = None,
                    split: Optional[LeafSplit] = None):
    """Boolean mask tree keeping ~alpha of the elements of score_tree by
    magnitude, per tensor or over the whole flattened model.  Threshold
    masks (``exact=False``) run :func:`topk_mask` on the kernel backend and
    the bisection reference elsewhere.  ``split``: leaves split over a
    model axis, each masked with its whole leaf's threshold."""
    def mk(s, k, model=None, n=None):
        if not exact:
            if use_kernel_path(backend, s.device):
                return (topk_mask(s, k) if model is None else
                        topk_mask(s, k, model=model, n=n))[0]
            return topk_mask_threshold(s, k) if model is None else \
                topk_mask_threshold(s, k, model=model)
        if s.numel() > BLOCK:
            return blocked_topk_mask(s, alpha)
        return topk_mask_exact(s, k)

    _whole_leaf_only(split, exact, scope)
    if split is not None:
        leaves, td = T.flatten(score_tree)
        out = []
        for i, s in enumerate(leaves):
            n = split.numel(i, s)
            out.append(mk(s, k_for(n, alpha), split.model(i), n))
        return td.unflatten(out)
    if scope == "per_tensor":
        return T.tree_map(lambda s: mk(s, k_for(s.numel(), alpha)),
                          score_tree)
    flat = torch.cat([x.reshape(-1) for x in T.leaves(score_tree)])
    return _unravel_bool(mk(flat, k_for(flat.numel(), alpha)), score_tree)


def tree_sparsify(tree, masks):
    return T.tree_map(sparsify, tree, masks)


def _root_of_sums(sq_leaves, split: Optional[LeafSplit]):
    """sqrt of the leaves' sums of squares added in leaf order; a split
    leaf's sum is its shards' over its group (one all-reduce per group,
    in the order the groups first hold a leaf)."""
    sq = list(sq_leaves)
    by_group = {}
    for i, g in enumerate(() if split is None else split.groups):
        if g is not None:
            by_group.setdefault(g, []).append(i)
    for g, idx in by_group.items():
        red = g.all_reduce(torch.stack([sq[i] for i in idx]))
        for j, i in enumerate(idx):
            sq[i] = red[j]
    return torch.sqrt(sum(sq))


def tree_sparsity_error(tree, masks, split: Optional[LeafSplit] = None):
    """|| (1 - mask) . x ||_2 over the whole tree (Theorem 1 terms)."""
    sq = T.tree_map(
        lambda x, m: (torch.where(m, 0.0, x.to(_F32)) ** 2).sum(), tree,
        masks)
    return _root_of_sums(T.leaves(sq), split)


def tree_norm(tree, split: Optional[LeafSplit] = None):
    sq = T.tree_map(lambda x: (x.to(_F32) ** 2).sum(), tree)
    return _root_of_sums(T.leaves(sq), split)


# ---------------------------------------------------------------------------
# Packed cohort layout: every leaf through ONE buffer
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _device_constants(padded: tuple, seg_of_leaf: tuple, seg_sizes: tuple,
                      alpha: Optional[float], device: torch.device):
    """seg_ids, and ks/ns for ``alpha``, built once per layout and device
    (a fresh host-to-device copy per client would sync the stream)."""
    seg_ids = torch.from_numpy(np.concatenate(
        [np.full(p // PACK_BLOCK_ELEMS, g, np.int32)
         for p, g in zip(padded, seg_of_leaf)])).to(device)
    if alpha is None:
        return seg_ids
    ks = torch.tensor([float(k_for(n, alpha)) for n in seg_sizes],
                      dtype=_F32, device=device)
    ns = torch.tensor([float(n) for n in seg_sizes], dtype=_F32,
                      device=device)
    return ks, ns


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Static descriptor of a multi-leaf packed buffer.

    Every leaf is flattened and zero-padded to a multiple of one (8, 128)
    block (1024 elements); the leaves are concatenated into one (R, 128)
    buffer.  ``seg_of_leaf`` maps each leaf to its tau segment;
    ``seg_ids`` maps each block to its segment."""

    shapes: tuple
    sizes: tuple
    padded: tuple
    offsets: tuple
    seg_of_leaf: tuple
    num_segments: int
    seg_sizes: tuple
    device: torch.device = dataclasses.field(compare=False)

    @property
    def num_leaves(self) -> int:
        return len(self.sizes)

    @property
    def total(self) -> int:
        return sum(self.padded)

    @property
    def num_blocks(self) -> int:
        return self.total // PACK_BLOCK_ELEMS

    @property
    def seg_ids(self) -> torch.Tensor:
        return _device_constants(self.padded, self.seg_of_leaf,
                                 self.seg_sizes, None, self.device)

    def ks_ns(self, alpha: float):
        """(L,) float32 kept counts and true element counts per segment."""
        return _device_constants(self.padded, self.seg_of_leaf,
                                 self.seg_sizes, float(alpha), self.device)

    def pack(self, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
        """Flatten + pad + concatenate into the (R, 128) buffer."""
        dtype = leaves[0].dtype
        buf = torch.zeros((self.total,), dtype=dtype, device=self.device)
        for leaf, off, n in zip(leaves, self.offsets, self.sizes):
            buf[off:off + n] = leaf.reshape(-1).to(dtype)
        return buf.reshape(-1, PACK_LANES)

    def unpack(self, buf: torch.Tensor) -> list:
        """Shape-only inverse of :meth:`pack` (padding discarded)."""
        flat = buf.reshape(-1)
        return [flat[off:off + n].reshape(shape) for off, n, shape
                in zip(self.offsets, self.sizes, self.shapes)]


def plan_packed_layout(leaves, groups: Optional[Sequence[int]] = None
                       ) -> PackedLayout:
    """The :class:`PackedLayout` of a list of leaves.  ``groups`` assigns
    each leaf to a tau segment (default: one segment per leaf)."""
    shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    sizes = tuple(int(leaf.numel()) for leaf in leaves)
    padded = tuple(-(-n // PACK_BLOCK_ELEMS) * PACK_BLOCK_ELEMS
                   for n in sizes)
    offsets, off = [], 0
    for p in padded:
        offsets.append(off)
        off += p
    if groups is None:
        groups = range(len(sizes))
    seg_of_leaf = tuple(int(g) for g in groups)
    num_segments = max(seg_of_leaf) + 1
    seg_sizes = [0] * num_segments
    for n, g in zip(sizes, seg_of_leaf):
        seg_sizes[g] += n
    return PackedLayout(shapes=shapes, sizes=sizes, padded=padded,
                        offsets=tuple(offsets), seg_of_leaf=seg_of_leaf,
                        num_segments=num_segments,
                        seg_sizes=tuple(seg_sizes),
                        device=leaves[0].device)


def _segment_absmax(layout: PackedLayout, score_leaves) -> torch.Tensor:
    """(L,) float32 max|x| per segment (max is exact, so the reduce over a
    segment's leaves equals the raveled max)."""
    out = [None] * layout.num_segments
    for leaf, g in zip(score_leaves, layout.seg_of_leaf):
        am = leaf.to(_F32).abs().max()
        out[g] = am if out[g] is None else torch.maximum(out[g], am)
    return torch.stack(out)


def _packed_select_inputs(layout: PackedLayout, score_leaves, score_p,
                          alpha: float):
    """Launch 1 (histogram) + the refine candidates.  Returns the apply
    operands (taus2, ks, ns)."""
    ks, ns = layout.ks_ns(alpha)
    absmax = _segment_absmax(layout, score_leaves)
    edges = log2_taus(absmax)
    c1 = packed_hist(score_p, layout.seg_ids, edges)
    return refine_taus(c1, edges, absmax, ks), ks, ns


def _leaf_masks(layout: PackedLayout, score_leaves, taus):
    """Boolean masks per leaf, recomputed from tau (diagnostics only)."""
    return [leaf.to(_F32).abs() >= taus[g]
            for leaf, g in zip(score_leaves, layout.seg_of_leaf)]


def _uniform_dtype(*trees) -> bool:
    return len({leaf.dtype for t in trees if t is not None
                for leaf in T.leaves(t)}) == 1


def tree_shared_compress_packed(score_tree, dW, dM, dV, alpha: float,
                                scope: str = "per_tensor", *,
                                value_dtype=None,
                                with_residual: bool = False):
    """Packed shared-mask compress: every leaf of (score, dW, dM, dV) rides
    one buffer; the segmented histogram, the refine candidates and the
    fused count/pick/apply give the masked triple, the optional
    ``value_dtype`` round-trip and the EF residual.  Returns
    ``(sW, sM, sV, err_tree | None, mask_tree)``."""
    w_leaves, td = T.flatten(dW)
    m_leaves = T.leaves(dM)
    v_leaves = T.leaves(dV)
    s_leaves = None if score_tree is None else T.leaves(score_tree)
    groups = None if scope == "per_tensor" else [0] * len(w_leaves)
    layout = plan_packed_layout(w_leaves, groups)

    wp = layout.pack(w_leaves)
    mp = layout.pack(m_leaves)
    vp = layout.pack(v_leaves)
    sp = None if s_leaves is None else layout.pack(s_leaves)
    score_leaves = w_leaves if s_leaves is None else s_leaves

    taus2, ks, ns = _packed_select_inputs(
        layout, score_leaves, wp if sp is None else sp, alpha)
    outs = packed_apply(taus2, layout.seg_ids, ks, ns, (wp, mp, vp), sp,
                        with_residual=with_residual, value_dtype=value_dtype)
    taus = outs[-2][:, 0]
    unflat = lambda buf: td.unflatten(layout.unpack(buf))
    err_tree = unflat(outs[3]) if with_residual else None
    mask_tree = td.unflatten(_leaf_masks(layout, score_leaves, taus))
    return unflat(outs[0]), unflat(outs[1]), unflat(outs[2]), err_tree, \
        mask_tree


def tree_independent_compress_packed(dW, dM, dV, alpha: float,
                                     scope: str = "per_tensor", *,
                                     value_dtype=None,
                                     with_residual: bool = False):
    """Packed compress of FedAdam-Top's three masks: every leaf of dW ++ dM
    ++ dV rides one buffer, each stream's leaves in tau segments of their
    own (3L segments for "per_tensor", 3 for "global"), and each segment's
    score is the stream itself, so the three selections cost the launches
    of one.  Returns ``(sW, sM, sV, err_tree | None, (mW, mM, mV))``; the
    residual is dW's (the M and V rows of the kernel's residual are
    dropped, as in the composed path)."""
    w_leaves, td = T.flatten(dW)
    leaves = w_leaves + T.leaves(dM) + T.leaves(dV)
    L = len(w_leaves)
    groups = (list(range(3 * L)) if scope == "per_tensor"
              else [0] * L + [1] * L + [2] * L)
    layout = plan_packed_layout(leaves, groups)

    xp = layout.pack(leaves)
    taus2, ks, ns = _packed_select_inputs(layout, leaves, xp, alpha)
    outs = packed_apply(taus2, layout.seg_ids, ks, ns, (xp,),
                        with_residual=with_residual, value_dtype=value_dtype)
    taus = outs[-2][:, 0]
    thirds = lambda ls: tuple(td.unflatten(ls[i * L:(i + 1) * L])
                              for i in range(3))
    sW, sM, sV = thirds(layout.unpack(outs[0]))
    err_tree = (td.unflatten(layout.unpack(outs[1])[:L])
                if with_residual else None)
    return sW, sM, sV, err_tree, thirds(_leaf_masks(layout, leaves, taus))


def _fused_leaf(score, w, m, v, k: int, value_dtype, with_residual: bool,
                model=None, n: Optional[int] = None):
    """One leaf of the fused compress: the selection passes on the score
    (``w`` when ``score`` is None), then ONE apply/cast/residual pass.
    Returns ``(sw, sm, sv, err | None, mask)``; the mask is recomputed
    from tau for the diagnostics only.  ``model``, ``n``: a shard of a
    leaf split over a model axis (``select_tau``)."""
    s = w if score is None else score
    tau, _ = select_tau(s, k) if model is None else \
        select_tau(s, k, model=model, n=n)
    outs = ssm_apply_ef(tau, w, m, v, score, with_residual=with_residual,
                        value_dtype=value_dtype)
    err = outs[3] if with_residual else None
    return outs[0], outs[1], outs[2], err, s.to(_F32).abs() >= tau


def _ravel(tree):
    """Flat concatenation of the leaves in their common dtype (as
    ``jax.flatten_util.ravel_pytree`` promotes), and its inverse, which
    casts each piece back to its leaf's dtype."""
    leaves, td = T.flatten(tree)
    dtype = functools.reduce(torch.promote_types,
                             [x.dtype for x in leaves])
    flat = torch.cat([x.reshape(-1).to(dtype) for x in leaves])

    def unravel(buf):
        out, off = [], 0
        for x in leaves:
            out.append(buf[off:off + x.numel()].reshape(x.shape)
                       .to(x.dtype))
            off += x.numel()
        return td.unflatten(out)

    return flat, unravel


def tree_shared_compress_fused(score_tree, dW, dM, dV, alpha: float,
                               scope: str = "per_tensor", *,
                               value_dtype=None,
                               with_residual: bool = False,
                               packed: bool = True,
                               split: Optional[LeafSplit] = None):
    """Kernel-path shared-mask compress.  Uniform-dtype cohorts take the
    packed path (``packed=True``); mixed-dtype trees and ``packed=False``
    take the per-leaf loop: for each leaf (or the raveled model when
    ``scope == "global"``) :func:`_fused_leaf`.  ``score_tree=None`` means
    the scores are dW (the ssm_w rule).  ``split``: leaves split over a
    model axis, always per leaf, with their whole leaves' thresholds.
    Returns ``(sW, sM, sV, err_tree | None, mask_tree)``; given the same
    tau the arithmetic is that of the composed reference ops."""
    _whole_leaf_only(split, False, scope)
    if packed and split is None and _uniform_dtype(score_tree, dW, dM, dV):
        return tree_shared_compress_packed(
            score_tree, dW, dM, dV, alpha, scope,
            value_dtype=value_dtype, with_residual=with_residual)
    if scope == "global":
        flat_w, unravel = _ravel(dW)
        flat_m, _ = _ravel(dM)
        flat_v, _ = _ravel(dV)
        flat_s = None if score_tree is None else _ravel(score_tree)[0]
        sw, sm, sv, err, mask = _fused_leaf(
            flat_s, flat_w, flat_m, flat_v, k_for(flat_w.numel(), alpha),
            value_dtype, with_residual)
        return (unravel(sw), unravel(sm), unravel(sv),
                None if err is None else unravel(err),
                _unravel_bool(mask, dW))
    w_leaves, td = T.flatten(dW)
    s_leaves = ([None] * len(w_leaves) if score_tree is None
                else T.leaves(score_tree))
    outs = []
    for i, (s, w, m, v) in enumerate(zip(s_leaves, w_leaves, T.leaves(dM),
                                         T.leaves(dV))):
        n = w.numel() if split is None else split.numel(i, w)
        outs.append(_fused_leaf(s, w, m, v, k_for(n, alpha), value_dtype,
                                with_residual,
                                None if split is None else split.model(i),
                                n))
    unflat = lambda i: td.unflatten([o[i] for o in outs])
    return (unflat(0), unflat(1), unflat(2),
            unflat(3) if with_residual else None, unflat(4))
