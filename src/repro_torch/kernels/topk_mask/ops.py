"""Per-leaf threshold top-k selection: absmax -> log2 count -> linear
refine count -> tau, and the mask apply ``|x| >= tau``.

Counterpart of ``repro/kernels/topk_mask/{topk_mask,ops}.py``.  On a CUDA
tensor the passes launch the kernels of ``csrc/topk_mask.cu`` (``absmax``,
``count_ge`` and ``apply_mask``, float32 or bfloat16 leaves of any length);
on a CPU tensor they run the plain versions below.  :func:`select_tau`
keeps every step on the leaf's device (the picks are ``argmax`` and
gathers, never ``.item()``), so a client's compress never waits on the
host.  :func:`select_tau` alone feeds the fused compress
(``kernels/ssm_apply/ops.py``); :func:`topk_mask` adds the apply and
gives the boolean mask, as ``topk_mask_kernel`` does.

A leaf split over a model axis or the FSDP axes (``model``, the
``launch.mesh.ModelGroup`` whose ranks hold its shards: the model group,
the data group, or the leaf group of every rank) is selected as the whole
leaf: each pass runs its kernel on this rank's shard, then the group
reduces the result before the next step reads it (the absmax by MAX, each
count by a SUM in float64, exact where the float32 count of a shard is),
and the tile padding is that of the whole leaf, counted once after the
sum: :func:`select_tau_leaves` with one leaf.  The kernels are the
same.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _lib, predict
from repro_torch.kernels._check import (cuda_arg, is_fake, leaf_dtype_code,
                                        on_cpu, ptr, stream)
from repro_torch.kernels.topk_mask.ref import N_BINS, linear_taus, log2_taus

_F32 = torch.float32

#: Elements per chunk of the plain count: bounds its (32, chunk) compare.
_PLAIN_CHUNK = 1 << 20
#: Elements of one TPU tile, (8, 1024): the JAX wrapper pads a leaf to a
#: whole number of them.
_TILE = 8 * 1024


def absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """max |x| as a float32 scalar."""
    return x.reshape(-1).to(_F32).abs().max()


def count_ge_plain(taus: torch.Tensor, x: torch.Tensor,
                   pad: int = 0) -> torch.Tensor:
    """float32[32] counts of ``|x| >= taus[j]`` over x and ``pad`` zeros
    after it."""
    a = x.reshape(-1).to(_F32).abs()
    out = torch.zeros((N_BINS,), dtype=torch.int64, device=x.device)
    for i in range(0, a.numel(), _PLAIN_CHUNK):
        out += (a[None, i:i + _PLAIN_CHUNK] >= taus[:, None]).sum(dim=1)
    return (out + pad * (taus <= 0)).to(_F32)


def apply_mask_plain(tau: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Boolean ``|x| >= tau`` (float32 compare) in x's shape."""
    return x.to(_F32).abs() >= tau


def _leaf_arg(x: torch.Tensor) -> int:
    code = leaf_dtype_code("x", x)
    cuda_arg("x", x, x.dtype, aligned=False)
    return code


#: One int32 workspace per (device, stream) for absmax and count_ge,
#: zeroed once when it is made: every launch leaves it zero again, and two
#: streams never share one.
_workspaces: dict = {}


def _workspace(device: torch.device, st: int) -> int:
    """The address of the workspace of ``device`` and stream ``st``."""
    ws = _workspaces.get((device, st))
    if ws is None:
        ws = _workspaces[(device, st)] = torch.zeros(
            (_lib.call("repro_topk_workspace_words"),), dtype=torch.int32,
            device=device)
    return ws.data_ptr()


def absmax(x: torch.Tensor) -> torch.Tensor:
    """max |x| as a float32 scalar on x's device: ONE launch on the card."""
    if on_cpu(x):
        return absmax_plain(x)
    code = _leaf_arg(x)
    dev = x.device
    out = torch.empty((), dtype=_F32, device=dev)
    if is_fake(x):
        predict("absmax", (x,), (out,))
        return out
    st = stream(dev)
    _lib.launch("repro_absmax", ptr(x), _workspace(dev, st), ptr(out),
                x.numel(), code, st)
    LAUNCHES["absmax"] += 1
    return out


def count_ge(taus: torch.Tensor, x: torch.Tensor,
             pad: int = 0) -> torch.Tensor:
    """float32[32] counts of ``|x| >= taus[j]`` over x and ``pad`` zeros
    after it (the zero padding of the TPU's tiles): ONE launch on the card
    (int32 counts, exact; written as float32 as the TPU returns them)."""
    if on_cpu(x):
        return count_ge_plain(taus, x, pad)
    code = _leaf_arg(x)
    dev = x.device
    cuda_arg("taus", taus, _F32, (N_BINS,), dev)
    out = torch.empty((N_BINS,), dtype=_F32, device=dev)
    if is_fake(x):
        predict("count_ge", (taus, x), (out,))
        return out
    st = stream(dev)
    _lib.launch("repro_count_ge", ptr(taus), ptr(x), _workspace(dev, st),
                ptr(out), x.numel(), pad, code, st)
    LAUNCHES["count_ge"] += 1
    return out


def _two_passes(k: int, n: int, am: torch.Tensor, count):
    """The log2 pass and the linear refine from the absmax ``am`` and
    ``count(taus) -> float32[32]``: ``(tau, achieved_count)``."""
    taus1 = log2_taus(am)
    counts1 = count(taus1)
    idx = torch.argmax((counts1 >= k).to(torch.uint8))
    above = taus1.gather(0, (idx - 1).clamp(min=0).reshape(1))[0]
    hi = torch.where(idx > 0, above, am)
    lo = taus1.gather(0, idx.reshape(1))[0]
    taus2 = linear_taus(lo, hi)
    counts2 = count(taus2)
    idx2 = torch.argmax((counts2 >= k).to(torch.uint8)).reshape(1)
    tau = taus2.gather(0, idx2)[0]
    count = counts2.gather(0, idx2)[0]
    if k >= n:                          # degenerate: keep everything
        tau = torch.zeros_like(tau)
        count = torch.full_like(count, float(n))
    return tau, count


def select_tau(x: torch.Tensor, k: int, *, model=None, n: int = None):
    """Threshold selection over ``x`` (any shape) for ``k`` kept elements:
    ``(tau, achieved_count)``, float32 scalars on x's device.  Three
    launches on the card (absmax, two counts), as ``select_tau_kernel``.

    ``model``: the group whose ranks hold a split leaf's shards, ``x``
    this rank's shard and ``n`` the whole leaf's size; tau and the count
    are then the whole leaf's, on every rank (the module docstring).

    The counts take in the zero padding the JAX wrapper adds up to a whole
    8192-element tile, as its kernels count it: the padding counts at every
    candidate <= 0 and nowhere else, so the picks are the leaf's own and
    the achieved count equals JAX's, which includes the padding where tau
    comes out 0 (an all-zero leaf, or a subnormal absmax whose candidates
    underflow)."""
    if model is not None:
        return select_tau_leaves([x], k, [model], n)
    n = x.numel()
    return _two_passes(k, n, absmax(x),
                       lambda taus: count_ge(taus, x, (-n) % _TILE))


def reduce_leaves(vals, groups, op: str = "sum") -> list:
    """``vals`` (one tensor per leaf, all of one shape) with each split
    leaf's value reduced (``op``) over its group (``groups`` per leaf,
    ``None`` for a whole leaf): one all-reduce per group, in the order the
    groups first hold a leaf, of that group's values stacked."""
    vals = list(vals)
    by_group = {}
    for i, g in enumerate(groups):
        if g is not None:
            by_group.setdefault(g, []).append(i)
    for g, idx in by_group.items():
        red = g.all_reduce(torch.stack([vals[i] for i in idx]), op)
        for j, i in enumerate(idx):
            vals[i] = red[j]
    return vals


def select_tau_leaves(xs, k: int, groups, n: int):
    """:func:`select_tau` over the tensors ``xs`` raveled into one of
    ``n`` elements, ``groups[i]`` the group whose ranks hold the shards of
    ``xs[i]`` (``None``: a whole tensor, the same on every rank): the
    ``global`` mask scope over split leaves.  Each pass launches its
    kernel on every tensor; the absmaxes are reduced by MAX and the counts
    by a float64 SUM within each group (one all-reduce per group and
    pass), then over the groups and the whole tensors, so tau and the
    count are the raveled whole model's (its tile padding counted once):
    float32 counts of a shard are exact integers, so their float64 sum
    is the whole count, rounded once to float32 as its kernel rounds
    it.
    ``3 * len(xs)`` launches on the card."""
    pad = (-n) % _TILE
    am = torch.stack(reduce_leaves([absmax(x) for x in xs], groups,
                                   "max")).max()

    def count(taus):
        total = torch.stack(reduce_leaves(
            [count_ge(taus, x).to(torch.float64) for x in xs], groups)) \
            .sum(dim=0)
        return (total + pad * (taus <= 0)).to(_F32)

    return _two_passes(k, n, am, count)


def apply_mask(tau: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Boolean ``|x| >= tau`` in x's shape, tau a float32 scalar on x's
    device: ONE launch on the card (one byte per element, as the TPU's
    int8 mask)."""
    if on_cpu(x):
        return apply_mask_plain(tau, x)
    code = _leaf_arg(x)
    cuda_arg("tau", tau, _F32, (), x.device, aligned=False)
    out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    if is_fake(x):
        predict("apply_mask", (tau, x), (out,))
        return out
    _lib.launch("repro_apply_mask", ptr(tau), ptr(x), ptr(out), x.numel(),
                code, stream(x.device))
    LAUNCHES["apply_mask"] += 1
    return out


def topk_mask_leaves(xs, k: int, groups, n: int):
    """Threshold top-k masks of the tensors ``xs`` raveled into one
    (:func:`select_tau_leaves`'s arguments): ``(masks, tau,
    achieved_count)``, one :func:`apply_mask` launch a tensor."""
    tau, count = select_tau_leaves(xs, k, groups, n)
    return [apply_mask(tau, x) for x in xs], tau, count


def topk_mask(x: torch.Tensor, k: int, *, model=None, n: int = None):
    """Threshold top-k mask of ``x`` (any shape) for ``k`` kept elements:
    ``(mask, tau, achieved_count)``, as ``topk_mask_kernel``.  Four
    launches on the card: :func:`select_tau`'s three, then
    :func:`apply_mask` (on this rank's shard of a split leaf: ``model``,
    ``n`` as :func:`select_tau`)."""
    tau, count = select_tau(x, k, model=model, n=n)
    return apply_mask(tau, x), tau, count
