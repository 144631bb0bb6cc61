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
and the tile padding is that of the whole leaf, counted once, on the
group's index 0 (the rank at 0 along every axis that splits the leaf).
The kernels are the same.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _lib
from repro_torch.kernels._check import (cuda_arg, leaf_dtype_code, on_cpu,
                                        ptr, stream)
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
    st = stream(dev)
    out = torch.empty((), dtype=_F32, device=dev)
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
    st = stream(dev)
    out = torch.empty((N_BINS,), dtype=_F32, device=dev)
    _lib.launch("repro_count_ge", ptr(taus), ptr(x), _workspace(dev, st),
                ptr(out), x.numel(), pad, code, st)
    LAUNCHES["count_ge"] += 1
    return out


def _count_sum(counts: torch.Tensor, model) -> torch.Tensor:
    """Shard counts summed over the model group: float32 counts of a
    shard are exact integers, so their float64 sum is the whole leaf's
    count, rounded once to float32 as its kernel rounds it."""
    if model is None:
        return counts
    return model.all_reduce(counts.to(torch.float64)).to(_F32)


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
    if n is None:
        n = x.numel()
    pad = (-n) % _TILE if model is None or model.index == 0 else 0
    am = absmax(x)
    if model is not None:
        am = model.all_reduce(am, "max")
    taus1 = log2_taus(am)
    counts1 = _count_sum(count_ge(taus1, x, pad), model)
    idx = torch.argmax((counts1 >= k).to(torch.uint8))
    above = taus1.gather(0, (idx - 1).clamp(min=0).reshape(1))[0]
    hi = torch.where(idx > 0, above, am)
    lo = taus1.gather(0, idx.reshape(1))[0]
    taus2 = linear_taus(lo, hi)
    counts2 = _count_sum(count_ge(taus2, x, pad), model)
    idx2 = torch.argmax((counts2 >= k).to(torch.uint8)).reshape(1)
    tau = taus2.gather(0, idx2)[0]
    count = counts2.gather(0, idx2)[0]
    if k >= n:                          # degenerate: keep everything
        tau = torch.zeros_like(tau)
        count = torch.full_like(count, float(n))
    return tau, count


def apply_mask(tau: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Boolean ``|x| >= tau`` in x's shape, tau a float32 scalar on x's
    device: ONE launch on the card (one byte per element, as the TPU's
    int8 mask)."""
    if on_cpu(x):
        return apply_mask_plain(tau, x)
    code = _leaf_arg(x)
    cuda_arg("tau", tau, _F32, (), x.device, aligned=False)
    out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    _lib.launch("repro_apply_mask", ptr(tau), ptr(x), ptr(out), x.numel(),
                code, stream(x.device))
    LAUNCHES["apply_mask"] += 1
    return out


def topk_mask(x: torch.Tensor, k: int, *, model=None, n: int = None):
    """Threshold top-k mask of ``x`` (any shape) for ``k`` kept elements:
    ``(mask, tau, achieved_count)``, as ``topk_mask_kernel``.  Four
    launches on the card: :func:`select_tau`'s three, then
    :func:`apply_mask` (on this rank's shard of a split leaf: ``model``,
    ``n`` as :func:`select_tau`)."""
    tau, count = select_tau(x, k, model=model, n=n)
    return apply_mask(tau, x), tau, count
