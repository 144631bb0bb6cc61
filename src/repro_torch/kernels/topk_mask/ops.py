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


def absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """max |x| as a float32 scalar."""
    return x.reshape(-1).to(_F32).abs().max()


def count_ge_plain(taus: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32[32] counts of ``|x| >= taus[j]``."""
    a = x.reshape(-1).to(_F32).abs()
    out = torch.zeros((N_BINS,), dtype=torch.int64, device=x.device)
    for i in range(0, a.numel(), _PLAIN_CHUNK):
        out += (a[None, i:i + _PLAIN_CHUNK] >= taus[:, None]).sum(dim=1)
    return out.to(_F32)


def apply_mask_plain(tau: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Boolean ``|x| >= tau`` (float32 compare) in x's shape."""
    return x.to(_F32).abs() >= tau


def _leaf_arg(x: torch.Tensor) -> int:
    code = leaf_dtype_code("x", x)
    cuda_arg("x", x, x.dtype, aligned=False)
    return code


def absmax(x: torch.Tensor) -> torch.Tensor:
    """max |x| as a float32 scalar on x's device: ONE launch on the card."""
    if on_cpu(x):
        return absmax_plain(x)
    code = _leaf_arg(x)
    out = torch.zeros((1,), dtype=torch.int32, device=x.device)
    _lib.launch("repro_absmax", ptr(x), ptr(out), x.numel(), code,
                stream(x.device))
    LAUNCHES["absmax"] += 1
    return out.view(_F32)[0]


def count_ge(taus: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32[32] counts of ``|x| >= taus[j]``: ONE launch on the card
    (int32 counts, exact; converted to float32 as the TPU returns them)."""
    if on_cpu(x):
        return count_ge_plain(taus, x)
    code = _leaf_arg(x)
    cuda_arg("taus", taus, _F32, (N_BINS,), x.device)
    out = torch.zeros((N_BINS,), dtype=torch.int32, device=x.device)
    _lib.launch("repro_count_ge", ptr(taus), ptr(x), ptr(out), x.numel(),
                code, stream(x.device))
    LAUNCHES["count_ge"] += 1
    return out.to(_F32)


def select_tau(x: torch.Tensor, k: int):
    """Threshold selection over ``x`` (any shape) for ``k`` kept elements:
    ``(tau, achieved_count)``, float32 scalars on x's device.  Three
    launches on the card (absmax, two counts), as ``select_tau_kernel``.

    The achieved count covers x itself; the JAX wrapper counts its zero
    padding too, which differs only where tau is 0 (an all-zero leaf)."""
    n = x.numel()
    am = absmax(x)
    taus1 = log2_taus(am)
    counts1 = count_ge(taus1, x)
    idx = torch.argmax((counts1 >= k).to(torch.uint8))
    above = taus1.gather(0, (idx - 1).clamp(min=0).reshape(1))[0]
    hi = torch.where(idx > 0, above, am)
    lo = taus1.gather(0, idx.reshape(1))[0]
    taus2 = linear_taus(lo, hi)
    counts2 = count_ge(taus2, x)
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


def topk_mask(x: torch.Tensor, k: int):
    """Threshold top-k mask of ``x`` (any shape) for ``k`` kept elements:
    ``(mask, tau, achieved_count)``, as ``topk_mask_kernel``.  Four
    launches on the card: :func:`select_tau`'s three, then
    :func:`apply_mask`."""
    tau, count = select_tau(x, k)
    return apply_mask(tau, x), tau, count
