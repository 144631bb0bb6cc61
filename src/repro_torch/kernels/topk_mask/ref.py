"""Helpers and oracle of the threshold top-k selection: the candidate
rows, the over-selection contract and the pure-PyTorch selection.
Counterpart of ``repro/kernels/topk_mask/ref.py`` and
``repro/kernels/topk_mask/ops.py:overselect_bound``.  The selection passes
themselves (absmax, count_ge, select_tau) and the mask apply (apply_mask,
topk_mask) are in ``ops.py``.

Both candidate rows reproduce the JAX package's EAGER float32 arithmetic
bit for bit:

* ``log2_taus``: the 32 factors ``2**(-j/2)`` are built once on the host
  (Python double, rounded once to float32 -- what JAX computes), so a
  device ``pow`` never enters, and copied once per device (a copy per
  call would sync the stream);
* ``linear_taus``: ``hi - (hi - lo) * j / 31``, where ``/ 31`` divides by
  a tensor on the operands' device: PyTorch's CUDA division by a CPU
  scalar multiplies by its reciprocal instead, which is not the same
  float32 result.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import device_cache

N_BINS = 32

_LOG2_FACTORS = np.asarray([2.0 ** (-j / 2.0) for j in range(N_BINS)],
                           np.float32)


@device_cache(8)
def _log2_factors(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_LOG2_FACTORS).to(device)


def log2_taus(absmax: torch.Tensor) -> torch.Tensor:
    """Descending half-octave candidates ``absmax * 2**(-j/2)``.  ``absmax``
    of shape (...) gives (..., N_BINS)."""
    return absmax.to(torch.float32)[..., None] * _log2_factors(absmax.device)


def linear_taus(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """32 evenly spaced candidates from ``hi`` down to ``lo``.  ``lo``/``hi``
    of shape (...) give (..., N_BINS)."""
    j = torch.arange(N_BINS, dtype=torch.float32, device=hi.device)
    den = torch.full((N_BINS,), float(N_BINS - 1), dtype=torch.float32,
                     device=hi.device)
    return hi[..., None] - (hi - lo)[..., None] * j / den


def overselect_bound(k: int, n: int | None = None) -> int:
    """Contracted worst case of ``achieved_count - k`` for the two-level
    threshold selection: one linear refine bin of a half-octave bracket,
    bounded at 6% of k plus 8 for ties at tiny k (and never more than
    ``n - k``)."""
    bound = int(0.06 * k) + 8
    return min(bound, (n - k) if n is not None else bound)


def select_tau_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """The two-level selection in plain PyTorch over the whole leaf at
    once (``select_tau_ref`` of the JAX package): tau as a float32
    scalar."""
    a = x.reshape(-1).to(torch.float32).abs()
    am = a.max()
    taus1 = log2_taus(am)
    counts1 = (a[None, :] >= taus1[:, None]).sum(dim=1).to(torch.float32)
    idx = torch.argmax((counts1 >= k).to(torch.uint8))
    hi = torch.where(idx > 0, taus1[(idx - 1).clamp(min=0)], am)
    taus2 = linear_taus(taus1[idx], hi)
    counts2 = (a[None, :] >= taus2[:, None]).sum(dim=1).to(torch.float32)
    tau = taus2[torch.argmax((counts2 >= k).to(torch.uint8))]
    return torch.zeros_like(tau) if k >= a.numel() else tau


def topk_mask_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean ``|x| >= tau`` with :func:`select_tau_ref`'s tau."""
    return x.to(torch.float32).abs() >= select_tau_ref(x, k)
