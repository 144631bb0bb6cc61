"""Host half of the packed selection: the refine candidates.

Counterpart of ``repro/kernels/packed_topk/ref.py:refine_taus``.  The JAX
package evaluates it as a per-segment loop of scalar eager ops; here the
segments are one batch of the same elementwise float32 operations (each
element sees the identical op sequence, so the rows are bitwise the
same), computed on the histogram's device with no host sync.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_mask.ref import linear_taus


def refine_taus(counts: torch.Tensor, edges: torch.Tensor,
                absmax: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """(L, 32) linear-refine candidates from the (L, 32) histogram.

    Per segment: ``idx`` = first bin with count >= k (0 when none); the
    bracket is ``[edges[idx], edges[idx-1]]`` (``absmax`` on top when
    idx == 0)."""
    idx = torch.argmax((counts >= ks[:, None]).to(torch.uint8), dim=1)
    lo = torch.gather(edges, 1, idx[:, None])[:, 0]
    above = torch.gather(edges, 1, (idx - 1).clamp(min=0)[:, None])[:, 0]
    hi = torch.where(idx > 0, above, absmax.to(torch.float32))
    return linear_taus(lo, hi)
