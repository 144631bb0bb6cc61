"""Fused Adam update: one pass over w, g, m, v per leaf.

Counterpart of ``repro/kernels/fused_adam/{fused_adam,ops,ref}.py``.  On a
CUDA tensor :func:`fused_adam_apply` launches the kernel of
``csrc/fused_adam.cu`` (any length, float32 or bfloat16 leaves); on a CPU
tensor it runs :func:`fused_adam_plain`, the same float32 arithmetic op by
op.  Unlike the JAX wrapper there is no padding to (8, 1024) tiles and no
route to the oracle for leaves below one tile.

This is NOT the unfused ``optim/adam.py`` step: as in the Pallas kernel,
``1 - b1`` and ``1 - b2`` are float32 subtractions of the float32 scalars
(float32(1 - 0.9) is 0.100000024, where the unfused step folds 1 - 0.9 in
double to float32(0.1)), the root is ``rsqrt``, and weight decay is
ignored.
"""
from __future__ import annotations

import torch

from repro_torch.device import device_cache
from repro_torch.kernels import LAUNCHES, _lib, predict
from repro_torch.kernels._check import (cuda_arg, is_fake, leaf_dtype_code,
                                        on_cpu, ptr, stream)

_F32 = torch.float32


@device_cache(16)
def _constant_scalars(lr: float, b1: float, b2: float, eps: float,
                      device: torch.device) -> torch.Tensor:
    # one host-to-device copy per hyper-parameter set and device: a copy
    # per step would sync the stream
    return torch.tensor([lr, b1, b2, eps], dtype=_F32).to(device)


def effective_scalars(h, count: int, device: torch.device) -> torch.Tensor:
    """float32[4] ``[lr_eff, beta1, beta2, eps_eff]`` on ``device``, bias
    correction folded into lr and eps as ``_effective_scalars`` does:
    ``upd = m * sqrt(1-b2^t)/(1-b1^t) / sqrt(v + eps*(1-b2^t))``, with t
    and the powers in float32, computed on the device (no host sync)."""
    if not h.bias_correction:
        return _constant_scalars(h.lr, h.beta1, h.beta2, h.eps,
                                 torch.device(device))
    full = lambda x: torch.full((), x, dtype=_F32, device=device)
    t = full(float(count)) + 1.0
    b1, b2 = full(h.beta1), full(h.beta2)
    c2 = 1.0 - b2 ** t
    c1 = 1.0 - b1 ** t
    lr = full(h.lr) * torch.sqrt(c2) / c1
    eps = full(h.eps) * c2
    return torch.stack([lr, b1, b2, eps])


def fused_adam_plain(scalars, w, g, m, v):
    """The kernel's arithmetic in separate float32 PyTorch ops: returns
    ``(w', m', v')`` in the dtypes of w, m, v."""
    lr, b1, b2, eps = scalars.unbind()
    gf = g.to(_F32)
    mf = b1 * m.to(_F32) + (1.0 - b1) * gf
    vf = b2 * v.to(_F32) + (1.0 - b2) * gf * gf
    upd = mf * torch.rsqrt(vf + eps)
    w_new = (w.to(_F32) - lr * upd).to(w.dtype)
    return w_new, mf.to(m.dtype), vf.to(v.dtype)


def fused_adam_apply(scalars, w, g, m, v):
    """One leaf's update from the float32[4] scalars: the plain version on
    the CPU, ONE kernel launch on the card."""
    if on_cpu(w):
        return fused_adam_plain(scalars, w, g, m, v)
    code = leaf_dtype_code("w", w)
    dev = w.device
    cuda_arg("scalars", scalars, _F32, (4,), dev)
    for name, x in (("w", w), ("g", g), ("m", m), ("v", v)):
        cuda_arg(name, x, w.dtype, w.shape, dev, aligned=False)
    wo, mo, vo = (torch.empty_like(x) for x in (w, m, v))
    if is_fake(w):
        predict("fused_adam", (scalars, w, g, m, v), (wo, mo, vo))
        return wo, mo, vo
    _lib.launch("repro_fused_adam", ptr(scalars), ptr(w), ptr(g), ptr(m),
                ptr(v), ptr(wo), ptr(mo), ptr(vo), w.numel(), code,
                stream(dev))
    LAUNCHES["fused_adam"] += 1
    return wo, mo, vo
