"""Tree-native Adam, the paper's local update rule (Eqs. 3-5).

Counterpart of ``repro/optim/adam.py``: Adam WITHOUT bias correction by
default (the moments are aggregated across clients every round).

The hyper-parameters enter as Python floats, exactly as in the JAX
package: ``beta1 * m`` multiplies by float32(beta1), and ``(1 - beta1)``
is formed in Python double and rounded once to float32.  Op for op this
is the eager JAX ``_adam_leaf``, so the two agree bitwise; a jitted JAX
step fuses ``b1*m + (1-b1)*g`` into an FMA and differs by an ulp.

The square root is taken in float64 and rounded once to float32, which is
the correctly rounded float32 root (53 >= 2*24 + 2 bits, so the double
rounding is harmless).  PyTorch's vectorised CPU ``sqrt`` is not correctly
rounded (about 0.6% of inputs differ in the last bit), while XLA's and the
card's are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import tree as T
from repro_torch.kernels.fused_adam import ops as fused

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamHyper:
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-6          # the paper uses 1e-6 (inside the sqrt)
    bias_correction: bool = False
    weight_decay: float = 0.0


class AdamState(NamedTuple):
    m: Any                      # tree like params
    v: Any
    count: int                  # steps taken


def adam_init(params) -> AdamState:
    return AdamState(m=T.tree_map(torch.zeros_like, params),
                     v=T.tree_map(torch.zeros_like, params), count=0)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device."""
    return torch.sqrt(x.to(torch.float64)).to(_F32)


def _adam_leaf(w, g, m, v, h: AdamHyper, count: int):
    gf = g.to(_F32)
    mf = h.beta1 * m.to(_F32) + (1.0 - h.beta1) * gf
    vf = h.beta2 * v.to(_F32) + (1.0 - h.beta2) * gf * gf
    if h.bias_correction:
        # filled on the device: a host-to-device copy would sync the stream
        t = torch.full((), float(count) + 1.0, dtype=_F32, device=w.device)
        b1 = torch.full((), h.beta1, dtype=_F32, device=w.device)
        b2 = torch.full((), h.beta2, dtype=_F32, device=w.device)
        m_hat = mf / (1.0 - b1 ** t)
        v_hat = vf / (1.0 - b2 ** t)
    else:
        m_hat, v_hat = mf, vf
    upd = m_hat / sqrt_rn(v_hat + h.eps)     # paper: eps inside the sqrt
    if h.weight_decay:
        upd = upd + h.weight_decay * w.to(_F32)
    w_new = w.to(_F32) - h.lr * upd
    return w_new.to(w.dtype), mf.to(m.dtype), vf.to(v.dtype)


def adam_step(params, grads, state: AdamState, h: AdamHyper,
              use_kernel: bool = False):
    """One Adam step.  Returns (new_params, new_state).  ``use_kernel``
    sends every leaf through the fused_adam kernel (plain version on CPU
    tensors), whose arithmetic differs from :func:`_adam_leaf`'s: see
    ``repro_torch/kernels/fused_adam/ops.py``."""
    pw, td = T.flatten(params)
    if use_kernel:
        # one float32[4] per step, shared by every leaf: the moments stay
        # uncorrected, bias correction lives in the scalars
        scalars = fused.effective_scalars(h, state.count, pw[0].device)

        def leaf(w, g, m, v):
            # a tied weight's gradient (the embedding, read by the lookup
            # and by the head) can come back transposed
            return fused.fused_adam_apply(scalars, w, g.contiguous(), m, v)
    else:
        def leaf(w, g, m, v):
            return _adam_leaf(w, g, m, v, h, state.count)

    outs = [leaf(w, g, m, v) for w, g, m, v in
            zip(pw, T.leaves(grads), T.leaves(state.m), T.leaves(state.v))]
    return (td.unflatten([o[0] for o in outs]),
            AdamState(td.unflatten([o[1] for o in outs]),
                      td.unflatten([o[2] for o in outs]), state.count + 1))


def sgd_step(params, grads, lr: float):
    """One vanilla SGD step (the FedSGD baseline's local update)."""
    return T.tree_map(
        lambda w, g: (w.to(_F32) - lr * g.to(_F32)).to(w.dtype),
        params, grads)
