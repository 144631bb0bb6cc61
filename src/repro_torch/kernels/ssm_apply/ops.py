"""Shared-mask applies, one leaf per call.

Counterpart of ``repro/kernels/ssm_apply/{ssm_apply,ops,ref}.py``.
``ssm_apply_ef`` is the fused apply with error feedback; with tau from
``topk_mask.ops.select_tau`` it is the per-leaf kernel-path compress:

    tau, _ = select_tau(dW, k)
    sW, sM, sV, err = ssm_apply_ef(tau, dW, dM, dV)

``ssm_apply`` is the 3-in/3-out apply without cast, score or residual
(``ssm_apply_2d``); like the JAX package's, it has no caller on the
training paths.  On a CUDA tensor each launches its kernel of
``csrc/ssm_apply.cu`` (float32 or bfloat16 leaves of any length: dw, dm
and dv of an ``ssm_apply_ef`` call in one dtype and its score in float32
or that dtype, each stream of an ``ssm_apply`` call in its own); on a CPU
tensor each runs its plain
version, the composed arithmetic of the reference compress path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _lib, predict
from repro_torch.kernels._check import (cuda_arg, is_fake, leaf_dtype_code,
                                        on_cpu, ptr, stream)
from repro_torch.kernels.packed_topk.ops import _value_code

_F32 = torch.float32
_TORCH_VALUE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def ssm_apply_ef_plain(tau, dw, dm, dv, score=None, *, with_residual=True,
                       value_dtype=None):
    """``keep = |score or dw| >= tau``; ``where(keep, cast(x), 0)`` for
    dw, dm, dv; the residual ``dw - sw`` in float32, cast back."""
    _value_code(value_dtype)
    s = dw if score is None else score
    keep = s.to(_F32).abs() >= tau

    def apply(x):
        if value_dtype is not None:
            x = x.to(_TORCH_VALUE_DTYPES[value_dtype]).to(x.dtype)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))

    sw, sm, sv = apply(dw), apply(dm), apply(dv)
    if not with_residual:
        return sw, sm, sv
    return sw, sm, sv, (dw.to(_F32) - sw.to(_F32)).to(dw.dtype)


def ssm_apply_ef(tau: torch.Tensor, dw, dm, dv,
                 score: Optional[torch.Tensor] = None, *,
                 with_residual: bool = True, value_dtype=None):
    """Fused compress pass over same-shape leaves: ``(sw, sm, sv)`` or
    ``(sw, sm, sv, err)``.  ``score`` defaults to ``dw`` (the ssm_w rule),
    which the kernel then reads once; a given one is float32 or dw's
    dtype (``fairness_top``'s float32 scores beside bfloat16 leaves).
    ONE launch on the card."""
    if on_cpu(dw):
        return ssm_apply_ef_plain(tau, dw, dm, dv, score,
                                  with_residual=with_residual,
                                  value_dtype=value_dtype)
    vdt = _value_code(value_dtype)
    code = leaf_dtype_code("dw", dw)
    dev = dw.device
    cuda_arg("tau", tau, _F32, (), dev, aligned=False)
    for name, x in (("dw", dw), ("dm", dm), ("dv", dv)):
        cuda_arg(name, x, dw.dtype, dw.shape, dev, aligned=False)
    score_code = code
    if score is not None:
        score_code = leaf_dtype_code("score", score)
        cuda_arg("score", score, score.dtype, dw.shape, dev, aligned=False)
    outs = [torch.empty_like(x) for x in (dw, dm, dv)]
    err = torch.empty_like(dw) if with_residual else None
    if is_fake(dw):
        predict("ssm_apply_ef", (tau, score, dw, dm, dv), (*outs, err))
        return tuple(outs) + ((err,) if with_residual else ())
    _lib.launch("repro_ssm_apply_ef", ptr(tau), ptr(score), ptr(dw),
                ptr(dm), ptr(dv), ptr(outs[0]), ptr(outs[1]), ptr(outs[2]),
                ptr(err), dw.numel(), code, score_code, vdt, stream(dev))
    LAUNCHES["ssm_apply_ef"] += 1
    return tuple(outs) + ((err,) if with_residual else ())


def ssm_apply_plain(tau, dw, dm, dv):
    """``keep = |dw| >= tau``; ``where(keep, x, 0)`` for dw, dm, dv."""
    return ssm_apply_ef_plain(tau, dw, dm, dv, with_residual=False)


def ssm_apply(tau: torch.Tensor, dw, dm, dv):
    """The 3-in/3-out shared-mask apply over same-shape leaves, each of
    float32 or bfloat16: ``(sw, sm, sv)``, each in its input's dtype (as
    the JAX kernel's per-stream dtypes).  ONE launch on the card."""
    if on_cpu(dw):
        return ssm_apply_plain(tau, dw, dm, dv)
    dev = dw.device
    cuda_arg("tau", tau, _F32, (), dev, aligned=False)
    codes = []
    for name, x in (("dw", dw), ("dm", dm), ("dv", dv)):
        codes.append(leaf_dtype_code(name, x))
        cuda_arg(name, x, x.dtype, dw.shape, dev, aligned=False)
    outs = [torch.empty_like(x) for x in (dw, dm, dv)]
    if is_fake(dw):
        predict("ssm_apply", (tau, dw, dm, dv), outs)
        return tuple(outs)
    _lib.launch("repro_ssm_apply", ptr(tau), ptr(dw), ptr(dm), ptr(dv),
                ptr(outs[0]), ptr(outs[1]), ptr(outs[2]), dw.numel(), *codes,
                stream(dev))
    LAUNCHES["ssm_apply"] += 1
    return tuple(outs)
