"""Quantizers of the quantized-FedAdam baselines (1-bit Adam,
Efficient-Adam).

Counterpart of ``repro/core/quantize.py``.  Every quantizer is blockwise
(one float32 scale per ``block`` elements of the flattened leaf, the last
block zero-padded) and comes with an exact dequantizer, so error-feedback
residuals are computable.  Plain PyTorch: the JAX package computes these
with jnp outside any kernel.

Scalars that divide a tensor enter as tensors on the tensor's device:
PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
which is not the correctly rounded quotient the CPU and XLA take.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import tree as T

_F32 = torch.float32


def _blocks(x: torch.Tensor, block: int):
    """``(nb, block)`` float32 view of flat x zero-padded to whole blocks,
    and the element count."""
    flat = x.reshape(-1).to(_F32)
    n = flat.numel()
    flat = torch.nn.functional.pad(flat, (0, (-n) % block))
    return flat.reshape(-1, block), n


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=_F32, device=like.device)


def sign_quant(x: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """1-bit sign quantization with a per-block L1 scale (1-bit Adam):
    ``+scale`` where x >= 0, ``-scale`` elsewhere, scale = mean |block|
    (padding zeros counted).  Two-valued per block, so a sign bitplane and
    one float32 per block carry it exactly (``core/wire.pack_sign``)."""
    xb, n = _blocks(x, block)
    scale = xb.abs().mean(dim=1, keepdim=True)
    q = torch.where(xb >= 0, scale, -scale)
    return q.reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def uniform_encode(x: torch.Tensor, bits: int = 8,
                   block: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric b-bit uniform quantization with a per-block max scale, the
    encoder half: ``(codes, scales)``, int32
    codes of x's shape in ``[-qmax, qmax]`` (qmax = 2**(bits-1) - 1) and
    (nb,) float32 scales ``max|block| / qmax + 1e-30``."""
    xb, n = _blocks(x, block)
    qmax = 2.0 ** (bits - 1) - 1.0
    scale = xb.abs().amax(dim=1, keepdim=True) / _scalar(qmax, xb) + 1e-30
    q = torch.round(xb / scale).clamp_(-qmax, qmax).to(torch.int32)
    return q.reshape(-1)[:n].reshape(x.shape), scale.reshape(-1)


def uniform_decode(codes: torch.Tensor, scales: torch.Tensor,
                   block: int = 1024) -> torch.Tensor:
    """Exact dequantizer of :func:`uniform_encode` (float32 result)."""
    cb, n = _blocks(codes, block)
    return (cb * scales[:, None]).reshape(-1)[:n].reshape(codes.shape)


def tree_sign_quant(tree, block: int = 1024):
    return T.tree_map(lambda x: sign_quant(x, block), tree)
