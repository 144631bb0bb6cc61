"""Device choice for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do); with no card and no such request
they raise instead of quietly running elsewhere.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def exact_float32() -> None:
    """Make float32 mean float32 on the card: no TF32 in cuDNN
    convolutions (PyTorch's default allows it) or in matrix products, and
    bfloat16 matrix products that sum in float32 (cuBLAS may otherwise
    reduce in bfloat16).  The JAX reference computes the same on the
    CPU."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
