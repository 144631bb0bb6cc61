"""Device choice for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do); with no card and no such request
they raise instead of quietly running elsewhere.
"""
from __future__ import annotations

import functools
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


def device_cache(maxsize: int):
    """``functools.lru_cache(maxsize)`` for a function that builds constant
    tensors on a device, passed by while a ``FakeTensorMode`` is entered:
    a fake constant must not outlive its trace, nor a real one enter it."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            fake = torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None
            return fn(*args) if fake else cached(*args)

        call.cache_info, call.cache_clear = cached.cache_info, \
            cached.cache_clear
        return call
    return wrap
