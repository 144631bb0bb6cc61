"""Argument checks shared by the kernel wrappers (run before any pointer
reaches native code)."""
from __future__ import annotations

import torch


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA one
    (kernel); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def cuda_arg(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None,
             device=None, aligned: bool = True) -> torch.Tensor:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape`` / ``device`` where given), 16-byte aligned unless the kernel
    takes any alignment (``aligned=False``)."""
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a tensor on {device or 'cuda'}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")
    return t


#: Element types of the per-leaf kernels -> the kernels' dtype code.
LEAF_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def leaf_dtype_code(name: str, t: torch.Tensor) -> int:
    if t.dtype not in LEAF_DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got "
                        f"{t.dtype}")
    return LEAF_DTYPES[t.dtype]


def ptr(t):
    """A tensor's address as a launcher argument (None for None)."""
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``,
    as PyTorch's own generated kernels take it: no Stream object is made
    per call."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)
