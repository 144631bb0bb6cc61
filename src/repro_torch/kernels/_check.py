"""Argument checks shared by the kernel wrappers (run before any pointer
reaches native code), and the wrappers' route.

A wrapper runs its plain version on a CPU tensor and launches its kernel
on a CUDA tensor.  A fake tensor (``FakeTensorMode``: a shape, a dtype
and a device, no storage) on the card takes a third branch, the dry
run's: the wrapper allocates exactly the outputs its kernel allocates,
launches nothing and counts the launch it stands for
(``kernels.predict``).  So does a fake CPU tensor of a mode marked by
:func:`card_mode`: PyTorch's autograd takes no fake CUDA tensor in a
build without CUDA, so there the dry run traces CPU tensors that stand
for the card's.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

#: The attribute :func:`card_mode` sets on a ``FakeTensorMode``.
_STANDS_FOR_CARD = "repro_torch_stands_for_card"


def is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


def card_mode(mode: FakeTensorMode) -> FakeTensorMode:
    """``mode``, marked so that its fake CPU tensors take a wrapper's card
    branch (the dry run's, which launches nothing): the traces of a build
    of PyTorch without CUDA.  Every tensor made under the mode carries
    it; no other tensor is affected."""
    setattr(mode, _STANDS_FOR_CARD, True)
    return mode


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA one
    (kernel) or a fake one that stands for the card's (no launch: the
    wrapper's fake branch); raises for any other device."""
    if t.device.type == "cpu":
        return not (is_fake(t)
                    and getattr(t.fake_mode, _STANDS_FOR_CARD, False))
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def cuda_arg(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None,
             device=None, aligned: bool = True) -> torch.Tensor:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape`` / ``device`` where given), 16-byte aligned unless the kernel
    takes any alignment (``aligned=False``)."""
    fake = is_fake(t)
    if (t.device.type != "cuda" and not fake) or \
            (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a tensor on {device or 'cuda'}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if aligned and not fake and t.data_ptr() % 16:
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
