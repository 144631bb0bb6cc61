"""The paper's experimental models (Section VII): CNN (Fashion-MNIST),
VGG-11 (CIFAR-10), ResNet-18 (SVHN), with a ``width`` multiplier.

Counterpart of ``repro/models/vision.py``.  Parameters are dicts of
tensors in the JAX package's layout, on purpose: conv weights HWIO, dense
weights (in, out), images NHWC.  The packed compress flattens each leaf
row-major and the wire bytes follow that order, so a different storage
layout would be a different wire.  The forwards permute to PyTorch's
NCHW/OIHW inside, and back to NHWC before flattening, so ``fc1``'s rows
line up with the JAX model's.  Convolutions and matrix products are
``torch.nn.functional.conv2d`` and ``matmul`` (the JAX package leaves
them to XLA, not to a Pallas kernel).

On CPU tensors the convolutions call PyTorch's own im2col-and-matmul
kernel by name (``aten._slow_conv2d_forward``, whose autograd backward is
``_slow_conv2d_backward``), so neither oneDNN nor NNPACK is chosen and
no process-wide backend flag is touched.  How close oneDNN's float32
weight gradient comes to float64 depends on the host: on the CPU host of
an H100 machine (torch 2.11) conv1's gradient of the width-1.0 CNN after
one Efficient-Adam round sat 2.27e-3 from it (median relative error; the
native kernel 1.5e-7, the card 1.2e-7), far beyond the tolerance that
holds the port to the JAX package (tests/test_torch_onednn.py;
``chip_smoke.py``'s ``conv1_float64_gap`` measures it).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, exact_float32, resolve_device

_F32 = torch.float32


def _conv_shape(kh, kw, cin, cout):
    return (kh, kw, cin, cout), kh * kw * cin


def _dense_shape(cin, cout):
    return (cin, cout), cin


def _same_pad(size: int, k: int, stride: int):
    """XLA "SAME" padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv2d(x, w, stride: int):
    """``conv2d`` with no padding; on CPU tensors through the native
    kernel (see the module docstring)."""
    if x.device.type == "cpu":
        # NCHW-contiguous operands: the kernel's backward refuses the
        # channels-last weight gradient a permuted input would give it
        return torch.ops.aten._slow_conv2d_forward(
            x.contiguous(), w.contiguous(), list(w.shape[2:]), None,
            [stride, stride], [0, 0])
    return F.conv2d(x, w, stride=stride)


def _conv(x, w, stride: int = 1):
    """x: NCHW, w: HWIO -> NCHW with XLA "SAME" padding."""
    kh, kw = w.shape[0], w.shape[1]
    ph = _same_pad(x.shape[2], kh, stride)
    pw = _same_pad(x.shape[3], kw, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return _conv2d(x, w.permute(3, 2, 0, 1), stride)


def _nchw(x):
    # a plain permute would be a channels-last view, and PyTorch's CPU
    # channels-last convolution backward corrupts the heap on the strided
    # ResNet blocks; the copy keeps every convolution on NCHW-contiguous
    return x.permute(0, 3, 1, 2).contiguous()


def _flatten_nhwc(x):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# CNN (paper: 2x conv5x5 + 2 FC, Fashion-MNIST)
# ---------------------------------------------------------------------------


def cnn_shapes(in_shape=(28, 28, 1), n_classes=10, width=1.0):
    c1, c2, fc = int(32 * width), int(64 * width), int(128 * width)
    h, w, cin = in_shape
    return {
        "conv1": _conv_shape(5, 5, cin, c1),
        "conv2": _conv_shape(5, 5, c1, c2),
        "fc1": _dense_shape((h // 4) * (w // 4) * c2, fc),
        "fc2": _dense_shape(fc, n_classes),
    }


def cnn_fwd(p, x):
    x = _nchw(x)
    x = F.max_pool2d(torch.relu(_conv(x, p["conv1"])), 2)
    x = F.max_pool2d(torch.relu(_conv(x, p["conv2"])), 2)
    x = torch.relu(_flatten_nhwc(x) @ p["fc1"])
    return x @ p["fc2"]


# ---------------------------------------------------------------------------
# VGG-11 (paper: CIFAR-10)
# ---------------------------------------------------------------------------

_VGG11 = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


def vgg11_shapes(in_shape=(32, 32, 3), n_classes=10, width=1.0):
    shapes = {}
    cin = in_shape[2]
    i = 0
    for item in _VGG11:
        if item == "M":
            continue
        cout = max(8, int(item * width))
        shapes[f"conv{i}"] = _conv_shape(3, 3, cin, cout)
        cin = cout
        i += 1
    fc = max(16, int(512 * width))
    shapes["fc1"] = _dense_shape(cin, fc)
    shapes["fc2"] = _dense_shape(fc, fc)
    shapes["fc3"] = _dense_shape(fc, n_classes)
    return shapes


def vgg11_fwd(p, x):
    x = _nchw(x)
    i = 0
    for item in _VGG11:
        if item == "M":
            x = F.max_pool2d(x, 2)
        else:
            x = torch.relu(_conv(x, p[f"conv{i}"]))
            i += 1
    x = _flatten_nhwc(x)
    x = torch.relu(x @ p["fc1"])
    x = torch.relu(x @ p["fc2"])
    return x @ p["fc3"]


# ---------------------------------------------------------------------------
# ResNet-18 (paper: SVHN)
# ---------------------------------------------------------------------------


def resnet18_shapes(in_shape=(32, 32, 3), n_classes=10, width=1.0):
    w64 = max(8, int(64 * width))
    chans = [w64, w64 * 2, w64 * 4, w64 * 8]
    shapes = {"stem": _conv_shape(3, 3, in_shape[2], w64)}
    cin = w64
    for s, cout in enumerate(chans):
        for b in range(2):
            pref = f"s{s}b{b}"
            shapes[pref + "_c1"] = _conv_shape(3, 3, cin, cout)
            shapes[pref + "_c2"] = _conv_shape(3, 3, cout, cout)
            if cin != cout:
                shapes[pref + "_proj"] = _conv_shape(1, 1, cin, cout)
            cin = cout
    shapes["fc"] = _dense_shape(cin, n_classes)
    return shapes


def resnet18_fwd(p, x):
    x = torch.relu(_conv(_nchw(x), p["stem"]))
    for s in range(4):
        for b in range(2):
            pref = f"s{s}b{b}"
            stride = 2 if (s > 0 and b == 0) else 1
            h = torch.relu(_conv(x, p[pref + "_c1"], stride=stride))
            h = _conv(h, p[pref + "_c2"])
            sc = x
            if pref + "_proj" in p:
                sc = _conv(x, p[pref + "_proj"], stride=stride)
            x = torch.relu(h + sc)
    return x.mean(dim=(2, 3)) @ p["fc"]


# ---------------------------------------------------------------------------

MODELS = {
    "cnn": (cnn_shapes, cnn_fwd, "fashion_mnist"),
    "vgg11": (vgg11_shapes, vgg11_fwd, "cifar10"),
    "resnet18": (resnet18_shapes, resnet18_fwd, "svhn"),
}


def in_shape_of(name: str):
    return (28, 28, 1) if MODELS[name][2] == "fashion_mnist" else (32, 32, 3)


def init_params(name: str, width: float = 1.0, n_classes: int = 10,
                seed: int = 0, device: DeviceLike = None
                ) -> Dict[str, torch.Tensor]:
    """Random weights N(0, 1/fan_in) from a ``torch.Generator`` seeded
    with ``seed`` (not the JAX package's numbers; tests carry those across
    with :func:`params_from_jax`)."""
    dev = resolve_device(device)
    shapes = MODELS[name][0](in_shape=in_shape_of(name),
                             n_classes=n_classes, width=width)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return {k: (torch.randn(shape, generator=gen, dtype=_F32)
                / math.sqrt(max(1, fan_in))).to(dev)
            for k, (shape, fan_in) in sorted(shapes.items())}


def params_from_jax(np_params, device: DeviceLike = None
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter dict (as numpy arrays) on ``device``,
    same shapes and layout."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in np_params.items()}


def build_vision(name: str, width: float = 1.0, n_classes: int = 10,
                 seed: int = 0, device: DeviceLike = None):
    """``(params, fwd, loss_fn, acc_fn, dataset_name)`` as in the JAX
    package; ``batch = (images NHWC float32, labels int)``.  Turns TF32
    off (see :func:`repro_torch.device.exact_float32`)."""
    exact_float32()
    params = init_params(name, width, n_classes, seed, device)
    fwd = MODELS[name][1]

    def loss_fn(p, batch):
        imgs, labels = batch
        logits = fwd(p, imgs).to(_F32)
        picked = logits.gather(1, labels.long()[:, None])[:, 0]
        return (torch.logsumexp(logits, -1) - picked).mean()

    def acc_fn(p, batch):
        imgs, labels = batch
        return (fwd(p, imgs).argmax(-1) == labels).to(_F32).mean()

    return params, fwd, loss_fn, acc_fn, MODELS[name][2]
