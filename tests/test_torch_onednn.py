"""The port's CPU convolutions against JAX's and against float64, with and
without oneDNN.

The width-1.0 CNN is built on the CPU from the JAX package's weights in
both packages; one Efficient-Adam round of 2 clients moves them off their
init on each side.  At JAX's new weights, the conv1 and conv2 weight
gradients of one batch are compared: the port's (its CPU convolutions
call PyTorch's native im2col kernel by name, forward and backward), the
port's through oneDNN, JAX's ``jax.grad``, and float64 (the native
kernels).  The
tolerance is ``test_vision_loss_and_grads_match_jax``'s: rtol 1e-4 and
1e-5 of the largest |g|.

On the CPU host of an H100 machine (torch 2.11), oneDNN's conv1 gradient
sat 2.27e-3 from float64 (median relative error) where the native kernel
sat 1.47e-7 and the card 1.22e-7 (``chip_smoke.py``'s
``conv1_float64_gap``); on another CPU (torch 2.13) all of them sat
within 2.5e-7 of it.  So the port takes the native kernels on every
host, and this test holds that choice: bitwise the native computation,
within tolerance of JAX, and both within tolerance of float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import fed as jfed
from repro.models import vision as jvision
from repro.optim import adam as jadam
from repro_torch.core import FedConfig, fed_init, make_fl_round
from repro_torch.data import (client_batches, dirichlet_partition,
                              synthetic_image_dataset)
from repro_torch.models import vision
from repro_torch.optim import adam

# one torch thread, as tests/_torch_parity.py sets for the port's tests
torch.set_num_threads(1)


def _grads(loss_fn, W, batch, dtype=torch.float32, onednn=None):
    """conv1/conv2 weight gradients at ``W`` (numpy) on ``batch``; with
    ``onednn`` set, ``conv2d`` is called directly under that oneDNN flag
    (the whole forward and backward, on NCHW-contiguous activations;
    NNPACK off, so that with oneDNN off PyTorch picks its native NCHW
    kernel), else through the model's own CPU
    convolution with PyTorch's default flags (oneDNN on), which must
    leave them as they were."""
    p = {k: torch.from_numpy(v.copy()).to(dtype).requires_grad_(True)
         for k, v in W.items()}
    x, y = torch.from_numpy(batch[0]).to(dtype), torch.from_numpy(batch[1])
    if onednn is None:
        assert torch.backends.mkldnn.enabled
        g = torch.autograd.grad(loss_fn(p, (x, y)), list(p.values()))
        assert torch.backends.mkldnn.enabled
        return {k: v.double().numpy() for k, v in zip(p, g)}
    own = vision._conv2d
    try:
        vision._conv2d = lambda a, w, s: F.conv2d(a.contiguous(), w, stride=s)
        with torch.backends.mkldnn.flags(enabled=onednn), \
                torch.backends.nnpack.flags(enabled=False):
            g = torch.autograd.grad(loss_fn(p, (x, y)), list(p.values()))
    finally:
        vision._conv2d = own
    return {k: v.double().numpy() for k, v in zip(p, g)}


def _beyond(a, b) -> float:
    """Share of ``a`` outside rtol 1e-4 / atol 1e-5 * max|b| of ``b``."""
    return float(np.mean(~np.isclose(a, b, rtol=1e-4,
                                     atol=1e-5 * float(np.abs(b).max()))))


def test_cpu_conv_grads_against_jax_and_float64():
    C = 2
    jparams, _, jloss, _, ds = jvision.build_vision("cnn", width=1.0)
    params_np = {k: np.asarray(v) for k, v in jparams.items()}
    _, _, tloss, _, _ = vision.build_vision("cnn", width=1.0, device="cpu")
    imgs, labels = synthetic_image_dataset(ds, 512, seed=1)
    parts = dirichlet_partition(labels, n_clients=C, theta=0.1, seed=1)
    (bx, by), w = client_batches([imgs, labels], parts, 32, seed=0)
    kw = dict(algorithm="efficient_adam", alpha=1.0, n_clients=C,
              local_epochs=3, error_feedback=True)
    jf = jfed.FedConfig(**kw, adam=jadam.AdamHyper(lr=1e-3))
    js, _ = jax.jit(jfed.make_fl_round(jf, jloss))(
        jfed.fed_init(jf, jparams), (jnp.asarray(bx), jnp.asarray(by)),
        jnp.asarray(w))
    tf = FedConfig(**kw, adam=adam.AdamHyper(lr=1e-3))
    ts, _ = make_fl_round(tf, tloss)(
        fed_init(tf, vision.params_from_jax(params_np, "cpu")),
        (torch.from_numpy(bx), torch.from_numpy(by)), torch.from_numpy(w))
    Wj = {k: np.asarray(v) for k, v in js.W.items()}
    for k in Wj:   # the two rounds agree, and moved the weights
        assert _beyond(ts.W[k].numpy(), Wj[k]) <= 2e-3, k
        assert not np.array_equal(Wj[k], params_np[k]), k

    batch = (bx[0], by[0])
    gj = jax.jit(jax.grad(jloss))(
        {k: jnp.asarray(v) for k, v in Wj.items()},
        (jnp.asarray(batch[0]), jnp.asarray(batch[1])))
    gj = {k: np.asarray(v, np.float64) for k, v in gj.items()}
    g64 = _grads(tloss, Wj, batch, torch.float64, onednn=False)
    port = _grads(tloss, Wj, batch)
    native = _grads(tloss, Wj, batch, onednn=False)
    via_onednn = _grads(tloss, Wj, batch, onednn=True)
    median = lambda g, k: float(np.median(
        np.abs(g[k] - g64[k]) / np.maximum(np.abs(g64[k]), 1e-30)))
    for k in ("conv1", "conv2"):
        # the port's own CPU convolution is the native one, bitwise
        np.testing.assert_array_equal(port[k], native[k], err_msg=k)
        assert _beyond(port[k], gj[k]) == 0.0, k
        assert _beyond(port[k], g64[k]) == 0.0, k
        assert _beyond(gj[k], g64[k]) == 0.0, k
        assert median(port, k) < 1e-6 and median(gj, k) < 1e-6, k
        # oneDNN here: measured, not held (its error depends on the host)
        assert np.isfinite(median(via_onednn, k)), k


@pytest.mark.parametrize("dtype,stride", [(torch.float32, 1),
                                          (torch.float32, 2),
                                          (torch.float64, 1)])
def test_cpu_conv_is_the_native_kernel(dtype, stride):
    """The port's CPU convolution, forward and both gradients, bitwise
    PyTorch's ``conv2d`` with oneDNN and NNPACK off (its native kernel),
    at the CNN's shapes and at a strided one (ResNet-18's)."""
    gen = torch.Generator().manual_seed(stride)
    x = torch.randn((32, 16, 14, 14), generator=gen, dtype=dtype)
    w = torch.randn((5, 5, 16, 8), generator=gen, dtype=dtype)
    g = None
    outs = []
    for native in (False, True):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        if native:
            with torch.backends.mkldnn.flags(enabled=False), \
                    torch.backends.nnpack.flags(enabled=False):
                y = F.conv2d(xx, ww.permute(3, 2, 0, 1), stride=stride)
                gx, gw = torch.autograd.grad(y, [xx, ww], g)
        else:
            y = vision._conv2d(xx, ww.permute(3, 2, 0, 1), stride)
            g = torch.randn(y.shape, generator=gen, dtype=dtype)
            gx, gw = torch.autograd.grad(y, [xx, ww], g)
        outs.append((y.detach(), gx, gw))
    for a, b, what in zip(outs[0], outs[1], ("y", "dx", "dw")):
        assert torch.equal(a, b), what


def test_cpu_conv_sets_no_backend_flag(monkeypatch):
    """A forward and backward of the CNN on the CPU set no process-wide
    backend flag: another thread's CPU work runs as its own flags say."""
    sets = []
    cls = type(torch.backends.mkldnn)
    prop = cls.__dict__["enabled"]

    class Spy:
        def __get__(self, obj, owner=None):
            return prop.__get__(obj, owner)

        def __set__(self, obj, value):
            sets.append(("enabled", value))
            prop.__set__(obj, value)

    monkeypatch.setattr(cls, "enabled", Spy())
    for name in ("_set_mkldnn_enabled", "_set_nnpack_enabled"):
        own = getattr(torch._C, name)
        monkeypatch.setattr(torch._C, name, lambda v, own=own, name=name: (
            sets.append((name, v)), own(v))[1])
    params, _, loss_fn, _, ds = vision.build_vision("cnn", width=0.25,
                                                    device="cpu")
    imgs, labels = synthetic_image_dataset(ds, 8, seed=0)
    p = {k: v.requires_grad_(True) for k, v in params.items()}
    torch.autograd.grad(loss_fn(p, (torch.from_numpy(imgs),
                                    torch.from_numpy(labels))),
                        list(p.values()))
    assert sets == []
