"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
comparisons look at the bits (float32 and uint32 viewed as int32)."""
from __future__ import annotations

import numpy as np
import pytest
import torch


def rand_leaves(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def np_tree(seed, shapes, scale=1.0, absval=False):
    leaves = rand_leaves(seed, shapes, scale)
    if absval:
        leaves = [np.abs(x) for x in leaves]
    return {f"l{i}": x for i, x in enumerate(leaves)}


def to_torch(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def to_jax(tree):
    import jax.numpy as jnp
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_jax(v) for v in tree)
    return jnp.asarray(tree)


def bits(x) -> np.ndarray:
    """The raw bits of a float32/int32/uint32/bfloat16/bool array or
    tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        elif x.dtype in (torch.bfloat16, torch.float16):
            x = x.view(torch.int16)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype == np.bool_:
        return x
    if x.itemsize == 2:
        return x.view(np.int16)
    return x.view(np.int32) if x.itemsize == 4 else x


# bfloat16 crosses between the packages as its uint16 bit pattern, so both
# sides hold the same values (numpy has no bfloat16 of its own; JAX's is
# the ml_dtypes type).


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> the uint16 bits of its bfloat16 rounding (nearest even)."""
    import jax.numpy as jnp
    return np.asarray(x, np.float32).astype(jnp.bfloat16).view(np.uint16)


def as_dtype(x: np.ndarray, dtype: str) -> np.ndarray:
    """float32 data in the working dtype's numpy form: float32 as is,
    bfloat16 as its uint16 bits."""
    return bf16_bits(x) if dtype == "bfloat16" else np.asarray(x, np.float32)


def np_bits_tree(tree):
    """A JAX tree as numpy leaves, bfloat16 leaves as uint16 bit views."""
    import jax
    return jax.tree.map(
        lambda x: np.asarray(x).view(np.uint16) if x.dtype.itemsize == 2
        else np.asarray(x), tree)


def leaf_to_torch(x: np.ndarray, device="cpu") -> torch.Tensor:
    """A numpy leaf as a tensor; uint16 is taken as bfloat16 bits."""
    x = np.asarray(x)
    if x.dtype == np.uint16:
        return torch.from_numpy(x.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(x.copy()).to(device)


def leaf_to_jax(x: np.ndarray):
    """A numpy leaf as a JAX array; uint16 is taken as bfloat16 bits."""
    import jax.numpy as jnp
    x = np.asarray(x)
    return jnp.asarray(x.view(jnp.bfloat16) if x.dtype == np.uint16 else x)


def assert_bitwise(a, b, what=""):
    ba, bb = bits(a), bits(b)
    assert ba.shape == bb.shape, f"{what}: shape {ba.shape} vs {bb.shape}"
    diff = int(np.sum(ba != bb))
    assert diff == 0, f"{what}: {diff} of {ba.size} elements differ"


def assert_tree_bitwise(a, b, what=""):
    assert sorted(a) == sorted(b), f"{what}: keys differ"
    for k in a:
        assert_bitwise(a[k], b[k], f"{what}[{k}]")


@pytest.fixture
def cuda_device():
    """The CUDA device for tests marked ``cuda``; skips (inside the test,
    never at collection) where no card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest "
                    "-m cuda tests/test_torch_cuda.py` on a machine with one")
    return torch.device("cuda")


@pytest.fixture
def jax_packed_oracles(monkeypatch):
    """Route the JAX package's packed kernel backend through its jnp
    oracles.  ``packed_hist_2d``/``packed_apply_2d`` call ``pl.load``/
    ``pl.store``, which the installed jax no longer has, so they cannot
    run in interpret mode here; ``packed_hist_ref``/``packed_apply_ef_ref``
    (and its single-stream form ``packed_mask_apply_ref``, FedAdam-Top's)
    replay the kernels' block order exactly (the JAX package's own parity
    tests hold them bitwise equal)."""
    import repro.core.sparsify as JS
    from repro.kernels.packed_topk import ref as jpref

    def apply_ef(taus2, seg_ids, ks, ns, dw, dm, dv, score=None, *,
                 with_residual=True, value_dtype=None):
        return jpref.packed_apply_ef_ref(
            taus2, seg_ids, ks, ns, (dw, dm, dv), score,
            with_residual=with_residual, value_dtype=value_dtype)

    monkeypatch.setattr(JS, "packed_hist_kernel", jpref.packed_hist_ref)
    monkeypatch.setattr(JS, "packed_apply_ef", apply_ef)
    monkeypatch.setattr(JS, "packed_mask_apply", jpref.packed_mask_apply_ref)
