"""The port's exact top-k masks against the JAX package's, on ties.

``lax.top_k`` keeps the lower index among equal magnitudes; the port
keeps every magnitude above the k-th and then the first elements equal to
it by index.  Every case here has ties at the k-th magnitude (equal
float32 or bfloat16 values, small integers, a constant leaf, the zeros of
a mostly empty last block and its padding), and the masks must be bitwise
equal to JAX's.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise, bf16_bits, leaf_to_jax, \
    leaf_to_torch
from repro.core import masks as JM
from repro.core import sparsify as JS
from repro_torch.core import masks
from repro_torch.core import sparsify as S

ALPHA = 0.05


def _tied(case: str) -> np.ndarray:
    """A leaf (numpy; uint16 = bfloat16 bits) whose k-th magnitude ties."""
    rng = np.random.default_rng(3)
    if case == "float32":
        # one decimal: about 40 elements share each magnitude
        return np.round(rng.standard_normal(20_000), 1).astype(np.float32)
    if case == "bfloat16":
        # a delta-like leaf: bfloat16's 8 bits of mantissa tie often
        return bf16_bits(rng.standard_normal(65_536) * 1e-3)
    if case == "integers":
        return rng.integers(-5, 6, 5000).astype(np.float32)
    if case == "constant":
        # every element ties: the first k by index are kept
        return np.full(3000, -0.25, np.float32)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["float32", "bfloat16", "integers",
                                  "constant"])
def test_exact_mask_keeps_the_lower_index_among_ties(case):
    x = _tied(case)
    n = x.size
    k = S.k_for(n, ALPHA)
    ref = JS.topk_mask_exact(leaf_to_jax(x), k)
    out = S.topk_mask_exact(leaf_to_torch(x), k)
    assert int(out.sum()) == k
    assert_bitwise(out, np.asarray(ref), case)
    # the ties are real: the k-th magnitude is shared by kept and dropped
    a = leaf_to_torch(x).float().abs()
    kth = a[out].min()
    assert bool(((a == kth) & ~out).any()), case


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_mask_breaks_ties_as_jax_in_the_padded_block(dtype):
    """A leaf of 2^20 + 3000 elements: a full block, then a last block of
    3000 elements, all but 100 of them zero, padded with 2^20 - 3000 zeros.
    Its k_for(2^20) kept slots are the 100 non-zeros and the FIRST zeros
    by index: real zeros before padding."""
    rng = np.random.default_rng(5)
    n = (1 << 20) + 3000
    x = np.round(rng.standard_normal(n), 2).astype(np.float32)
    x[(1 << 20) + 100:] = 0.0
    if dtype == "bfloat16":
        x = bf16_bits(x)
    ref = JS.blocked_topk_mask(leaf_to_jax(x), ALPHA)
    out = S.blocked_topk_mask(leaf_to_torch(x), ALPHA)
    assert_bitwise(out, np.asarray(ref), dtype)
    k = S.k_for(S.BLOCK, ALPHA)
    assert int(out[:S.BLOCK].sum()) == k
    # the last block keeps its 100 non-zeros and its first real zeros
    assert int(out[S.BLOCK:].sum()) == min(k, 3000)


@pytest.mark.parametrize("scope", ["per_tensor", "global"])
def test_exact_tree_masks_on_ties_match_jax(scope):
    """The tree-level exact masks (FedAdam-SSM's shared mask from a tied
    dW), per tensor and over the raveled model."""
    rng = np.random.default_rng(9)
    tree = {"a": np.round(rng.standard_normal(9001), 1).astype(np.float32),
            "b": rng.integers(-3, 4, (8, 1024)).astype(np.float32),
            "c": np.zeros(37, np.float32)}
    jt = {k: leaf_to_jax(v) for k, v in tree.items()}
    tt = {k: leaf_to_torch(v) for k, v in tree.items()}
    ref = JM.shared_mask("ssm_w", jt, jt, jt, ALPHA, scope, exact=True,
                         backend="reference")
    out = masks.shared_mask("ssm_w", tt, tt, tt, ALPHA, scope, exact=True,
                            backend="reference")
    for k in tree:
        assert_bitwise(out[k], np.asarray(ref[k]), f"{scope}[{k}]")
