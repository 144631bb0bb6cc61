"""The port's server-side aggregation (``repro_torch.core.aggregate``)
against the JAX package's (``repro.core.aggregate``), on the CPU.

* ``_pack`` (prefix-sum and top-k slots) and ``_capacity``: bitwise.
* The COO transports, shared (FedAdam-SSM) and independent (FedAdam-Top),
  with and without a bfloat16 value cast: bitwise against eager JAX.
  XLA's scatter-add applies the updates in order, client 0 first, which
  is the order the port's per-client ``index_put_`` adds them in.
* ``ordered_weighted_sum``: bitwise against eager JAX (``disable_jit``);
  compiled, XLA contracts the fold's ``acc + w * x`` into a fused
  multiply-add, which the test emulates exactly in float64.
* ``dense_weighted_sum``: within the error bound of a float32 sum in any
  order, ``C * eps * sum_c |w_c x_c|`` (bitwise on this CPU at C = 5).
* ``wire_gather_sum``: bitwise the scan round's fold of each client's
  decoded payload.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise
from repro.core import aggregate as JA
from repro_torch import tree as T
from repro_torch.core import aggregate as A
from repro_torch.core import compressors
from repro_torch.core import sparsify as S
from repro_torch.core.compressors import Deltas
from repro_torch.core.fed import FedConfig, stack_payloads

EPS32 = float(np.finfo(np.float32).eps)


def _masked(seed, C, n, frac, ties=False):
    """(C, n) float32 with about ``frac`` of the entries nonzero; with
    ``ties``, magnitudes from a few values (many ties at the top-k)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, n)).astype(np.float32)
    if ties:
        x = np.round(x * 2) / 2
    return np.where(rng.random((C, n)) < frac, x, 0).astype(np.float32)


@pytest.mark.parametrize("n", [5000, (1 << 20) + 3000])
@pytest.mark.parametrize("sort_free", [True, False])
def test_pack_bitwise_vs_jax(n, sort_free):
    """Values, block-local indices and the valid flags of the COO pack,
    one block and two (the second mostly padding), on tied magnitudes."""
    x = _masked(1, 2, n, 0.04, ties=True)
    ref = JA._pack(jnp.asarray(x), n, 0.05, sort_free=sort_free)
    out = A._pack(torch.from_numpy(x), n, 0.05, sort_free=sort_free)
    for name, a, b in zip(("vals", "idx", "valid"), out, ref):
        assert_bitwise(a, np.asarray(b), name)
    assert out[1].dtype == torch.int32


def test_capacity_matches_jax():
    for n in (1, 7, 100, 5000, S.BLOCK, S.BLOCK + 1, 3 * S.BLOCK + 17):
        for alpha in (0.01, 0.05, 0.3, 1.0):
            assert A._capacity(n, S.BLOCK, alpha) == \
                JA._capacity(n, S.BLOCK, alpha), (n, alpha)


def _triple(seed, C, n):
    """Masked (sW, sM, sV) sharing dW's support, and integer weights."""
    sw = _masked(seed, C, n, 0.05)
    rng = np.random.default_rng(seed + 1)
    sm = np.where(sw != 0, rng.standard_normal((C, n)), 0).astype(np.float32)
    sv = np.where(sw != 0, np.abs(rng.standard_normal((C, n))),
                  0).astype(np.float32)
    w = rng.integers(1, 50, C).astype(np.float32)
    return sw, sm, sv, w


@pytest.mark.parametrize("value_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("sort_free", [True, False])
def test_sparse_gather_sums_bitwise_vs_jax(value_dtype, sort_free):
    """The shared and the independent COO transports, two leaves (one of
    them a matrix) of 5 clients."""
    C = 5
    sw, sm, sv, w = _triple(2, C, 30_000)
    shapes = {"a": (C, 30_000), "b": (C, 100, 300)}
    tree = lambda x: {k: x.reshape(s) for k, s in shapes.items()}
    jt = lambda x: {k: jnp.asarray(v) for k, v in tree(x).items()}
    tt = lambda x: {k: torch.from_numpy(v.copy()) for k, v in tree(x).items()}
    ref = JA.sparse_shared_gather_sum(jt(sw), jt(sm), jt(sv), 0.05,
                                      jnp.asarray(w), value_dtype, sort_free)
    out = A.sparse_shared_gather_sum(tt(sw), tt(sm), tt(sv), 0.05,
                                     torch.from_numpy(w), value_dtype,
                                     sort_free)
    for name, a, b in zip("WMV", out, ref):
        for k in shapes:
            assert a[k].shape == shapes[k][1:]
            assert_bitwise(a[k], np.asarray(b[k]), f"shared {name}[{k}]")
    ref = JA.sparse_independent_gather_sum(jt(sm), 0.05, jnp.asarray(w),
                                           value_dtype, sort_free)
    out = A.sparse_independent_gather_sum(tt(sm), 0.05, torch.from_numpy(w),
                                          value_dtype, sort_free)
    for k in shapes:
        assert_bitwise(out[k], np.asarray(ref[k]), f"independent[{k}]")


def test_ordered_weighted_sum_bitwise_vs_eager_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 1000)).astype(np.float32)
    w = rng.standard_normal(5).astype(np.float32)
    out = A.ordered_weighted_sum({"a": torch.from_numpy(x)},
                                 torch.from_numpy(w))["a"]
    with jax.disable_jit():
        ref = JA.ordered_weighted_sum({"a": jnp.asarray(x)},
                                      jnp.asarray(w))["a"]
    assert_bitwise(out, np.asarray(ref), "eager")
    # compiled, XLA fuses each step into one FMA: exactly this fold (a
    # float32 product is exact in float64; the sum rounds once)
    fma = np.zeros(1000, np.float32)
    for c in range(5):
        fma = (fma.astype(np.float64) + np.float64(w[c])
               * x[c].astype(np.float64)).astype(np.float32)
    compiled = JA.ordered_weighted_sum({"a": jnp.asarray(x)},
                                       jnp.asarray(w))["a"]
    assert_bitwise(np.asarray(compiled), fma, "compiled = FMA fold")


def test_dense_weighted_sum_within_summation_bound():
    rng = np.random.default_rng(4)
    C = 20
    x = rng.standard_normal((C, 4096)).astype(np.float32)
    w = rng.integers(0, 40, C).astype(np.float32)
    out = A.dense_weighted_sum({"a": torch.from_numpy(x)},
                               torch.from_numpy(w))["a"].numpy()
    ref = np.asarray(JA.dense_weighted_sum({"a": jnp.asarray(x)},
                                           jnp.asarray(w))["a"])
    exact = (w[:, None].astype(np.float64) * x).sum(0)
    bound = C * EPS32 * (np.abs(w[:, None].astype(np.float64) * x)).sum(0)
    for got in (out, ref):
        assert np.all(np.abs(got - exact) <= bound / 2)
    assert np.all(np.abs(out.astype(np.float64) - ref) <= bound)


@pytest.mark.parametrize("algorithm", ["fedadam_ssm", "fedadam_top",
                                       "efficient_adam"])
def test_wire_gather_sum_bitwise_equals_scan_fold(algorithm):
    """Client payloads stacked, decoded and folded in client order give
    the scan round's sums bit for bit: ``acc + w * decode(payload_c)``."""
    C = 4
    fed = FedConfig(algorithm=algorithm, alpha=0.05, exact_topk=False,
                    error_feedback=True, n_clients=C,
                    sparsify_backend="kernel")
    comp = compressors.make_compressor(fed)
    rng = np.random.default_rng(5)
    like = {"a": torch.zeros(3000), "b": torch.zeros(40, 70)}
    w = torch.from_numpy(rng.integers(1, 9, C).astype(np.float32))
    payloads = []
    acc = [T.tree_map(torch.zeros_like, like) for _ in range(3)]
    for c in range(C):
        d = [T.tree_map(lambda x: torch.from_numpy(
            rng.standard_normal(tuple(x.shape)).astype(np.float32)), like)
            for _ in range(3)]
        if algorithm == "efficient_adam":
            d[1] = d[2] = T.tree_map(torch.zeros_like, like)
        packed, _, _ = comp.compress(Deltas(*d), comp.init_state(like))
        payloads.append(packed.wire)
        dec = comp.unpack_wire(packed.wire, like)
        acc = [T.tree_map(lambda a, y: a + w[c] * y.float(), a, s)
               for a, s in zip(acc, dec)]
    out = A.wire_gather_sum(comp, stack_payloads(payloads), like, w)
    via = A.packed_gather_sum(comp, None, None, None, w, alpha=0.05,
                              payload_c=stack_payloads(payloads), like=like)
    for name, a, b, v in zip("WMV", out, acc, via):
        for k in like:
            assert_bitwise(a[k], b[k], f"{name}[{k}]")
            assert_bitwise(v[k], b[k], f"packed_gather_sum {name}[{k}]")
