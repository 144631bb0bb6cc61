"""The port's sparsify, mask and wire modules against the JAX package.

Bitwise: the packed layout, the packed shared-mask compress on the kernel
backend (the port on the CPU runs its kernels' plain versions; the JAX
side runs its kernel backend with the packed_topk kernels routed through
their jnp oracles, see ``_torch_parity.jax_packed_oracles``), the
reference- and kernel-backend masks, FedAdam-Top's packed independent
compress, and the shared- and independent-mask wire payloads (words and
value streams byte-identical, the JAX words packed by the wirepack kernel
in interpret mode).  The byte accounting is exact integer arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_bitwise, assert_tree_bitwise,  # noqa: F401
                           jax_packed_oracles, np_tree, to_jax, to_torch)
from repro.core import comm as jcomm
from repro.core import masks as JM
from repro.core import sparsify as JS
from repro.core import wire as JW
from repro_torch.core import comm, masks
from repro_torch.core import sparsify as S
from repro_torch.core import wire as W
from repro_torch.kernels.topk_mask.ref import overselect_bound

ALPHA = 0.05
SHAPES = [(9001,), (37,), (8, 1024), (3, 5, 7), (2000,)]


def _deltas(seed, shapes=SHAPES):
    return (np_tree(seed, shapes), np_tree(seed + 1, shapes, 0.1),
            np_tree(seed + 2, shapes, 0.01, absval=True))


def _j_leaves(tree):
    return jax.tree_util.tree_leaves(to_jax(tree))


@pytest.mark.parametrize("scope", ["per_tensor", "global"])
def test_packed_layout_matches_jax(scope):
    dW = np_tree(0, SHAPES)
    groups = None if scope == "per_tensor" else [0] * len(SHAPES)
    jl = _j_leaves(dW)
    tl = [dW[k] for k in sorted(dW)]
    jlay = JS.plan_packed_layout(jl, groups)
    tlay = S.plan_packed_layout([torch.from_numpy(x) for x in tl], groups)
    for field in ("shapes", "sizes", "padded", "offsets", "seg_of_leaf",
                  "num_segments", "seg_sizes"):
        assert getattr(tlay, field) == getattr(jlay, field), field
    assert tlay.total == jlay.total and tlay.num_blocks == jlay.num_blocks
    assert_bitwise(tlay.seg_ids, jlay.seg_ids, "seg_ids")
    buf = tlay.pack([torch.from_numpy(x) for x in tl])
    assert_bitwise(buf, jlay.pack(jl), "packed buffer")
    for a, b in zip(tlay.unpack(buf), tl):
        assert_bitwise(a, b, "unpack")


@pytest.mark.parametrize("scope,rule,with_residual,value_dtype", [
    ("per_tensor", "ssm_w", True, None),
    ("per_tensor", "ssm_w", False, "bfloat16"),
    ("global", "ssm_w", True, None),
    ("per_tensor", "fairness_top", True, None),
])
def test_shared_compress_packed_matches_jax_kernel_backend(
        jax_packed_oracles, scope, rule, with_residual, value_dtype):
    dW, dM, dV = _deltas(10)
    jW, jM, jV = to_jax(dW), to_jax(dM), to_jax(dV)
    tW, tM, tV = to_torch(dW), to_torch(dM), to_torch(dV)
    ref = JS.tree_shared_compress_packed(
        JM.shared_score_tree(rule, jW, jM, jV), jW, jM, jV, ALPHA, scope,
        value_dtype=value_dtype, with_residual=with_residual)
    out = S.tree_shared_compress_packed(
        masks.shared_score_tree(rule, tW, tM, tV), tW, tM, tV, ALPHA, scope,
        value_dtype=value_dtype, with_residual=with_residual)
    for name, a, b in zip(("sW", "sM", "sV", "err", "mask"), out, ref):
        if b is None:
            assert a is None, name
        else:
            assert_tree_bitwise(a, b, name)


def test_packed_compress_keeps_the_overselect_contract():
    dW, dM, dV = _deltas(20, [(50_000,), (9001,), (2048,)])
    tW, tM, tV = to_torch(dW), to_torch(dM), to_torch(dV)
    *_, mask = S.tree_shared_compress_packed(None, tW, tM, tV, ALPHA)
    for name, m in mask.items():
        n = m.numel()
        k = S.k_for(n, ALPHA)
        got = int(m.sum())
        assert k <= got <= k + overselect_bound(k, n), (name, k, got)


@pytest.mark.parametrize("exact", [True, False])
def test_reference_backend_masks_match_jax(exact):
    dW, dM, dV = _deltas(30)
    ref = JM.shared_mask("ssm_w", to_jax(dW), to_jax(dM), to_jax(dV),
                         ALPHA, exact=exact, backend="reference")
    out = masks.shared_mask("ssm_w", to_torch(dW), to_torch(dM),
                            to_torch(dV), ALPHA, exact=exact,
                            backend="reference")
    assert_tree_bitwise(out, ref, "mask")


def test_resolve_backend_precedence(monkeypatch):
    monkeypatch.delenv(S.SPARSIFY_BACKEND_ENV, raising=False)
    # the JAX package's variable never flips the port
    monkeypatch.setenv("REPRO_SPARSIFY_BACKEND", "kernel")
    assert S.resolve_backend() == "reference"
    assert S.resolve_backend(device=torch.device("cpu")) == "reference"
    assert S.resolve_backend(device="cuda") == "kernel"
    monkeypatch.setenv(S.SPARSIFY_BACKEND_ENV, "kernel")
    assert S.resolve_backend() == "kernel"
    assert S.resolve_backend("reference", device="cuda") == "reference"
    monkeypatch.setenv(S.SPARSIFY_BACKEND_ENV, "nonsense")
    with pytest.raises(ValueError):
        S.resolve_backend()


def test_per_leaf_kernel_paths_raise_until_ported():
    """Every per-leaf kernel path is ported now (the name dates from when
    one raised).  The per-leaf fused compress (rows 6, 7 and 9: its parity
    is tests/test_torch_perleaf_kernels.py's) equals the packed path on a
    uniform tree, and threshold MASKS on the kernel backend (row 8's
    apply_mask after the selection passes) equal the JAX package's, whose
    topk_mask kernels run in interpret mode: bitwise, per tensor and
    global."""
    dW, dM, dV = _deltas(40)
    tW, tM, tV = (to_torch(t) for t in (dW, dM, dV))
    per_leaf = S.tree_shared_compress_fused(None, tW, tM, tV, ALPHA,
                                            packed=False, with_residual=True)
    packed = S.tree_shared_compress_fused(None, tW, tM, tV, ALPHA,
                                          with_residual=True)
    for a, b in zip(per_leaf, packed):
        assert_tree_bitwise(a, b, "per-leaf vs packed")
    for scope in ("per_tensor", "global"):
        ref = JS.tree_topk_masks(to_jax(dW), ALPHA, scope, exact=False,
                                 backend="kernel")
        out = S.tree_topk_masks(tW, ALPHA, scope, exact=False,
                                backend="kernel")
        assert_tree_bitwise(out, ref, f"{scope} kernel-backend masks")


@pytest.mark.parametrize("exact,backend", [
    (True, "reference"), (False, "reference"), (False, "kernel")])
def test_independent_masks_match_jax(exact, backend):
    dW, dM, dV = _deltas(35)
    ref = JM.independent_masks(to_jax(dW), to_jax(dM), to_jax(dV), ALPHA,
                               exact=exact, backend=backend)
    out = masks.independent_masks(to_torch(dW), to_torch(dM), to_torch(dV),
                                  ALPHA, exact=exact, backend=backend)
    assert len(out) == 3
    for i, (a, b) in enumerate(zip(out, ref)):
        assert_tree_bitwise(a, b, f"mask {i}")


@pytest.mark.parametrize("scope,with_residual,value_dtype", [
    ("per_tensor", True, None),
    ("per_tensor", False, "bfloat16"),
    ("global", True, None),
    ("global", False, None),
])
def test_independent_compress_packed_matches_jax_kernel_backend(
        jax_packed_oracles, scope, with_residual, value_dtype):
    """FedAdam-Top's packed compress (3L segments per tensor, 3 global):
    sparse triple, EF residual and the three masks, bitwise."""
    dW, dM, dV = _deltas(15)
    ref = JS.tree_independent_compress_packed(
        to_jax(dW), to_jax(dM), to_jax(dV), ALPHA, scope,
        value_dtype=value_dtype, with_residual=with_residual)
    out = S.tree_independent_compress_packed(
        to_torch(dW), to_torch(dM), to_torch(dV), ALPHA, scope,
        value_dtype=value_dtype, with_residual=with_residual)
    for name, a, b in zip(("sW", "sM", "sV", "err"), out[:4], ref[:4]):
        if b is None:
            assert a is None, name
        else:
            assert_tree_bitwise(a, b, name)
    assert isinstance(out[4], tuple) and len(out[4]) == 3
    for i, (a, b) in enumerate(zip(out[4], ref[4])):
        assert_tree_bitwise(a, b, f"mask {i}")
    # each stream's masks keep the over-selection contract of its own k
    if scope == "per_tensor":
        for m in out[4]:
            for leaf in m.values():
                n, got = leaf.numel(), int(leaf.sum())
                k = S.k_for(n, ALPHA)
                assert k <= got <= k + overselect_bound(k, n)


def _sparse_carriers(seed):
    dW, dM, dV = _deltas(seed)
    tW, tM, tV = (to_torch(t) for t in (dW, dM, dV))
    sW, sM, sV, _, _ = S.tree_shared_compress_packed(None, tW, tM, tV, ALPHA)
    return sW, sM, sV


def test_pack_shared_mask_matches_jax(monkeypatch):
    # the JAX words come from the wirepack Pallas kernel (interpret mode)
    monkeypatch.setenv("REPRO_SPARSIFY_BACKEND", "kernel")
    sW, sM, sV = _sparse_carriers(50)
    sizes = tuple(x.numel() for x in sW.values())
    cap = W.mask_value_capacity(sizes, ALPHA, exact_topk=False)
    assert cap == JW.mask_value_capacity(sizes, ALPHA, exact_topk=False)
    pay = W.pack_shared_mask(sW, sM, sV, cap)
    jpay = JW.pack_shared_mask(*(to_jax({k: v.numpy() for k, v in t.items()})
                                 for t in (sW, sM, sV)), cap)
    assert len(pay.words) == 1 and len(pay.values) == 3 and not pay.scales
    assert_bitwise(pay.words[0], jpay.words[0], "bitmap words")
    for i, (a, b) in enumerate(zip(pay.values, jpay.values)):
        assert_bitwise(a, b, f"value stream {i}")
    nbytes = W.payload_nbytes(pay)
    assert nbytes == JW.payload_nbytes(jpay)
    assert 8 * nbytes == W.mask_wire_bits(sizes, ALPHA, exact_topk=False)
    for a, b in zip(W.unpack_shared_mask(pay, sW), (sW, sM, sV)):
        assert_tree_bitwise(a, b, "round trip")


def test_pack_independent_mask_matches_jax(monkeypatch):
    """FedAdam-Top's wire: three bitmaps (the JAX words from the wirepack
    kernel in interpret mode) and three value streams, byte-identical."""
    monkeypatch.setenv("REPRO_SPARSIFY_BACKEND", "kernel")
    dW, dM, dV = (to_torch(t) for t in _deltas(55))
    sW, sM, sV, _, _ = S.tree_independent_compress_packed(dW, dM, dV, ALPHA)
    sizes = tuple(x.numel() for x in sW.values())
    cap = W.mask_value_capacity(sizes, ALPHA, exact_topk=False)
    pay = W.pack_independent_mask(sW, sM, sV, cap)
    jpay = JW.pack_independent_mask(
        *(to_jax({k: v.numpy() for k, v in t.items()})
          for t in (sW, sM, sV)), cap)
    assert len(pay.words) == len(pay.values) == 3 and not pay.scales
    for i in range(3):
        assert_bitwise(pay.words[i], jpay.words[i], f"bitmap words {i}")
        assert_bitwise(pay.values[i], jpay.values[i], f"value stream {i}")
    nbytes = W.payload_nbytes(pay)
    assert nbytes == JW.payload_nbytes(jpay)
    assert 8 * nbytes == W.mask_wire_bits(sizes, ALPHA, exact_topk=False,
                                          shared=False)
    for a, b in zip(W.unpack_independent_mask(pay, sW), (sW, sM, sV)):
        assert_tree_bitwise(a, b, "round trip")


def test_compact_drops_overflow_past_capacity():
    sW, sM, sV = _sparse_carriers(60)
    pay = W.pack_shared_mask(sW, sM, sV, capacity=5)
    back = W.unpack_shared_mask(pay, sW)[0]
    kept = sum(int((v != 0).sum()) for v in back.values())
    assert kept == 5


@pytest.mark.parametrize("scope", ["per_tensor", "global"])
@pytest.mark.parametrize("exact", [True, False])
def test_mask_wire_bits_match_jax(scope, exact):
    for sizes in [(1,), (37, 9001), (800, 51200, 401408, 1280),
                  (3 * (1 << 20) + 5, 64)]:
        for alpha in (0.01, 0.05, 0.5):
            for shared in (True, False):
                assert W.mask_wire_bits(sizes, alpha, scope, exact,
                                        shared=shared) == \
                    JW.mask_wire_bits(sizes, alpha, scope, exact,
                                      shared=shared)
            assert comm.bits_for("fedadam_ssm", 0, 0, 3, sizes=sizes,
                                 alpha=alpha, mask_scope=scope,
                                 exact_topk=exact) == \
                jcomm.bits_for("fedadam_ssm", 0, 0, 3, sizes=sizes,
                               alpha=alpha, mask_scope=scope,
                               exact_topk=exact)


def test_full_width_cnn_wire_numbers():
    """The paper's CNN at width 1.0 (conv1, conv2, fc1, fc2 leaves)."""
    sizes = (5 * 5 * 1 * 32, 5 * 5 * 32 * 64, 3136 * 128, 128 * 10)
    assert sum(sizes) == 454_688
    assert W.padded_total(sizes) == 455_680
    assert W.aligned_total(sizes) == 458_752
    assert W.mask_value_capacity(sizes, 0.05, exact_topk=False) == 24_128
    assert W.mask_wire_bits(sizes, 0.05, exact_topk=False) // 8 == 346_880
    # FedAdam-Top: three (bitmap, stream) pairs
    assert W.mask_wire_bits(sizes, 0.05, exact_topk=False,
                            shared=False) // 8 == 461_568
    assert W.dense_wire_bits(sizes) // 8 == 5_456_256
