"""The port's kernel families against the JAX package's.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold the plain versions BITWISE against the JAX package on the same
numpy inputs: the wirepack kernels run in Pallas interpret mode; the
packed_topk kernels are held against their jnp oracles
(``packed_hist_ref``, ``packed_apply_ef_ref``), which replay the kernels'
block order exactly, because ``packed_hist_2d``/``packed_apply_2d`` call
``pl.load``/``pl.store``, which the installed jax no longer has.  Counts
are integers and the apply is a select plus elementwise casts, so no
tolerance applies anywhere in this file.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise
from _torch_parity import rand_leaves
from repro.core import sparsify as JS
from repro.kernels.packed_topk import ref as jpref
from repro.kernels.topk_mask import ref as jtmref
from repro.kernels.wirepack import ref as jwref
from repro.kernels.wirepack import wirepack as jwp
from repro_torch.core import sparsify as S
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.packed_topk import ops as P
from repro_torch.kernels.packed_topk import ref as pref
from repro_torch.kernels.topk_mask import ref as tmref
from repro_torch.kernels.wirepack import ops as W

ALPHA = 0.05
# a multi-block leaf, a sub-tile leaf, an exact-tile 2-D leaf and an
# all-zero leaf (its segment has absmax 0: every edge is 0)
SHAPES = [(9001,), (37,), (8, 1024), (50,)]


def _leaves(seed, scale=1.0):
    leaves = rand_leaves(seed, SHAPES, scale)
    leaves[3] = np.zeros(SHAPES[3], np.float32)
    return leaves


def _groups(scope):
    return None if scope == "per_tensor" else [0] * len(SHAPES)


def _select_inputs(leaves_np, groups):
    """JAX layout + eager select inputs (edges, c1, taus2, ks, ns, absmax)
    from the JAX oracle histogram, shared by both sides."""
    jl = [jnp.asarray(x) for x in leaves_np]
    layout = JS.plan_packed_layout(jl, groups)
    xp = layout.pack(jl)
    ks = jnp.asarray([JS.k_for(n, ALPHA) for n in layout.seg_sizes],
                     jnp.float32)
    ns = jnp.asarray(layout.seg_sizes, jnp.float32)
    absmax = JS._segment_absmax(layout, jl)
    edges = jnp.stack([jtmref.log2_taus(a) for a in absmax])
    c1 = jpref.packed_hist_ref(xp, layout.seg_ids, edges)
    taus2 = jpref.refine_taus(c1, edges, absmax, ks)
    return layout, xp, edges, c1, taus2, ks, ns, absmax


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("scope", ["per_tensor", "global"])
def test_packed_hist_plain_matches_jax(scope):
    layout, xp, edges, c1_ref, *_ = _select_inputs(_leaves(1), _groups(scope))
    c1 = P.packed_hist(_t(xp), _t(layout.seg_ids), _t(edges))
    assert c1.dtype == torch.float32 and c1.shape == (layout.num_segments, 32)
    assert_bitwise(c1, c1_ref, "vs packed_hist_ref")


@pytest.mark.parametrize("scope", ["per_tensor", "global"])
def test_log2_and_refine_taus_match_eager_jax(scope):
    layout, xp, edges, c1, taus2, ks, ns, absmax = _select_inputs(
        _leaves(2), _groups(scope))
    t_absmax = _t(jnp.stack(absmax))
    t_edges = tmref.log2_taus(t_absmax)
    assert_bitwise(t_edges, edges, "log2_taus")
    t_taus2 = pref.refine_taus(_t(c1), t_edges, t_absmax, _t(ks))
    assert_bitwise(t_taus2, taus2, "refine_taus")


def test_log2_factors_reach_a_device_once():
    """log2_taus copies its host factors to a device once, not per call:
    on a CUDA device each such copy would sync the stream."""
    a = torch.tensor([1.0, 3.0])
    tmref.log2_taus(a)
    hits, misses = (tmref._log2_factors.cache_info().hits,
                    tmref._log2_factors.cache_info().misses)
    tmref.log2_taus(2 * a)
    info = tmref._log2_factors.cache_info()
    assert (info.hits, info.misses) == (hits + 1, misses)


@pytest.mark.parametrize("has_score,value_dtype,with_residual", [
    (False, None, True), (False, "bfloat16", True), (True, None, True),
    (True, "bfloat16", False)])
def test_packed_apply_plain_matches_jax(has_score, value_dtype,
                                        with_residual):
    leaves_w = _leaves(3)
    score_np = _leaves(4) if has_score else None
    layout, wp, _, _, taus2, ks, ns, _ = _select_inputs(
        score_np if has_score else leaves_w, None)
    jl = lambda ls: layout.pack([jnp.asarray(x) for x in ls])
    wp = jl(leaves_w)
    mp, vp = jl(_leaves(5, 0.1)), jl([np.abs(x) for x in _leaves(6, 0.01)])
    sp = jl(score_np) if has_score else None
    ref = jpref.packed_apply_ef_ref(taus2, layout.seg_ids, ks, ns,
                                    (wp, mp, vp), sp,
                                    with_residual=with_residual,
                                    value_dtype=value_dtype)
    out = P.packed_apply(_t(taus2), _t(layout.seg_ids), _t(ks), _t(ns),
                         (_t(wp), _t(mp), _t(vp)),
                         None if sp is None else _t(sp),
                         with_residual=with_residual,
                         value_dtype=value_dtype)
    assert len(out) == len(ref) == (6 if with_residual else 5)
    names = ["sw", "sm", "sv"] + (["err"] if with_residual else []) + \
        ["taus", "counts"]
    for name, a, b in zip(names, out, ref):
        assert_bitwise(a, b, name)


def test_packed_apply_single_stream_matches_jax():
    layout, xp, _, _, taus2, ks, ns, _ = _select_inputs(_leaves(7), None)
    ref = jpref.packed_mask_apply_ref(taus2, layout.seg_ids, ks, ns, xp,
                                      value_dtype="bfloat16")
    out = P.packed_apply(_t(taus2), _t(layout.seg_ids), _t(ks), _t(ns),
                         (_t(xp),), value_dtype="bfloat16")
    for a, b in zip(out, ref):
        assert_bitwise(a, b, "single stream")


def test_packed_apply_rejects_unknown_value_dtype():
    x = torch.zeros((8, 128))
    with pytest.raises(ValueError):
        P.packed_apply(torch.zeros((1, 32)), torch.zeros(1, dtype=torch.int32),
                       torch.ones(1), torch.ones(1), (x, x, x),
                       value_dtype="float8_e4m3fn")


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pack_unpack_words_plain_match_jax(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2 ** bits, size=(96, 128)).astype(np.int32)
    words_k = jwp.pack_words_2d(jnp.asarray(codes), bits=bits,
                                interpret=True)
    words = W.pack_words(_t(codes), bits)
    assert words.dtype == torch.uint32 and words.shape == (96 * bits // 32,
                                                           128)
    assert_bitwise(words, words_k, "pack vs pack_words_2d")
    assert_bitwise(words, jwref.pack_words_ref(jnp.asarray(codes), bits),
                   "pack vs pack_words_ref")
    back_k = jwp.unpack_words_2d(words_k, bits=bits, interpret=True)
    back = W.unpack_words(words, bits)
    assert_bitwise(back, back_k, "unpack vs unpack_words_2d")
    assert_bitwise(back, codes, "round trip")


def test_pack_words_rejects_unsupported_bits():
    with pytest.raises(ValueError):
        W.pack_words(torch.zeros((32, 128), dtype=torch.int32), 3)


def test_plain_versions_touch_no_launch_counter():
    reset_launches()
    leaves = [torch.from_numpy(x) for x in _leaves(8)]
    layout = S.plan_packed_layout(leaves)
    xp = layout.pack(leaves)
    P.packed_hist(xp, layout.seg_ids, torch.ones((4, 32)))
    W.unpack_mask_bits(W.pack_mask_bits(torch.zeros((32, 128), dtype=bool)))
    assert set(LAUNCHES.values()) == {0}


def test_overselect_bound_matches_jax():
    from repro.kernels.topk_mask.ops import overselect_bound
    for k in (1, 7, 100, 24_000, 10 ** 6):
        for n in (None, k + 3, 10 * k):
            assert tmref.overselect_bound(k, n) == overselect_bound(k, n)
