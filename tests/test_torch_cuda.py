"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips (from inside the test) where
no card is present.  The file imports neither ``jax`` nor the JAX
package, so it also runs on a machine that has only PyTorch; there the
repository's ``tests/conftest.py`` (which imports jax) is skipped:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Counts are integers, the masks compares, and the applies selects plus
elementwise casts, so every comparison is bitwise; so is the fused Adam, whose kernel rounds
every product and sum as the plain version's separate float32 ops do and
takes the same root (rsqrtf).  The per-leaf kernels run in float32 and
bfloat16 at lengths that exercise the vector loop, the ragged tail and a
misaligned view.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise, cuda_device  # noqa: F401
from _torch_parity import (COUNT_CASES, ThreadGroup, count_edge_cases,
                           packed_edge_cases, rand_leaves, shuffle_blocks,
                           taus_sorted)
from repro_torch.core import sparsify as S
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.packed_topk import ops as P
from repro_torch.kernels.packed_topk import ref as pref
from repro_torch.kernels.topk_mask import ref as tmref
from repro_torch.kernels.wirepack import ops as W
from repro_torch.kernels.fused_adam import ops as FA
from repro_torch.kernels.ssm_apply import ops as SSM
from repro_torch.kernels.topk_mask import ops as TM
from repro_torch.optim import AdamHyper

ALPHA = 0.05
# a multi-block leaf, a sub-tile leaf, an exact-tile 2-D leaf and an
# all-zero leaf (its segment has absmax 0: every edge is 0)
SHAPES = [(9001,), (37,), (8, 1024), (50,)]


def _cuda_case(device, seed=9):
    leaves = rand_leaves(seed, SHAPES)
    leaves[3] = np.zeros(SHAPES[3], np.float32)
    leaves = [torch.from_numpy(x).to(device) for x in leaves]
    layout = S.plan_packed_layout(leaves)
    xp = layout.pack(leaves)
    ks, ns = layout.ks_ns(ALPHA)
    absmax = S._segment_absmax(layout, leaves)
    edges = tmref.log2_taus(absmax)
    return layout, xp, edges, ks, ns, absmax


@pytest.mark.cuda
def test_cuda_packed_hist_matches_plain(cuda_device):
    layout, xp, edges, *_ = _cuda_case(cuda_device)
    reset_launches()
    c1 = P.packed_hist(xp, layout.seg_ids, edges)
    assert LAUNCHES["packed_hist"] == 1
    assert_bitwise(c1, P.packed_hist_plain(xp, layout.seg_ids, edges))


@pytest.mark.cuda
@pytest.mark.parametrize("value_dtype", [None, "bfloat16", "float16"])
def test_cuda_packed_apply_matches_plain(cuda_device, value_dtype):
    layout, xp, edges, ks, ns, absmax = _cuda_case(cuda_device)
    c1 = P.packed_hist(xp, layout.seg_ids, edges)
    taus2 = pref.refine_taus(c1, edges, absmax, ks)
    assert_bitwise(taus2, pref.refine_taus(c1.cpu(), edges.cpu(),
                                           absmax.cpu(), ks.cpu()),
                   "refine rows on the card vs the CPU")
    streams = (xp, xp * 0.5, xp.abs())
    for score in (None, xp.flip(0)):
        a = P.packed_apply(taus2, layout.seg_ids, ks, ns, streams, score,
                           value_dtype=value_dtype)
        b = P.packed_apply_plain(taus2, layout.seg_ids, ks, ns, streams,
                                 score, value_dtype=value_dtype)
        for x, y in zip(a, b):
            assert_bitwise(x, y, f"score={score is not None}")


@pytest.mark.cuda
@pytest.mark.parametrize("with_residual", [False, True])
def test_cuda_packed_apply_single_stream_matches_plain(cuda_device,
                                                       with_residual):
    """FedAdam-Top's call: one stream, its own score, the residual (when
    asked) over every row."""
    layout, xp, edges, ks, ns, absmax = _cuda_case(cuda_device)
    taus2 = pref.refine_taus(P.packed_hist(xp, layout.seg_ids, edges),
                             edges, absmax, ks)
    reset_launches()
    a = P.packed_apply(taus2, layout.seg_ids, ks, ns, (xp,),
                       with_residual=with_residual)
    assert LAUNCHES["packed_apply"] == 1
    b = P.packed_apply_plain(taus2, layout.seg_ids, ks, ns, (xp,),
                             with_residual=with_residual)
    assert len(a) == len(b) == 1 + with_residual + 2
    for x, y in zip(a, b):
        assert_bitwise(x, y, f"with_residual={with_residual}")


@pytest.mark.cuda
@pytest.mark.parametrize("scope", ["per_tensor", "global"])
def test_cuda_independent_compress_packed_matches_cpu(cuda_device, scope):
    """FedAdam-Top's packed compress (3L or 3 segments) on the card against
    the same call on the CPU, which runs the kernels' plain versions."""
    trees = [dict(enumerate(rand_leaves(seed, SHAPES))) for seed in (3, 4, 5)]
    trees[2] = {k: np.abs(v) for k, v in trees[2].items()}
    on = lambda dev: [{k: torch.from_numpy(v).to(dev) for k, v in t.items()}
                      for t in trees]
    reset_launches()
    a = S.tree_independent_compress_packed(*on(cuda_device), ALPHA, scope,
                                           with_residual=True)
    assert LAUNCHES["packed_hist"] == 2 and LAUNCHES["packed_apply"] == 1
    b = S.tree_independent_compress_packed(*on("cpu"), ALPHA, scope,
                                           with_residual=True)
    for i, (ta, tb) in enumerate(zip(a[:4], b[:4])):
        for k in ta:
            assert_bitwise(ta[k].cpu(), tb[k], f"output {i} leaf {k}")
    for ma, mb in zip(a[4], b[4]):
        for k in ma:
            assert torch.equal(ma[k].cpu(), mb[k])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_cuda_pack_unpack_words_match_plain(cuda_device, bits):
    codes = torch.randint(0, 2 ** bits, (256, 128), dtype=torch.int32,
                          device=cuda_device)
    words = W.pack_words(codes, bits)
    assert_bitwise(words, W.pack_words_plain(codes, bits))
    assert_bitwise(W.unpack_words(words, bits),
                   W.unpack_words_plain(words, bits))
    assert_bitwise(W.unpack_words(words, bits), codes)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    codes = torch.zeros((32, 128), dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        W.pack_words(codes, 1)
    with pytest.raises(ValueError):
        W.pack_words(torch.zeros((33, 128), dtype=torch.int32,
                                 device=cuda_device), 1)
    layout, xp, edges, *_ = _cuda_case(cuda_device)
    with pytest.raises(ValueError):
        P.packed_hist(xp, layout.seg_ids.cpu(), edges)


def _device_ops(fn, iters=10):
    """Device operations (kernels, fills, copies) per call of ``fn``, from
    torch.profiler.  The profiler drops a record now and then, so the
    count is rounded, and a window that saw none is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
        if n:
            return round(n / iters)
    return 0


def _ks_ns(seg_ids, L):
    """ks/ns of ALPHA over each segment's blocks (padding included)."""
    ns = torch.bincount(seg_ids.long().cpu(), minlength=L).to(
        torch.float32) * P.BLOCK_ELEMS
    ks = torch.tensor([float(S.k_for(int(n), ALPHA)) for n in ns])
    return ks.to(seg_ids.device), ns.to(seg_ids.device)


def _check_packed(xp, seg_ids, edges, what):
    """packed_hist, and packed_apply with ``edges`` as its candidates over
    three streams (with a score, a cast and the residual) and over one,
    bitwise against the plain versions."""
    assert_bitwise(P.packed_hist(xp, seg_ids, edges),
                   P.packed_hist_plain(xp, seg_ids, edges), f"{what} hist")
    ks, ns = _ks_ns(seg_ids, edges.shape[0])
    streams = (xp, xp * 0.5, xp.abs())
    for args, kw in (((streams, xp.flip(0)), {"value_dtype": "bfloat16"}),
                     (((xp,),), {})):
        a = P.packed_apply(edges, seg_ids, ks, ns, *args, **kw)
        b = P.packed_apply_plain(edges, seg_ids, ks, ns, *args, **kw)
        assert len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bitwise(x, y, f"{what} apply output {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["packed", "interleaved"])
def test_cuda_packed_edge_cases_match_plain(cuda_device, order):
    """The count's edge cases as segments of one cohort (ties among edges,
    all-zero and single-element segments, infinities and NaN elements, NaN
    and unsorted edges, signed zeros, subnormals, the log2 and a refine
    row): both kernels bitwise against their plain versions, with the
    blocks in order and shuffled (a segment change at almost every
    block)."""
    xp, seg_ids, edges, _ = packed_edge_cases()
    if order == "interleaved":
        xp, seg_ids = shuffle_blocks(xp, seg_ids, 3)
    _check_packed(xp.to(cuda_device), seg_ids.to(cuda_device),
                  edges.to(cuda_device), order)


def _cohort(device, L, nb=4000, seed=30):
    """About ``nb`` blocks in L segments of uneven lengths (L = 1: one
    global segment over 12 leaves), with log2 edges per segment and their
    refine rows."""
    rng = np.random.default_rng(seed)
    n_leaves = 12 if L == 1 else L
    sizes = rng.integers(1, 2 * nb // n_leaves, size=n_leaves) * 1024 - \
        rng.integers(0, 1000, size=n_leaves)
    leaves = [torch.from_numpy(rng.standard_normal(int(n)).astype(
        np.float32) * 10.0 ** rng.uniform(-4, 0)).to(device) for n in sizes]
    layout = S.plan_packed_layout(leaves, [0] * n_leaves if L == 1 else None)
    xp = layout.pack(leaves)
    ks, _ = layout.ks_ns(ALPHA)
    absmax = S._segment_absmax(layout, leaves)
    edges = tmref.log2_taus(absmax)
    taus2 = pref.refine_taus(P.packed_hist_plain(xp, layout.seg_ids, edges),
                             edges, absmax, ks)
    return xp, layout.seg_ids, edges, taus2


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 4, 12, 300])
def test_cuda_packed_chunks_split_segments(cuda_device, L):
    """Cohorts of more blocks than the card keeps CTAs, so each count CTA
    walks a chunk of several blocks and segments change inside chunks and
    span several; L = 300 grows the workspace past every earlier call's."""
    xp, seg_ids, edges, taus2 = _cohort(cuda_device, L)
    nb = seg_ids.numel()
    shape = P.launch_shape(nb)
    assert shape["count"][1] > 1 and shape["pick"][1] > 1, shape
    assert shape["apply"][1] > 1, shape
    starts = torch.arange(0, nb, shape["count"][1], device=cuda_device)
    if L > 1:  # some chunk starts inside a segment's run of blocks
        assert bool((seg_ids[starts[1:]] == seg_ids[starts[1:] - 1]).any())
    for e, what in ((edges, "log2"), (taus2, "refine")):
        _check_packed(xp, seg_ids, e, f"L={L} {what}")


@pytest.mark.cuda
def test_cuda_packed_workspace_is_zero_after_each_call(cuda_device):
    """Each launch leaves its stream's workspace zero: on the current
    stream and on a second one (its own workspace), and across a call
    with more segments than the workspace held (it grows, zeroed)."""
    small = _cohort(cuda_device, 4, nb=600, seed=31)
    big = _cohort(cuda_device, 300, nb=900, seed=32)
    side = torch.cuda.Stream(cuda_device)
    for st in (torch.cuda.current_stream(cuda_device), side):
        st.wait_stream(torch.cuda.current_stream(cuda_device))
        for xp, seg_ids, edges, taus2 in (small, big, small):
            ks, ns = _ks_ns(seg_ids, edges.shape[0])
            with torch.cuda.stream(st):
                c = P.packed_hist(xp, seg_ids, edges)
                a = P.packed_apply(taus2, seg_ids, ks, ns, (xp,))
                ws = P._workspaces[(xp.device, st.cuda_stream)]
            st.synchronize()
            assert int(ws.count_nonzero()) == 0
            assert_bitwise(c, P.packed_hist_plain(xp, seg_ids, edges))
            b = P.packed_apply_plain(taus2, seg_ids, ks, ns, (xp,))
            for x, y in zip(a, b):
                assert_bitwise(x, y)
        assert ws.numel() >= 300 * 32 + 1
    assert len({id(w) for w in P._workspaces.values()}) >= 2


@pytest.mark.cuda
def test_cuda_packed_device_operations_per_call(cuda_device):
    """One device operation per packed_hist call (no fill, no cast) and
    two per packed_apply call (the count with the pick, the apply)."""
    xp, seg_ids, edges, taus2 = _cohort(cuda_device, 12, nb=445, seed=33)
    ks, ns = _ks_ns(seg_ids, 12)
    streams = (xp, xp * 0.5, xp.abs())
    assert _device_ops(lambda: P.packed_hist(xp, seg_ids, edges)) == 1
    assert _device_ops(lambda: P.packed_apply(taus2, seg_ids, ks, ns,
                                              streams)) == 2
    assert _device_ops(lambda: P.packed_apply(taus2, seg_ids, ks, ns,
                                              (xp,))) == 2


# ---------------------------------------------------------------------------
# Per-leaf kernels
# ---------------------------------------------------------------------------

LEAF_DTYPES = [torch.float32, torch.bfloat16]
# a vector-loop-only length, a ragged tail, a norm-scale length
LEAF_LENGTHS = [8192, 20001, 3072]


def _leaf(device, n, dtype, seed, scale=1.0, offset=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n + offset, generator=g, device=device) * scale
    return x.to(dtype)[offset:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", LEAF_DTYPES)
@pytest.mark.parametrize("n", LEAF_LENGTHS)
@pytest.mark.parametrize("bias", [False, True])
def test_cuda_fused_adam_matches_plain(cuda_device, dtype, n, bias):
    w, g, m = (_leaf(cuda_device, n, dtype, s, sc)
               for s, sc in ((1, 1.0), (2, 0.1), (3, 0.01)))
    v = _leaf(cuda_device, n, dtype, 4, 0.01).abs()
    h = AdamHyper(lr=3e-3, bias_correction=bias)
    scalars = FA.effective_scalars(h, 5, cuda_device)
    reset_launches()
    out = FA.fused_adam_apply(scalars, w, g, m, v)
    assert LAUNCHES["fused_adam"] == 1
    for a, b in zip(out, FA.fused_adam_plain(scalars, w, g, m, v)):
        assert a.dtype == dtype
        assert_bitwise(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", LEAF_DTYPES)
@pytest.mark.parametrize("n", LEAF_LENGTHS)
def test_cuda_absmax_count_select_match_plain(cuda_device, dtype, n):
    for offset in (0, 1):               # aligned, and a misaligned view
        x = _leaf(cuda_device, n, dtype, 7, offset=offset)
        reset_launches()
        am = TM.absmax(x)
        assert_bitwise(am, TM.absmax_plain(x))
        taus = tmref.log2_taus(am)
        assert_bitwise(TM.count_ge(taus, x), TM.count_ge_plain(taus, x))
        k = S.k_for(n, ALPHA)
        tau, count = TM.select_tau(x, k)
        assert LAUNCHES["absmax"] == 2 and LAUNCHES["count_ge"] == 3
        assert_bitwise(tau, tmref.select_tau_ref(x, k))
        assert k <= int(count) <= k + tmref.overselect_bound(k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", LEAF_DTYPES)
@pytest.mark.parametrize("n", LEAF_LENGTHS)
@pytest.mark.parametrize("value_dtype", [None, "bfloat16", "float16"])
def test_cuda_ssm_apply_ef_matches_plain(cuda_device, dtype, n,
                                         value_dtype):
    dw, dm, sc = (_leaf(cuda_device, n, dtype, s) for s in (8, 9, 10))
    dv = _leaf(cuda_device, n, dtype, 11).abs()
    tau = TM.select_tau(dw, S.k_for(n, ALPHA))[0]
    # a float32 score beside streams of either type (fairness_top's),
    # aligned and not (the scalar path)
    for score in (None, sc, sc.float(),
                  _on_card(sc.float(), cuda_device, 1)):
        for with_residual in (True, False):
            kw = dict(with_residual=with_residual, value_dtype=value_dtype)
            reset_launches()
            a = SSM.ssm_apply_ef(tau, dw, dm, dv, score, **kw)
            assert LAUNCHES["ssm_apply_ef"] == 1
            b = SSM.ssm_apply_ef_plain(tau, dw, dm, dv, score, **kw)
            assert len(a) == len(b) == 3 + with_residual
            for x, y in zip(a, b):
                assert x.dtype == dw.dtype
                assert_bitwise(x, y, f"score={score is not None}")


def _on_card(x, device, offset):
    """x copied to the card, as a view ``offset`` elements into its
    buffer (offset 1: not 16-byte aligned, the kernels' scalar path)."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=device)
    buf[offset:] = x.to(device)
    return buf[offset:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", LEAF_DTYPES)
@pytest.mark.parametrize("case", COUNT_CASES)
def test_cuda_count_ge_edge_cases_match_plain(cuda_device, dtype, case):
    """count_ge bitwise against its plain version on the count's edge
    cases, aligned and misaligned, with the leaf's zero padding counted:
    sorted candidates take the kernel's rank path, and the same
    candidates out of order its 32-compare path; one launch per call."""
    n = 20001
    taus, x, _ = count_edge_cases(n, dtype)[case]
    orders = [taus]
    if taus_sorted(taus):
        orders.append(taus[torch.randperm(32, generator=torch.Generator()
                                          .manual_seed(1))])
    for offset in (0, 1):
        xd = _on_card(x, cuda_device, offset)
        for t in orders:
            td = t.to(cuda_device)
            for pad in (0, (-n) % 8192):
                reset_launches()
                got = TM.count_ge(td, xd, pad)
                assert LAUNCHES["count_ge"] == 1
                assert_bitwise(got, TM.count_ge_plain(td, xd, pad),
                               f"offset={offset} sorted={taus_sorted(t)} "
                               f"pad={pad}")


@pytest.mark.cuda
def test_cuda_selection_workspace_is_zero_after_each_call(cuda_device):
    """absmax and count_ge leave their stream's workspace zeroed, and give
    the same results on a second stream (which gets its own workspace)."""
    x = _leaf(cuda_device, 1 << 20, torch.bfloat16, 21)
    want_am = TM.absmax_plain(x)
    taus = tmref.log2_taus(want_am)
    want_c = TM.count_ge_plain(taus, x)
    side = torch.cuda.Stream(cuda_device)
    for st in (torch.cuda.current_stream(cuda_device), side):
        st.wait_stream(torch.cuda.current_stream(cuda_device))
        with torch.cuda.stream(st):
            for _ in range(3):
                am, c = TM.absmax(x), TM.count_ge(taus, x)
            ws = TM._workspaces[(x.device, st.cuda_stream)]
        st.synchronize()
        assert_bitwise(am, want_am, "absmax")
        assert_bitwise(c, want_c, "count_ge")
        assert int(ws.count_nonzero()) == 0
    assert len({id(w) for w in TM._workspaces.values()}) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["zero", "subnormal"])
def test_cuda_select_tau_counts_the_padding(cuda_device, kind):
    """tau 0 on the card as on the CPU, and the achieved count with the
    JAX wrapper's zero padding: n + (-n mod 8192)."""
    n = 20001
    g = torch.Generator().manual_seed(22)
    scale = 0.0 if kind == "zero" else 0.2 * 2.0 ** -149
    x = torch.randn(n, generator=g, dtype=torch.float64) * scale
    x = x.to(torch.float32)
    k = S.k_for(n, ALPHA)
    tau, count = TM.select_tau(x.to(cuda_device), k)
    assert_bitwise(tau, TM.select_tau(x, k)[0])
    assert float(tau) == 0.0 and int(count) == n + (-n) % 8192


def _apply_cases(device, dtype, n):
    """(tau, x) pairs: aligned and misaligned views, tau 0 and an all-zero
    leaf, with select_tau's tau otherwise."""
    for offset in (0, 1):
        x = _leaf(device, n, dtype, 12, offset=offset)
        yield TM.select_tau(x, S.k_for(n, ALPHA))[0], x
    x = _leaf(device, n, dtype, 13)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    yield zero, x
    yield TM.select_tau(torch.zeros_like(x), S.k_for(n, ALPHA))[0], \
        torch.zeros_like(x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", LEAF_DTYPES)
@pytest.mark.parametrize("n", LEAF_LENGTHS + [7])
def test_cuda_apply_mask_matches_plain(cuda_device, dtype, n):
    for tau, x in _apply_cases(cuda_device, dtype, n):
        reset_launches()
        mask = TM.apply_mask(tau, x)
        assert LAUNCHES["apply_mask"] == 1
        assert mask.dtype == torch.bool and mask.shape == x.shape
        assert torch.equal(mask, TM.apply_mask_plain(tau, x))
        assert set(mask.view(torch.uint8).unique().tolist()) <= {0, 1}
    x = _leaf(cuda_device, n, dtype, 14)
    k = S.k_for(n, ALPHA)
    mask, tau, count = TM.topk_mask(x, k)
    assert torch.equal(mask, tmref.topk_mask_ref(x, k))
    assert int(mask.sum()) == int(count)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", LEAF_DTYPES)
@pytest.mark.parametrize("n", LEAF_LENGTHS + [7])
def test_cuda_ssm_apply_matches_plain(cuda_device, dtype, n):
    for tau, dw in _apply_cases(cuda_device, dtype, n):
        offset = dw.storage_offset()
        dm, dv = (_leaf(cuda_device, n, dtype, s, offset=offset)
                  for s in (15, 16))
        reset_launches()
        a = SSM.ssm_apply(tau, dw, dm, dv)
        assert LAUNCHES["ssm_apply"] == 1 and LAUNCHES["ssm_apply_ef"] == 0
        b = SSM.ssm_apply_plain(tau, dw, dm, dv)
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert x.dtype == dtype
            assert_bitwise(x, y, f"offset={offset}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float32, torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("n", LEAF_LENGTHS + [7])
def test_cuda_ssm_apply_mixed_dtypes_match_plain(cuda_device, dtypes, n):
    """dw, dm and dv each in its own dtype: each output in its input's
    dtype, bitwise against the plain version, aligned and misaligned."""
    for offset in (0, 1):
        dw, dm, dv = (_leaf(cuda_device, n, dt, s, offset=offset)
                      for dt, s in zip(dtypes, (17, 18, 19)))
        tau = TM.select_tau(dw, S.k_for(n, ALPHA))[0]
        reset_launches()
        a = SSM.ssm_apply(tau, dw, dm, dv)
        assert LAUNCHES["ssm_apply"] == 1
        b = SSM.ssm_apply_plain(tau, dw, dm, dv)
        for x, y, dt in zip(a, b, dtypes):
            assert x.dtype == dt
            assert_bitwise(x, y, f"offset={offset}")


@pytest.mark.cuda
def test_cuda_per_leaf_wrappers_reject_what_the_kernels_do_not_take(
        cuda_device):
    x = torch.zeros(64, dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError):
        TM.absmax(x)
    y = torch.zeros(64, device=cuda_device)
    with pytest.raises(TypeError):
        FA.fused_adam_apply(FA.effective_scalars(AdamHyper(), 0,
                                                 cuda_device),
                            y, y.to(torch.bfloat16), y, y)
    with pytest.raises(ValueError):
        SSM.ssm_apply_ef(torch.zeros((), device=cuda_device), y, y, y[:32],
                         None)
    tau = torch.zeros((), device=cuda_device)
    with pytest.raises(TypeError):
        TM.apply_mask(tau, x)
    with pytest.raises(ValueError):
        TM.apply_mask(tau.cpu(), y)
    with pytest.raises(TypeError):
        SSM.ssm_apply(tau, y, y, x)
    with pytest.raises(ValueError):
        SSM.ssm_apply(tau, y, y, y[:32])


# ---------------------------------------------------------------------------
# Exact top-k on ties; the sign and b-bit wire; the quantizing compressors
# ---------------------------------------------------------------------------


def _tied_leaf(n, dtype, seed, zero_from=None):
    """One-decimal values (many equal magnitudes), zero from ``zero_from``
    on, in ``dtype``, on the CPU."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal(n), 1).astype(np.float32)
    if zero_from is not None:
        x[zero_from:] = 0.0
    return torch.from_numpy(x).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", LEAF_DTYPES)
def test_cuda_exact_topk_ties_match_cpu(cuda_device, dtype):
    """The stable sort keeps the lower index among ties on the card as on
    the CPU (which the CPU tests hold to ``lax.top_k``): an exact mask on a
    leaf below the block size, and blocked masks on a leaf with a mostly
    zero, padded last block and on one of three full blocks."""
    x = _tied_leaf(20_001, dtype, 1)
    k = S.k_for(x.numel(), ALPHA)
    assert torch.equal(S.topk_mask_exact(x.to(cuda_device), k).cpu(),
                       S.topk_mask_exact(x, k))
    for n, zero_from in (((1 << 20) + 3000, (1 << 20) + 100),
                         (3 << 20, None)):
        x = _tied_leaf(n, dtype, 2, zero_from)
        assert torch.equal(S.blocked_topk_mask(x.to(cuda_device),
                                               ALPHA).cpu(),
                           S.blocked_topk_mask(x, ALPHA))


@pytest.mark.cuda
def test_cuda_sign_and_bbit_wrappers_match_plain(cuda_device):
    """Each scheme wrapper is one word-kernel launch, bitwise against its
    plain version on the card."""
    from repro_torch.kernels.wirepack import ops as WO
    g = torch.Generator(device=cuda_device).manual_seed(3)
    xp = torch.randn((256, 128), generator=g, device=cuda_device)
    xp[0, :9] = 0.0
    xp[1, :3] = -0.0
    reset_launches()
    words, scales = WO.pack_sign_scale(xp)
    back = WO.unpack_sign_scale(words, scales)
    assert LAUNCHES["pack_words"] == 1 and LAUNCHES["unpack_words"] == 1
    pw, ps = WO.pack_sign_scale_plain(xp)
    assert_bitwise(words, pw)
    assert_bitwise(scales, ps)
    assert_bitwise(back, WO.unpack_sign_scale_plain(pw, ps))
    for b in (2, 4, 8):
        qmax = 2 ** (b - 1) - 1
        codes = torch.randint(-qmax, qmax + 1, (256, 128), generator=g,
                              dtype=torch.int32, device=cuda_device)
        w = WO.pack_bbit(codes, b)
        assert_bitwise(w, WO.pack_bbit_plain(codes, b))
        assert_bitwise(WO.unpack_bbit(w, b), codes)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["efficient_adam", "onebit_adam"])
def test_cuda_quantized_compress_matches_cpu(cuda_device, algorithm):
    """Efficient-Adam's compress on the card equals the CPU's bitwise (max,
    a division by a device scalar, round: each correctly rounded); 1-bit
    Adam's signs and words equal the CPU's, its scales (a block's mean,
    summed in another order) within 8 float32 ulps."""
    from types import SimpleNamespace
    from repro_torch.core import compressors, wire
    from repro_torch.core.compressors import Deltas
    comp = compressors.make_compressor(SimpleNamespace(
        algorithm=algorithm, q_bits=32, quant_bits=8))
    shapes = [(9001,), (37,), (8, 1024)]
    tree = {f"l{i}": x * 1e-3 for i, x in
            enumerate(map(torch.from_numpy, rand_leaves(4, shapes)))}
    tree["l1"] = tree["l1"].to(torch.bfloat16)
    err = {k: (v * 1e-2).to(v.dtype) for k, v in tree.items()}
    z = {k: torch.zeros_like(v) for k, v in tree.items()}
    on = lambda t, dev: {k: v.to(dev) for k, v in t.items()}
    if algorithm == "efficient_adam":
        deltas = lambda dev: Deltas(on(tree, dev), on(z, dev), on(z, dev))
    else:
        deltas = lambda dev: Deltas(on(z, dev), on(tree, dev), on(z, dev))
    reset_launches()
    pc, sc, _ = comp.compress(deltas(cuda_device),
                              {"err": on(err, cuda_device)})
    back = comp.unpack_wire(pc.wire, on(tree, cuda_device))
    assert LAUNCHES["pack_words"] == 1 and LAUNCHES["unpack_words"] == 1
    pp, sp, _ = comp.compress(deltas("cpu"), {"err": err})
    assert wire.payload_nbytes(pc.wire) == wire.payload_nbytes(pp.wire)
    assert_bitwise(pc.wire.words[0], pp.wire.words[0], "words")
    carrier = "W" if algorithm == "efficient_adam" else "M"
    for k in tree:
        assert_bitwise(getattr(back, carrier)[k], getattr(pc, carrier)[k],
                       f"round trip [{k}]")
    if algorithm == "efficient_adam":
        for a, b in zip(pc.wire.scales, pp.wire.scales):
            assert_bitwise(a, b, "scales")
        for k in tree:
            assert_bitwise(pc.W[k], pp.W[k], f"carrier [{k}]")
            assert_bitwise(sc["err"][k], sp["err"][k], f"residual [{k}]")
        return
    a, b = pc.wire.scales[0].cpu().double(), pp.wire.scales[0].double()
    eps = torch.finfo(torch.float32).eps
    assert bool(((a - b).abs() <= 8 * eps * b.abs()).all())


def _cnn_round_setup(device, C=4, **fed_kw):
    """The width-0.25 CNN on ``device``, FedAdam-SSM with threshold masks
    and error feedback, ``C`` clients and one round of batches."""
    from repro_torch.core import FedConfig
    from repro_torch.data import (client_batches, dirichlet_partition,
                                  synthetic_image_dataset)
    from repro_torch.models import vision
    params, _, loss, _, ds = vision.build_vision("cnn", width=0.25, seed=3,
                                                 device=device)
    imgs, labels = synthetic_image_dataset(ds, 256, seed=1)
    parts = dirichlet_partition(labels, n_clients=C, theta=0.1, seed=1)
    (bx, by), w = client_batches([imgs, labels], parts, 8, seed=0)
    batch = (torch.from_numpy(bx).to(device), torch.from_numpy(by).to(device))
    kw = dict(algorithm="fedadam_ssm", alpha=0.05, n_clients=C,
              local_epochs=2, exact_topk=False, error_feedback=True)
    kw.update(fed_kw)
    return params, loss, batch, torch.from_numpy(w).to(device), \
        (lambda **over: FedConfig(**{**kw, **over}))


def _assert_states_bitwise(a, b):
    from repro_torch import tree as T
    for name in ("W", "M", "V", "client_state"):
        for x, y in zip(T.leaves(getattr(a, name)),
                        T.leaves(getattr(b, name))):
            assert_bitwise(x, y, name)
    assert a.round == b.round


@pytest.mark.cuda
def test_cuda_vmap_wire_round_equals_scan(cuda_device):
    """The vmap round with the wire transport is the scan round bit for
    bit on the card, with the same launches per client."""
    from repro_torch.core import fed_init, make_fl_round
    torch.backends.cudnn.deterministic = True
    params, loss, batch, w, fed = _cnn_round_setup(cuda_device)
    out = {}
    for mode in ("scan", "vmap"):
        f = fed(client_mode=mode, aggregate="sparse_gather")
        reset_launches()
        st, mets = make_fl_round(f, loss)(fed_init(f, params), batch, w)
        out[mode] = (st, float(mets["uplink_bits"]), dict(LAUNCHES))
    _assert_states_bitwise(out["scan"][0], out["vmap"][0])
    assert out["scan"][1:] == out["vmap"][1:]
    assert out["vmap"][2]["packed_hist"] == 2 * 4


@pytest.mark.cuda
def test_cuda_async_degenerate_equals_scan(cuda_device):
    """Zero churn, K = cohort: one server step is the scan round."""
    from repro_torch.core import (AsyncConfig, fed_init, make_async_round,
                                  make_fl_round)
    from repro_torch.data import ChurnConfig, ChurnModel
    torch.backends.cudnn.deterministic = True
    params, loss, batch, w, fed = _cnn_round_setup(cuda_device)
    f = fed()
    st, mets = make_fl_round(f, loss)(fed_init(f, params), batch, w)
    run = make_async_round(f, loss, AsyncConfig(buffer_size=4),
                           churn=ChurnModel(ChurnConfig(), 4))
    ast, amets = run(fed_init(f, params), batch, w.cpu(), rounds=1)
    assert amets["server_steps"] == 1 and amets["landed"] == 4
    assert float(amets["uplink_bits"]) == float(mets["uplink_bits"])
    _assert_states_bitwise(st, ast)


@pytest.mark.cuda
def test_cuda_client_draw_equals_cpu(cuda_device):
    """The participation draw masks the same clients' weights on a state
    built on the card as on the CPU, and the round bills them."""
    from repro_torch.core import fed_init, make_fl_round
    from repro_torch.core.fed import participation_weights
    params, loss, batch, w, fed = _cnn_round_setup(cuda_device, C=6)
    f = fed(participation=0.5)
    for r in range(5):
        got = participation_weights(f, w, r)
        assert got.is_cuda
        assert_bitwise(got, participation_weights(f, w.cpu(), r), f"round {r}")
    st, mets = make_fl_round(f, loss)(fed_init(f, params)._replace(round=3),
                                      batch, w)
    assert st.round == 4
    assert float(mets["uplink_bits"]) == 3 * float(
        make_fl_round(fed(), loss)(fed_init(fed(), params), batch,
                                   w)[1]["uplink_bits"]) / 6


# ---------------------------------------------------------------------------
# The MoE, MLA and Mamba-2 (SSD) layers on the card
# ---------------------------------------------------------------------------


def _zoo_block(name, device, seed=5):
    """One float32 block of a smoke config (deepseek: MLA + MoE at 64
    experts top-6, the full config's routing, so that tokens share slots
    and experts drop; mamba2: the SSD mixer over two chunks), its weights
    and input on the CPU, and a function of (params, x) on ``device``."""
    import dataclasses
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import model as TM
    from repro_torch.models.params import materialize
    cfg = dataclasses.replace(reduce_for_smoke(get_config(name)),
                              dtype="float32")
    spec = cfg.layer_pattern[0]
    if spec.moe is not None:
        full = get_config(name).layer_pattern[0].moe
        spec = dataclasses.replace(spec, moe=dataclasses.replace(
            spec.moe, num_experts=full.num_experts, top_k=full.top_k))
    params = materialize(TM._block_params(cfg, spec), seed, "float32", "cpu")
    s = 2 * (spec.ssm.chunk_size if spec.ssm else 32)
    x = torch.randn((2, s, cfg.d_model),
                    generator=torch.Generator().manual_seed(seed))
    pos = torch.arange(s)[None].expand(2, s)

    def fwd(p, xx):
        y, aux, _ = TM._block_fwd(cfg, spec, p, xx,
                                  positions=pos.to(xx.device))
        return y, (torch.zeros((), device=xx.device) if aux is None else aux)

    return spec, params, x, fwd


def _block_grads(fwd, params, x, device):
    from repro_torch import tree as T
    leaves, td = T.flatten(params)
    req = [t.to(device).requires_grad_(True) for t in leaves]
    xd = x.to(device).requires_grad_(True)
    y, aux = fwd(td.unflatten(req), xd)
    ((y * y.detach()).sum() + aux).backward()
    return y.detach().cpu(), [t.grad.cpu() for t in req] + [xd.grad.cpu()]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "mamba2-1-3b"])
def test_cuda_zoo_block_matches_cpu(cuda_device, name):
    """A smoke block in float32 (TF32 off) on the card against the CPU:
    the MoE's routing identical (experts, keep, dst, slot_tok), output and
    gradients within 1e-5 of their largest (summation orders differ), and
    the card's backward bitwise the same when run again (the MoE's
    dispatch sums a token's slot gradients in buffer order, not in atomic
    order)."""
    from repro_torch.device import exact_float32
    from repro_torch.models import layers as L
    exact_float32()
    spec, params, x, fwd = _zoo_block(name, cuda_device)
    if spec.moe is not None:
        h = torch.randn((2, 64, x.shape[-1]),
                        generator=torch.Generator().manual_seed(1))
        p = params["ffn"]
        on = lambda t, dev: {k: v.to(dev) for k, v in t.items()
                             if k != "shared"}
        a = L.moe_route(on(p, cuda_device), spec.moe, h.to(cuda_device))
        b = L.moe_route(on(p, "cpu"), spec.moe, h)
        for f in ("eidx", "keep", "dst", "slot_tok"):
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
        assert not bool(a.keep.all()), "no slot was dropped"
    y, g = _block_grads(fwd, params, x, cuda_device)
    y2, g2 = _block_grads(fwd, params, x, cuda_device)
    yc, gc = _block_grads(fwd, params, x, "cpu")
    assert_bitwise(y, y2, "output")
    for i, (a, b, c) in enumerate(zip(g, g2, gc)):
        assert_bitwise(a, b, f"gradient {i} run twice")
        tol = 1e-5 * float(c.abs().max())
        assert float((a - c).abs().max()) <= tol, f"gradient {i}"
    assert float((y - yc).abs().max()) <= 1e-5 * float(yc.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_moe_dispatch_backward_is_the_cpus(cuda_device, dtype):
    """The MoE dispatch's backward at the full config's routing (64
    experts, top-6, tokens dropped) on the card: bitwise the CPU's, in
    float32 and in bfloat16 (the same gathers, added in the same order and
    dtype)."""
    from repro_torch.models import layers as L
    spec, params, x, _ = _zoo_block("deepseek-v2-lite-16b", cuda_device)
    gen = torch.Generator().manual_seed(2)
    h = torch.randn((2, 64, x.shape[-1]), generator=gen)
    r = L.moe_route({"router": params["ffn"]["router"]}, spec.moe, h)
    assert not bool(r.keep.all())
    g = torch.randn((2, r.slot_tok.shape[1], x.shape[-1]), generator=gen)
    grads = []
    for dev in (cuda_device, "cpu"):
        hd = h.to(dev, dtype).requires_grad_(True)
        buf = L._Dispatch.apply(hd, r.slot_tok.to(dev), r.dst.to(dev),
                                spec.moe.top_k)
        (buf * g.to(dev, dtype)).sum().backward()
        grads.append(hd.grad.cpu())
    assert_bitwise(grads[0], grads[1], "dispatch backward")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "mamba2-1-3b"])
def test_cuda_zoo_round_repeats_bitwise(cuda_device, name):
    """A smoke FedAdam-SSM round (bfloat16, threshold masks, error
    feedback, the fused Adam) on the card twice from one state: bit for
    bit, with one pack/unpack a client and every per-leaf kernel
    launched."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import FedConfig, fed_init, make_fl_round
    from repro_torch.launch import train
    from repro_torch.optim import AdamHyper
    cfg = reduce_for_smoke(get_config(name))
    fed = FedConfig(algorithm="fedadam_ssm", alpha=0.05, n_clients=2,
                    local_epochs=2, exact_topk=False, error_feedback=True,
                    use_kernel_adam=True, adam=AdamHyper(lr=1e-3))
    run, state = train.make_trainer(cfg, fed, seed=1, device=cuda_device)
    batch = train.build_client_batches(cfg, 2, 2, 64, device=cuda_device)
    state = run(state, batch)[0]
    reset_launches()
    a, ma = run(state, batch)
    b, mb = run(state, batch)
    _assert_states_bitwise(a, b)
    assert float(ma["uplink_bits"]) == float(mb["uplink_bits"])
    n = len(T.leaves(state.W))
    assert LAUNCHES["pack_words"] == 2 * 2
    assert LAUNCHES["fused_adam"] == 2 * 2 * 2 * n
    assert LAUNCHES["absmax"] == LAUNCHES["ssm_apply_ef"] == 2 * 2 * n


# ---------------------------------------------------------------------------
# Serving: prefill and the decode step on the card
# ---------------------------------------------------------------------------

#: One smoke model of each served family: MLA + MoE, SSD, the hybrid,
#: GQA with cross-attention, GQA after a stub prefix.
SERVED = ["deepseek-v2-lite-16b", "mamba2-1-3b", "jamba-1-5-large-398b",
          "whisper-base", "llava-next-mistral-7b"]


SERVED_PROMPT = 8


def _served(name, device, gen=6, seed=3):
    """A float32 smoke model (MoE capacity factor 8: no drops), weights
    drawn on the CPU, and on ``device`` its prefill over SERVED_PROMPT
    tokens (after a VLM's prefix or with whisper's frames), the prefill's
    caches in decode caches of SERVED_PROMPT + gen slots (after the
    prefix), the tokens and the next position."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch import serve
    from repro_torch.models import model as TM
    cfg = dataclasses.replace(reduce_for_smoke(get_config(name)),
                              dtype="float32")
    cfg = dataclasses.replace(cfg, layer_pattern=tuple(
        dataclasses.replace(sp, moe=dataclasses.replace(
            sp.moe, capacity_factor=8.0)) if sp.moe else sp
        for sp in cfg.layer_pattern))
    gen_ = torch.Generator().manual_seed(seed)
    params = TM.init_params(cfg, seed=seed, device="cpu")
    prompt = SERVED_PROMPT
    toks = torch.randint(0, cfg.vocab_size, (2, prompt + gen),
                         generator=gen_)
    kw, n_front = {}, 0
    if cfg.stub_frontend:
        n = cfg.encoder.src_len if cfg.encoder is not None else \
            min(cfg.stub_frontend_tokens, 16)
        kw["frontend_embeds"] = (torch.randn((2, n, cfg.d_model),
                                             generator=gen_) * 0.02)
        n_front = 0 if cfg.encoder is not None else n
    seq = n_front + prompt + gen
    p = T.tree_map(lambda t: t.to(device), params)
    kw = {k: v.to(device) for k, v in kw.items()}
    logits, pre = TM.prefill(cfg, p, toks[:, :prompt].to(device), **kw)
    caches = serve.new_caches(cfg, 2, seq, device)
    for z, c in zip(T.leaves(caches), T.leaves(pre)):
        (z if z.shape == c.shape else z[:, :, :, :c.shape[3]]).copy_(c)
    return cfg, p, toks.to(device), caches, logits, n_front + prompt, seq


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERVED)
def test_cuda_decode_step_matches_cpu(cuda_device, name):
    """Prefill and six teacher-forced decode steps of a float32 smoke
    model (TF32 off) on the card against the CPU: every logit within 1e-5
    of the largest (summation orders differ)."""
    from repro_torch.device import exact_float32
    from repro_torch.models import model as TM
    exact_float32()
    runs = []
    for dev in (cuda_device, "cpu"):
        cfg, p, toks, caches, logits, pos, seq = _served(name, dev)
        out = [logits]
        for j, i in enumerate(range(SERVED_PROMPT, toks.shape[1])):
            lg, _ = TM.decode_step(cfg, p, caches, pos + j, toks[:, i],
                                   seq_len=seq)
            out.append(lg)
        runs.append(torch.stack(out, 1).cpu())
    a, b = runs
    assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERVED)
def test_cuda_decode_repeats_bitwise_without_syncs(cuda_device, name):
    """Greedy generation from one cache state twice on the card: the same
    tokens and logits bit for bit, with no stream synchronisation in the
    loop (PyTorch's sync debug mode raises on one)."""
    from repro_torch import tree as T
    from repro_torch.launch import serve
    cfg, p, _, caches, logits, pos, seq = _served(name, cuda_device)
    runs = []
    for _ in range(2):
        c = T.tree_map(torch.clone, caches)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            toks, last = serve.generate(cfg, p, c, logits, pos, seq - pos,
                                        seq_len=seq)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        runs.append((toks.cpu(), last.cpu()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert_bitwise(runs[0][1], runs[1][1], "logits")


# ---------------------------------------------------------------------------
# The multi-GPU spatial driver's pieces and remat
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 100_003])
def test_cuda_pack_bits_1d_matches_cpu(cuda_device, n):
    from repro_torch.core import wire
    bits = torch.from_numpy(np.random.default_rng(n).random(n) < 0.3)
    words = wire.pack_bits_1d(bits.to(cuda_device))
    assert_bitwise(words, wire.pack_bits_1d(bits), "words")
    assert_bitwise(wire.unpack_bits_1d(words, n),
                   wire.unpack_bits_1d(words.cpu(), n), "bits")


@pytest.mark.cuda
def test_cuda_world1_nccl_aggregate_overflow_matches_cpu(cuda_device,
                                                         tmp_path):
    """The transport on a world-1 NCCL group, past its capacity on one
    leaf, with error feedback: the sums and the residual bitwise those of
    a gloo group of the same process on the CPU (NCCL gathers the uint32
    bitmap as int32)."""
    import torch.distributed as dist
    from repro_torch.core import aggregate
    from repro_torch.launch import mesh as MM
    gpu = MM.init(1, 0, store=str(tmp_path / "store"), device=cuda_device)
    try:
        cpu = MM.ClientMesh(shape={"data": 1}, client_axes=("data",),
                            rank=0, device=torch.device("cpu"),
                            group=dist.new_group([0], backend="gloo"))
        rng = np.random.default_rng(3)
        x = np.zeros((1, 5000), np.float32)
        x[0, :2000] = rng.standard_normal(2000)         # past kb = 273
        y = (rng.standard_normal((1, 64, 33))
             * (rng.random((1, 64, 33)) < 0.05)).astype(np.float32)
        err = {"x": rng.standard_normal((1, 5000)).astype(np.float32),
               "y": rng.standard_normal((1, 64, 33)).astype(np.float32)}
        outs = {}
        for mesh in (gpu, cpu):
            on = lambda t: {k: torch.from_numpy(v).to(mesh.device)
                            for k, v in t.items()}
            car = on({"x": x, "y": y})
            agg = aggregate.make_shardmap_sparse_aggregate(
                mesh, None, ("data",), 0.05, value_dtype="bfloat16")
            outs[mesh.device.type] = agg(
                car, car, car, torch.full((1,), 0.5, device=mesh.device),
                on(err))
        (ga, gerr), (ca, cerr) = outs["cuda"], outs["cpu"]
        for a, b in zip(ga + (gerr,), ca + (cerr,)):
            for k in a:
                assert a[k].is_cuda
                assert_bitwise(a[k], b[k], k)
        assert not torch.equal(cerr["x"], torch.from_numpy(err["x"])), \
            "the overflow fed nothing back"
    finally:
        gpu.close()


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_cuda_remat_bitwise_none(cuda_device, remat):
    """The MLA + MoE smoke model's loss and gradients on the card are the
    same bits with and without recomputation."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import model as TM
    cfg = reduce_for_smoke(get_config("deepseek-v2-lite-16b"))
    params = TM.init_params(cfg, seed=0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(0)) \
        .to(torch.int32).to(cuda_device)
    res = []
    for r in ("none", remat):
        leaves, td = T.flatten(params)
        req = [x.detach().clone().requires_grad_(True) for x in leaves]
        loss = TM.loss_fn(cfg, td.unflatten(req), toks, remat=r)
        res.append((loss.detach(), torch.autograd.grad(loss, req)))
    assert_bitwise(res[1][0], res[0][0], "loss")
    for i, (a, b) in enumerate(zip(res[1][1], res[0][1])):
        assert_bitwise(a, b, f"gradient {i}")


class _Halves:
    """A model group of two "ranks" that are two threads of this process:
    each ``all_reduce`` posts its tensor, waits for the other's, and both
    get the reduction (sum or max; a sum of float64 counts stays float64),
    so a function written for one shard runs on both halves of a leaf
    here, with the reduction done on one process."""

    size = 2

    def __init__(self):
        import threading
        self.slots = [None, None]
        self.barrier = threading.Barrier(2)

    def rank(self, index):
        outer = self

        class _Rank:
            size = 2

            def __init__(self):
                self.index = index

            def chunk(self, n):
                return (index * n) // 2, ((index + 1) * n) // 2

            def all_reduce(self, x, op="sum"):
                outer.slots[index] = x
                outer.barrier.wait()
                a, b = outer.slots
                out = torch.maximum(a, b) if op == "max" else a + b
                outer.barrier.wait()
                return out.to(x.dtype)

        return _Rank()

    def run(self, fn):
        """``[fn(rank 0), fn(rank 1)]``, each in a thread of its own."""
        import concurrent.futures
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(fn, self.rank(i)) for i in range(2)]
            return [f.result(timeout=120) for f in futs]


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype", [(24578, torch.float32),
                                     (2 * 150_001, torch.bfloat16),
                                     (16384, torch.float32)])
def test_cuda_split_select_tau_bitwise_whole(cuda_device, n, dtype):
    """``select_tau`` of a leaf split in two on the model axis: the
    ``absmax`` and ``count_ge`` kernels on each half, the MAX and float64
    SUM reductions done on this process (two threads): tau and count
    bitwise the whole leaf's (the tile padding counted once); the last
    case an all-zero leaf."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32) if n != 16384 \
        else np.zeros(n, np.float32)
    x = torch.from_numpy(x).to(dtype).to(cuda_device)
    for alpha in (0.05, 0.01):
        k = S.k_for(n, alpha)
        tau0, cnt0 = TM.select_tau(x, k)

        def half(model):
            lo, hi = model.chunk(n)
            return TM.select_tau(x[lo:hi].contiguous(), k, model=model, n=n)

        reset_launches()
        for tau, cnt in _Halves().run(half):
            assert tau.is_cuda
            assert_bitwise(tau, tau0, f"tau at alpha {alpha}")
            assert_bitwise(cnt, cnt0, f"count at alpha {alpha}")
        assert LAUNCHES["absmax"] == 2 and LAUNCHES["count_ge"] == 4


@pytest.mark.cuda
def test_cuda_vocab_parallel_loss_matches_cpu(cuda_device):
    """The vocabulary-parallel cross-entropy on CUDA logits split in two
    (the reductions done on this process) against ``logsumexp - picked``
    of the whole logits on the CPU, float32: the per-position losses and
    the logits' gradient within 2e-6 of the largest."""
    from repro_torch.models import model as TM_
    rng = np.random.default_rng(5)
    lg = rng.standard_normal((3, 17, 512)).astype(np.float32) * 4
    tgt = torch.from_numpy(rng.integers(0, 512, (3, 17)))
    whole = torch.from_numpy(lg).requires_grad_(True)
    ref = torch.logsumexp(whole, -1) - whole.gather(-1, tgt[..., None])[
        ..., 0]
    (gref,) = torch.autograd.grad(ref.sum(), whole)

    def half(model):
        lo, hi = model.chunk(512)
        part = torch.from_numpy(lg[..., lo:hi]).to(cuda_device) \
            .requires_grad_(True)
        ce = TM_.vocab_parallel_ce(part, tgt.to(cuda_device), model)
        (g,) = torch.autograd.grad(ce.sum(), part)
        return ce.detach().cpu(), g.cpu()

    (ce0, g0), (ce1, g1) = _Halves().run(half)
    assert_bitwise(ce0, ce1, "the two halves' losses")
    np.testing.assert_allclose(ce0.numpy(), ref.detach().numpy(), rtol=0,
                               atol=2e-6 * float(ref.detach().abs().max()))
    g = torch.cat([g0, g1], dim=-1).numpy()
    np.testing.assert_allclose(g, gref.numpy(), rtol=0,
                               atol=2e-6 * float(gref.abs().max()))


#: the split-KV combine on the card against the whole softmax on the card,
#: float32, of its largest element
SPLIT_KV_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_cuda_split_kv_combine_matches_whole(cuda_device, n, ring):
    """``decode_attention`` split over ranks on the card: ``n`` ranks (threads of
    this process sharing the card) each attending over its slice of a
    65,536-slot cache (a ring wrapped past it), combined by the
    all-reduced max, sums and contexts, within ``SPLIT_KV_TOL`` of
    ``decode_attention`` over the whole cache on the card; a position in
    the first rank's slice leaves the others' slots all masked."""
    from repro_torch.models import layers as L
    S, hd = 65536, 128
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q = torch.randn((1, 8, 2, hd), generator=g, device=cuda_device)
    k = torch.randn((1, S, 8, hd), generator=g, device=cuda_device)
    v = torch.randn((1, S, 8, hd), generator=g, device=cuda_device)
    held = S // n
    for pos in ((S + 777, 3 * S - 5) if ring else (100, S - 1)):
        want = L.decode_attention(q, k, v, pos=pos, ring=ring)

        def rank(grp):
            lo = grp.index * held
            return L.decode_attention(
                q, k[:, lo:lo + held], v[:, lo:lo + held], pos=pos, S=S,
                lo=lo, group=grp, ring=ring)

        for got in ThreadGroup(n).run(rank):
            err = (got - want).abs().max() / want.abs().max()
            assert float(err) <= SPLIT_KV_TOL, (pos, float(err))
