"""The packed count by rank and the pick in its epilogue, against the
port's plain versions and the JAX package's oracles.

The card's count kernel (``csrc/packed_topk.cu``) does not compare each
element with its segment's 32 edges.  It sorts the edges largest first (a
NaN edge, which no element reaches, as +inf), takes each element's rank
among them (the first sorted edge with ``|x| >= e``, 32 for none or NaN),
counts the ranks, and turns them into counts by a prefix sum with rank 32
dropped, read back at each edge's sorted position (0 for a NaN edge).
Each CTA counts a contiguous chunk of blocks and adds each run of one
segment apart.  In ``packed_apply`` the count's
last CTA then picks each segment's tau from the finished counts.  The
kernel cannot run here, so these tests hold torch/numpy models of that
formulation, chunk by chunk and lane by lane, BITWISE against
``packed_hist_plain`` / ``pick_taus`` and against the JAX package's
oracles (``packed_hist_ref``, ``packed_apply_ef_ref``: the Pallas kernels
call ``pl.load``, which the installed jax lacks), on the count's edge cases
of ``tests/_torch_parity.py``.  ``tests/test_torch_cuda.py`` holds the
kernels against the plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_bitwise, packed_edge_cases, rand_leaves,
                           shuffle_blocks, taus_sorted)
from repro.kernels.packed_topk import ref as jpref
from repro_torch.core import sparsify as S
from repro_torch.kernels.packed_topk import ops as P
from repro_torch.kernels.packed_topk import ref as pref
from repro_torch.kernels.topk_mask.ref import linear_taus, log2_taus

ALPHA = 0.05
N_BINS = P.N_BINS


def rank_count(xp, seg_ids, edges, chunk):
    """The count kernel's formulation: the blocks in chunks of ``chunk``
    (one CTA each), each chunk's runs of one segment counted apart and
    added (the flush on a segment change).  Per run: the segment's edges
    sorted largest first (a NaN edge as +inf), each element's rank among
    them by ``searchsorted`` (32 for none or NaN), a ``bincount`` of the
    ranks and a prefix sum with rank 32 dropped, read back at each edge's
    sorted position, and 0 for a NaN edge.  (L, 32) float32."""
    a = xp.to(torch.float32).abs().reshape(-1, P.BLOCK_ELEMS)
    seg = seg_ids.to(torch.int64).tolist()
    out = torch.zeros((edges.shape[0], N_BINS), dtype=torch.int64)
    nb = a.shape[0]
    for c0 in range(0, nb, chunk):
        b, end = c0, min(c0 + chunk, nb)
        while b < end:
            s, e = seg[b], b
            while e < end and seg[e] == s:
                e += 1
            v, row = a[b:e].reshape(-1), edges[s]
            nan = torch.isnan(row)
            key = torch.where(nan, float("inf"), row)
            order = torch.argsort(key, descending=True, stable=True)
            pos = torch.empty_like(order)
            pos[order] = torch.arange(N_BINS)
            at_or_below = torch.searchsorted(key[order].flip(0).contiguous(),
                                             v, right=True)
            rank = torch.where(torch.isnan(v), N_BINS, N_BINS - at_or_below)
            prefix = torch.bincount(rank, minlength=N_BINS + 1)[
                :N_BINS].cumsum(0)
            out[s] += torch.where(nan, 0, prefix[pos])
            b = e
    return out.to(torch.float32)


def epilogue_pick(c2, taus2, ks, ns):
    """The pick of the count's last CTA, lane by lane: per segment a ballot
    of ``float(c_j) >= k``, idx = its first set lane (0 when none), tau and
    count read from lane idx, tau 0 and count n where k >= n.  Returns
    (taus, counts), each (L,) float32."""
    c2, t2 = c2.numpy(), taus2.numpy()
    ks, ns = ks.numpy(), ns.numpy()
    taus = np.zeros(c2.shape[0], np.float32)
    counts = np.zeros(c2.shape[0], np.float32)
    for s in range(c2.shape[0]):
        hit = [np.float32(c2[s, j]) >= ks[s] for j in range(N_BINS)]
        idx = hit.index(True) if any(hit) else 0
        taus[s], counts[s] = t2[s, idx], np.float32(c2[s, idx])
        if ks[s] >= ns[s]:
            taus[s], counts[s] = np.float32(0.0), ns[s]
    return torch.from_numpy(taus), torch.from_numpy(counts)


def _jax_hist(xp, seg_ids, edges):
    return jpref.packed_hist_ref(jnp.asarray(xp.numpy()),
                                 jnp.asarray(seg_ids.numpy()),
                                 jnp.asarray(edges.numpy()))


@pytest.mark.parametrize("order", ["packed", "interleaved"])
@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_rank_count_matches_plain_and_jax_on_edge_cases(chunk, order):
    xp, seg_ids, edges, exact = packed_edge_cases()
    assert not all(taus_sorted(r) for r in edges)  # NaN and unsorted rows
    if order == "interleaved":
        xp, seg_ids = shuffle_blocks(xp, seg_ids, chunk)
    got = rank_count(xp, seg_ids, edges, chunk)
    assert_bitwise(got, P.packed_hist_plain(xp, seg_ids, edges), "vs plain")
    ref = np.asarray(_jax_hist(xp, seg_ids, edges))
    assert_bitwise(got[torch.from_numpy(exact)], ref[exact],
                   "vs packed_hist_ref (segments XLA counts exactly)")


@pytest.mark.parametrize("scope", ["per_tensor", "global"])
def test_rank_count_on_log2_and_refine_rows(scope):
    """A model-like cohort (a multi-block leaf, a sub-block leaf, a tile
    and an all-zero leaf): the log2 rows of launch 1 and the refine rows
    of packed_apply's count, every row taking the rank path."""
    shapes = [(9001,), (37,), (8, 1024), (50,)]
    leaves = [torch.from_numpy(x) for x in rand_leaves(11, shapes)]
    leaves[3] = torch.zeros(50)
    groups = None if scope == "per_tensor" else [0] * len(shapes)
    layout = S.plan_packed_layout(leaves, groups)
    xp, seg_ids = layout.pack(leaves), layout.seg_ids
    ks, _ = layout.ks_ns(ALPHA)
    absmax = S._segment_absmax(layout, leaves)
    edges = log2_taus(absmax)
    c1 = rank_count(xp, seg_ids, edges, 2)
    assert_bitwise(c1, P.packed_hist_plain(xp, seg_ids, edges), "log2")
    assert_bitwise(c1, _jax_hist(xp, seg_ids, edges), "log2 vs JAX")
    taus2 = pref.refine_taus(c1, edges, absmax, ks)
    assert all(taus_sorted(r) for r in torch.cat([edges, taus2]))
    c2 = rank_count(xp, seg_ids, taus2, 2)
    assert_bitwise(c2, P.packed_hist_plain(xp, seg_ids, taus2), "refine")
    assert_bitwise(c2, _jax_hist(xp, seg_ids, taus2), "refine vs JAX")


@pytest.mark.parametrize("score", ["stream", "edge_cases"])
def test_epilogue_pick_matches_pick_taus_and_jax(score):
    """Counts that never reach k (idx 0), k >= n, and two segments with no
    blocks (one with k >= n, one whose zero counts never reach k)."""
    if score == "edge_cases":
        xp, seg_ids, taus2, exact = packed_edge_cases()
    else:
        leaves = [torch.from_numpy(x)
                  for x in rand_leaves(12, [(9001,), (37,), (8, 1024)])]
        layout = S.plan_packed_layout(leaves)
        xp, seg_ids = layout.pack(leaves), layout.seg_ids
        absmax = S._segment_absmax(layout, leaves)
        edges = log2_taus(absmax)
        ks, _ = layout.ks_ns(ALPHA)
        taus2 = pref.refine_taus(P.packed_hist_plain(xp, seg_ids, edges),
                                 edges, absmax, ks)
        exact = np.ones(taus2.shape[0], bool)
    L = taus2.shape[0]
    exact = torch.from_numpy(np.concatenate([exact, [True, True]]))
    taus2 = torch.cat([taus2, linear_taus(torch.tensor([0.1, 0.2]),
                                          torch.tensor([1.0, 2.0]))])
    ns = torch.bincount(seg_ids.long(), minlength=L + 2).to(
        torch.float32) * P.BLOCK_ELEMS
    c2 = P.packed_hist_plain(xp, seg_ids, taus2)
    ks = torch.tensor([float(S.k_for(int(n), ALPHA)) for n in ns])
    ks[0] = float(c2[0].max()) + 1.0       # never reached, below n
    assert ks[0] < ns[0]
    ks[1] = ns[1]                           # k >= n: keep everything
    ks[L], ns[L] = 0.0, 0.0                 # no blocks, k >= n
    ks[L + 1], ns[L + 1] = 1.0, 5.0         # no blocks, zero counts
    taus, counts = epilogue_pick(c2, taus2, ks, ns)
    want_t, want_c = P.pick_taus(taus2, c2, ks, ns)
    assert_bitwise(taus, want_t, "taus vs pick_taus")
    assert_bitwise(counts, want_c, "counts vs pick_taus")
    assert float(taus[0]) == float(taus2[0, 0]) and float(taus[1]) == 0.0
    assert float(counts[L + 1]) == 0.0
    ref = jpref.packed_apply_ef_ref(*(jnp.asarray(a.numpy()) for a in
                                      (taus2, seg_ids, ks, ns)),
                                    (jnp.asarray(xp.numpy()),))
    # segments whose count XLA takes exactly (it flushes subnormal edges)
    assert_bitwise(taus[exact], np.asarray(ref[-2])[:, 0][exact.numpy()],
                   "taus vs JAX")
    assert_bitwise(counts[exact], np.asarray(ref[-1])[:, 0][exact.numpy()],
                   "counts vs JAX")
    out = P.packed_apply_plain(taus2, seg_ids, ks, ns, (xp,))
    assert_bitwise(taus, out[-2][:, 0], "taus vs packed_apply_plain")
    assert_bitwise(counts, out[-1][:, 0], "counts vs packed_apply_plain")
