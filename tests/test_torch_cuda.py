"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips (from inside the test) where
no card is present.  The file imports neither ``jax`` nor the JAX
package, so it also runs on a machine that has only PyTorch; there the
repository's ``tests/conftest.py`` (which imports jax) is skipped:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Counts are integers and the apply is a select plus elementwise casts, so
every comparison is bitwise.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise, cuda_device  # noqa: F401
from _torch_parity import rand_leaves
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
