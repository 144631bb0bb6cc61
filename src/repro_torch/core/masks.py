"""Shared-sparse-mask (SSM) rules, Section V of the paper.

Counterpart of ``repro/core/masks.py``.  One boolean mask for all three
local updates (dW, dM, dV):

* ``ssm_w``: Top_k(|dW|), the paper's optimal rule (Eq. 28);
* ``ssm_m`` / ``ssm_v``: from |dM| / |dV| (baselines);
* ``fairness_top``: from the elementwise max of the three
  magnitude-normalized tensors;

and FedAdam-Top's three independent masks (:func:`independent_masks`).
"""
from __future__ import annotations

import torch

from repro_torch.core import sparsify as S
from repro_torch import tree as T

_F32 = torch.float32

SHARED_RULES = ("ssm_w", "ssm_m", "ssm_v", "fairness_top")


def shared_score_tree(rule: str, dW, dM, dV, split=None):
    """Score tensors whose |.| the shared mask thresholds; ``None`` for
    ``ssm_w``, whose score is dW itself (the packed apply then reads the
    dW stream it already streams instead of a separate score).

    ``fairness_top`` divides each tensor by its leaf's L2 norm (plus
    1e-30): the squares are summed in float64, so that the sum, rounded
    once to float32, does not depend on the order of the additions, and a
    leaf split over a model axis or the FSDP axes (``split``, a
    ``sparsify.LeafSplit``) takes its shards' sums reduced over its group
    (one all-reduce per group): its norm, and so its scores, are the
    whole leaf's bit for bit."""
    if rule == "ssm_w":
        return None
    if rule == "ssm_m":
        return dM
    if rule == "ssm_v":
        return dV
    if rule == "fairness_top":
        trees = (T.leaves(dW), T.leaves(dM), T.leaves(dV))
        sq = [torch.stack([(x.to(_F32) ** 2).sum(dtype=torch.float64)
                           for x in xs]) for xs in zip(*trees)]
        if split is not None:
            sq = S.reduce_leaves(sq, split.groups)
        out = []
        for xs, s in zip(zip(*trees), sq):
            n = torch.sqrt(s.to(_F32)) + 1e-30
            a = [x.to(_F32).abs() / n[j] for j, x in enumerate(xs)]
            out.append(torch.maximum(a[0], torch.maximum(a[1], a[2])))
        return T.flatten(dW)[1].unflatten(out)
    raise ValueError(f"unknown shared mask rule {rule!r}")


def shared_mask(rule: str, dW, dM, dV, alpha: float,
                scope: str = "per_tensor", exact: bool = True,
                backend=None, split=None):
    """``split``: leaves split over a model axis or the FSDP axes
    (``sparsify.LeafSplit``), masked as the whole leaves."""
    score = shared_score_tree(rule, dW, dM, dV, split)
    score = T.tree_map(torch.abs, dW if score is None else score)
    return S.tree_topk_masks(score, alpha, scope=scope, exact=exact,
                             backend=backend, split=split)


def independent_masks(dW, dM, dV, alpha: float, scope: str = "per_tensor",
                      exact: bool = True, backend=None, split=None):
    """FedAdam-Top: three separate Top_k masks, one per tensor."""
    def mk(t):
        return S.tree_topk_masks(T.tree_map(torch.abs, t), alpha,
                                 scope=scope, exact=exact, backend=backend,
                                 split=split)

    return mk(dW), mk(dM), mk(dV)
