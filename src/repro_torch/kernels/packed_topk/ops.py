"""Packed cohort compress: segmented histogram and fused pick/apply.

    c1    = packed_hist(score_p, seg_ids, edges)            # launch 1
    taus2 = ref.refine_taus(c1, edges, absmax, ks)          # host torch
    *streams, [err], taus, counts = packed_apply(
        taus2, seg_ids, ks, ns, (dW_p, dM_p, dV_p))         # launches 2-3

Counterpart of ``repro/kernels/packed_topk/{packed_topk,ops}.py``.  The
buffers are (R, 128) packed cohorts built by
``repro_torch.core.sparsify.PackedLayout``; ``seg_ids`` maps each (8, 128)
block to its tau segment.  On a CUDA tensor the wrappers launch the
kernels of ``csrc/packed_topk.cu``: ``packed_hist`` is one device
operation, the count kernel, whose last CTA writes the float32 counts;
``packed_apply`` is two, the same count over the refine candidates (the
TPU's count sweep), whose last CTA picks each segment's tau, then the
apply.  Both counts add into a workspace kept per device and stream
(zeroed once, left zero by every launch).  On a CPU tensor the wrappers
run the plain versions below, which compute the same function and are
what the CPU tests hold against the JAX package.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import LAUNCHES, _lib, predict
from repro_torch.kernels._check import cuda_arg, is_fake, on_cpu, ptr, stream
from repro_torch.kernels.topk_mask.ref import N_BINS

LANES = 128
SUBLANES = 8
BLOCK_ELEMS = SUBLANES * LANES

#: value_dtype names the apply understands -> the kernel's cast code.
VALUE_DTYPES = {None: 0, "bfloat16": 1, "float16": 2}
_TORCH_VALUE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}

#: Packed blocks per chunk of the plain count: bounds the (blocks, 1024,
#: 32) compare tensor at 2M elements.
_PLAIN_CHUNK_BLOCKS = 64


def _value_code(value_dtype) -> int:
    if value_dtype not in VALUE_DTYPES:
        raise ValueError(f"value_dtype {value_dtype!r} not in "
                         f"{tuple(VALUE_DTYPES)}")
    return VALUE_DTYPES[value_dtype]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def packed_hist_plain(xp: torch.Tensor, seg_ids: torch.Tensor,
                      edges: torch.Tensor) -> torch.Tensor:
    """(L, 32) float32 counts of ``|x| >= edges[seg, j]`` per segment."""
    L = edges.shape[0]
    a = xp.to(torch.float32).abs().reshape(-1, BLOCK_ELEMS)
    seg = seg_ids.to(torch.int64)
    out = torch.zeros((L, N_BINS), dtype=torch.int64, device=xp.device)
    for b0 in range(0, a.shape[0], _PLAIN_CHUNK_BLOCKS):
        blk = a[b0:b0 + _PLAIN_CHUNK_BLOCKS]
        s = seg[b0:b0 + _PLAIN_CHUNK_BLOCKS]
        ge = blk[:, :, None] >= edges[s][:, None, :]
        out.index_add_(0, s, ge.sum(dim=1))
    return out.to(torch.float32)


def pick_taus(taus2, c2, ks, ns):
    """First candidate whose count reaches k, per segment (index 0 when
    none does, as ``jnp.argmax``); k >= n keeps everything: tau = 0,
    count = n.  Returns (tau, count), each (L,) float32."""
    idx = torch.argmax((c2 >= ks[:, None]).to(torch.uint8), dim=1)
    tau = torch.gather(taus2, 1, idx[:, None])[:, 0]
    cnt = torch.gather(c2, 1, idx[:, None])[:, 0]
    full = ks >= ns
    tau = torch.where(full, torch.zeros_like(tau), tau)
    cnt = torch.where(full, ns, cnt)
    return tau, cnt


def _cast(value_dtype, x):
    _value_code(value_dtype)
    if value_dtype is None:
        return x
    return x.to(_TORCH_VALUE_DTYPES[value_dtype]).to(x.dtype)


def packed_apply_plain(taus2, seg_ids, ks, ns, streams: Sequence,
                       score: Optional[torch.Tensor] = None, *,
                       with_residual: bool = True, value_dtype=None):
    """Refine counts, tau pick, then ``where(|score| >= tau, cast(x), 0)``
    for every stream and the residual ``x0 - s0`` of stream 0.  Returns
    ``(*sparse_streams, [err], taus (L, 1), counts (L, 1))``."""
    streams = tuple(streams)
    sc = streams[0] if score is None else score
    c2 = packed_hist_plain(sc, seg_ids, taus2)
    tau, cnt = pick_taus(taus2, c2, ks, ns)
    tau_e = tau[seg_ids.to(torch.int64)].repeat_interleave(BLOCK_ELEMS) \
        .reshape(sc.shape[0], LANES)
    keep = sc.to(torch.float32).abs() >= tau_e
    outs = [torch.where(keep, _cast(value_dtype, x), torch.zeros_like(x))
            for x in streams]
    if with_residual:
        x0, s0 = streams[0], outs[0]
        outs.append((x0.to(torch.float32) - s0.to(torch.float32))
                    .to(x0.dtype))
    return tuple(outs) + (tau.reshape(-1, 1), cnt.reshape(-1, 1))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


#: One int32 workspace per (device, stream) for the counts: a ticket and
#: L * 32 partial counts.  Zeroed when it is made and made anew (zeroed)
#: only when a call has more segments than it holds: every launch leaves
#: it zero, and two streams never share one.
_workspaces: dict = {}


def _workspace(device: torch.device, st: int, n_seg: int) -> int:
    """The address of the workspace of ``device`` and stream ``st``, with
    room for ``n_seg`` segments."""
    words = n_seg * N_BINS + 1
    ws = _workspaces.get((device, st))
    if ws is None or ws.numel() < words:
        ws = _workspaces[(device, st)] = torch.zeros(
            (words,), dtype=torch.int32, device=device)
    return ws.data_ptr()


def _count(xp, seg_ids, edges, out=None, pick=None) -> None:
    """Launch the count kernel over xp: the (L, 32) float32 counts into
    ``out``, or with ``pick = (ks, ns, taus, counts)`` each segment's
    picked tau and count."""
    dev = xp.device
    R = xp.shape[0]
    if xp.dim() != 2 or xp.shape[1] != LANES or R % SUBLANES or R == 0:
        raise ValueError(f"xp: expected (R, {LANES}) with R % {SUBLANES} "
                         f"== 0 and R > 0, got {tuple(xp.shape)}")
    nb = R // SUBLANES
    L = edges.shape[0]
    cuda_arg("xp", xp, torch.float32)
    cuda_arg("seg_ids", seg_ids, torch.int32, (nb,), dev)
    cuda_arg("edges", edges, torch.float32, (L, N_BINS), dev)
    ks, ns, taus, counts = pick or (None,) * 4
    if is_fake(xp):
        predict("packed_hist", (xp, seg_ids, edges, ks, ns),
                (out, taus, counts))
        return
    st = stream(dev)
    _lib.launch("repro_packed_hist", ptr(xp), ptr(seg_ids), ptr(edges),
                _workspace(dev, st, L), ptr(out), ptr(ks), ptr(ns),
                ptr(taus), ptr(counts), nb, L, st)
    LAUNCHES["packed_hist"] += 1


def packed_hist(xp: torch.Tensor, seg_ids: torch.Tensor,
                edges: torch.Tensor) -> torch.Tensor:
    """Segmented 32-bin histogram over a packed (R, 128) buffer: (L, 32)
    float32 counts of ``|x| >= edges[seg, j]``.  ONE device operation on
    the card."""
    if on_cpu(xp):
        return packed_hist_plain(xp, seg_ids, edges)
    out = torch.empty((edges.shape[0], N_BINS), dtype=torch.float32,
                      device=xp.device)
    _count(xp, seg_ids, edges, out=out)
    return out


def packed_apply(taus2, seg_ids, ks, ns, streams: Sequence,
                 score: Optional[torch.Tensor] = None, *,
                 with_residual: bool = True, value_dtype=None):
    """Refine count + tau pick + shared-mask apply over 1 or 3 packed
    streams (``score=None``: the score is stream 0, the ssm_w rule).
    Returns ``(*sparse_streams, [err], taus (L, 1), counts (L, 1))``.
    TWO device operations on the card: the count with the pick, then the
    apply."""
    streams = tuple(streams)
    if len(streams) not in (1, 3):
        raise ValueError(f"expected 1 or 3 streams, got {len(streams)}")
    if on_cpu(streams[0]):
        return packed_apply_plain(taus2, seg_ids, ks, ns, streams, score,
                                  with_residual=with_residual,
                                  value_dtype=value_dtype)
    vdt = _value_code(value_dtype)
    dev = streams[0].device
    shape = tuple(streams[0].shape)
    for i, x in enumerate(streams):
        cuda_arg(f"streams[{i}]", x, torch.float32, shape, dev)
    if score is not None:
        cuda_arg("score", score, torch.float32, shape, dev)
    L = taus2.shape[0]
    cuda_arg("ks", ks, torch.float32, (L,), dev)
    cuda_arg("ns", ns, torch.float32, (L,), dev)
    taus = torch.empty((L, 1), dtype=torch.float32, device=dev)
    counts = torch.empty((L, 1), dtype=torch.float32, device=dev)
    _count(streams[0] if score is None else score, seg_ids, taus2,
           pick=(ks, ns, taus, counts))
    outs = [torch.empty_like(x) for x in streams]
    err = torch.empty_like(streams[0]) if with_residual else None
    if is_fake(streams[0]):
        predict("packed_apply", (taus, seg_ids, score, *streams),
                (*outs, err))
        return tuple(outs) + ((err,) if with_residual else ()) + \
            (taus, counts)
    x1, x2 = (streams[1], streams[2]) if len(streams) == 3 else (None, None)
    s1, s2 = (outs[1], outs[2]) if len(streams) == 3 else (None, None)
    _lib.launch("repro_packed_apply", ptr(taus), ptr(seg_ids), ptr(score),
                ptr(streams[0]), ptr(x1), ptr(x2), ptr(outs[0]), ptr(s1),
                ptr(s2), ptr(err), shape[0] // SUBLANES, len(streams), vdt,
                stream(dev))
    LAUNCHES["packed_apply"] += 1
    return tuple(outs) + ((err,) if with_residual else ()) + (taus, counts)


def launch_shape(nb: int) -> dict:
    """(grid, blocks per CTA) of the card's launches over ``nb`` packed
    blocks: ``count`` (packed_hist), ``pick`` (packed_apply's count) and
    ``apply`` (its most blocks per CTA).  Needs the card."""
    shape = torch.zeros(2, dtype=torch.int32)
    out = {}
    for kind, name in enumerate(("count", "pick", "apply")):
        _lib.launch("repro_packed_launch_shape", nb, kind, shape.data_ptr())
        out[name] = tuple(shape.tolist())
    return out
