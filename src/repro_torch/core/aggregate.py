"""Server-side aggregation of client-stacked deltas on one card.

Counterpart of the single-device half of ``repro/core/aggregate.py``:

``dense``          a weighted sum over the client axis of the dense
                   (masked) carriers;
``sparse_gather``  each client's packed representation, folded by the
                   server: the clients' wire payloads
                   (:func:`wire_gather_sum`, the bit-packed bytes the
                   round bills), or, for a configuration with no wire
                   realization, a fixed-capacity COO pack per block of
                   ``BLOCK`` elements (values and block-local indices)
                   that the server scatter-adds.

The scan round's FedAvg fold (:func:`weighted_fold`, client 0 first)
is the one every order-exact sum here shares: :func:`ordered_weighted_sum`
is its stacked form and :func:`wire_gather_sum` folds each decoded
payload with it.

The multi-GPU transport, :func:`make_shardmap_sparse_aggregate` (the JAX
package's shard_map realization, on ``torch.distributed``): each rank
packs its own client's carriers (its shard of each leaf, on a model
axis) into a uint32 support bitmap
(:func:`repro_torch.core.wire.pack_bits_1d`) and the first ``kb`` values
of the compacted stream per leaf shard, all-gathers those over its
client group, and replays the server fold into its shard locally with
:func:`weighted_fold`; no index tensor crosses the group, and nothing
crosses the model axis.  Values the fixed capacity drops feed back into the
error-feedback residual.  The JAX package's ``_maybe_replicate`` (an
all-gather constraint in the global view) has no counterpart: it acts
only in ``round_vmap`` under a mesh, which the round never reaches once
``client_axes`` is set, and the explicit gathers here are the
replication.

:func:`packed_gather_sum` dispatches on the compressor's ``transport``
tag, as in the JAX package.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tree as T
from repro_torch.core import sparsify as S
from repro_torch.core import wire
from repro_torch.kernels.topk_mask.ref import overselect_bound

_F32 = torch.float32
_VALUE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float32": torch.float32}


def dense_weighted_sum(tree_c, weights):
    """``tree_c``: leaves ``(C, ...)``; the weighted sum over C, in float32
    (one ``tensordot``, whose summation order is the library's)."""
    w = weights.to(_F32)
    return T.tree_map(lambda x: torch.tensordot(w, x.to(_F32),
                                                dims=([0], [0])), tree_c)


def weighted_fold(acc, w, tree):
    """One client's step of the scan round's FedAvg fold: ``acc + w *
    x.to(float32)`` leaf by leaf; ``acc=None`` starts from float32 zeros
    (the first client).  Folding clients 0, 1, ... in turn is the order
    and arithmetic every bitwise claim against the scan round rests on."""
    if acc is None:
        acc = T.tree_map(lambda x: torch.zeros(x.shape, dtype=_F32,
                                               device=x.device), tree)
    return T.tree_map(lambda a, x: a + w * x.to(_F32), acc, tree)


def ordered_weighted_sum(tree_c, weights):
    """The stacked form of :func:`weighted_fold`: the weighted sum over
    the leading client axis, client 0 first, bitwise the scan round's
    FedAvg sums."""
    w = weights.to(_F32)
    acc = None
    for c in range(w.shape[0]):
        acc = weighted_fold(acc, w[c], T.tree_map(lambda x: x[c], tree_c))
    return acc


def weight_total(weights):
    """The FedAvg weight total as the scan round folds it, client 0
    first."""
    return ordered_weighted_sum(torch.ones_like(weights, dtype=_F32),
                                weights)


def _to_blocks(x_c, n):
    """(C, n) -> ((C, nb, B) zero-padded, nb, B); B is ``sparsify.BLOCK``."""
    B = S.BLOCK
    C = x_c.shape[0]
    nb = -(-n // B)
    pad = nb * B - n
    xb = torch.nn.functional.pad(x_c, (0, pad)) if pad else x_c
    return xb.reshape(C, nb, B), nb, B


def _capacity(n, B, alpha):
    """Per-block packed capacity: threshold masks over-select by ties and
    bin width, so the pack is sized for the selection's contracted worst
    case, ``k + overselect_bound(k)``."""
    size = B if n > B else n
    base = S.k_for(size, alpha)
    return min(size, base + overselect_bound(base))


def _pack(x_c, n, alpha, *, sort_free: bool = True):
    """The nonzeros of masked dense deltas in a fixed-capacity COO.

    ``x_c``: (C, n) -> (vals (C, nb, kb), idx (C, nb, kb) int32 block-local,
    valid (C, nb, kb) bool).  ``sort_free=True``: each nonzero goes to its
    prefix-sum position, and those past the capacity ``kb`` to a drop slot
    that is cut off.  ``sort_free=False``: the exact top ``kb`` of |x| per
    block, largest first and ties to the lower index (``lax.top_k``'s
    slots; a stable sort)."""
    xb, nb, B = _to_blocks(x_c, n)
    C = xb.shape[0]
    if not sort_free:
        kb = S.k_for(B, alpha) if n > B else S.k_for(n, alpha)
        idx = torch.sort(xb.to(_F32).abs(), dim=-1, descending=True,
                         stable=True).indices[..., :kb]
        vals = torch.gather(xb, 2, idx)
        return vals, idx.to(torch.int32), torch.ones(vals.shape,
                                                     dtype=torch.bool,
                                                     device=vals.device)
    kb = _capacity(n, B, alpha)
    m = xb != 0
    pos = torch.cumsum(m.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    keep = m & (pos < kb)
    dst = torch.where(keep, pos, kb).to(torch.int64)          # kb: drop slot
    src_idx = torch.arange(1, B + 1, dtype=torch.int32,
                           device=xb.device).expand(xb.shape)
    vals = torch.zeros((C, nb, kb + 1), dtype=xb.dtype, device=xb.device) \
        .scatter_(2, dst, xb)[..., :kb]
    # index + 1, so that an empty slot reads 0
    idx_plus = torch.zeros((C, nb, kb + 1), dtype=torch.int32,
                           device=xb.device) \
        .scatter_(2, dst, src_idx)[..., :kb]
    valid = idx_plus > 0
    idx = (idx_plus - 1).clamp_min(0)
    return vals, idx, valid


def _scatter_weighted(vals, idx, valid, weights, n):
    """``vals``/``idx``/``valid``: (C, nb, kb); the dense (n,) weighted sum,
    scatter-added client after client (client 0 first, as the scan round
    folds)."""
    C, nb, kb = vals.shape
    B = S.BLOCK if n > S.BLOCK else -(-n // nb)
    wv = vals.to(_F32) * weights.to(_F32)[:, None, None]
    wv = torch.where(valid, wv, torch.zeros((), dtype=_F32,
                                            device=wv.device))
    rows = torch.arange(nb, device=idx.device)[:, None] * B
    out = torch.zeros(nb * B, dtype=_F32, device=vals.device)
    for c in range(C):
        flat = (rows + idx[c].to(torch.int64)).reshape(-1)
        out.index_put_((flat,), wv[c].reshape(-1), accumulate=True)
    return out[:n]


def _value_cast(t, value_dtype):
    return t if value_dtype is None else t.to(_VALUE_DTYPES[value_dtype])


def sparse_shared_gather_sum(sW_c, sM_c, sV_c, alpha, weights,
                             value_dtype=None, sort_free=True):
    """FedAdam-SSM's COO transport: ONE index set per client and leaf
    (from the shared mask, read off dW), three value sets."""

    def leaf(w_c, m_c, v_c):
        C = w_c.shape[0]
        n = int(math.prod(w_c.shape[1:])) if w_c.dim() > 1 else 1
        vw, idx, valid = _pack(w_c.reshape(C, n), n, alpha,
                               sort_free=sort_free)
        take = lambda t: torch.gather(_to_blocks(t.reshape(C, n), n)[0], 2,
                                      idx.to(torch.int64))
        vm, vv = take(m_c), take(v_c)
        vw, vm, vv = (_value_cast(t, value_dtype) for t in (vw, vm, vv))
        shape = w_c.shape[1:]
        return tuple(_scatter_weighted(t, idx, valid, weights, n)
                     .reshape(shape) for t in (vw, vm, vv))

    lw, td = T.flatten(sW_c)
    outs = [leaf(w, m, v) for w, m, v in zip(lw, T.leaves(sM_c),
                                             T.leaves(sV_c))]
    return tuple(td.unflatten([o[i] for o in outs]) for i in range(3))


def sparse_independent_gather_sum(tree_c, alpha, weights, value_dtype=None,
                                  sort_free=True):
    """FedAdam-Top's COO transport: each tensor its own (values, indices)."""

    def leaf(x_c):
        C = x_c.shape[0]
        n = int(math.prod(x_c.shape[1:])) if x_c.dim() > 1 else 1
        vals, idx, valid = _pack(x_c.reshape(C, n), n, alpha,
                                 sort_free=sort_free)
        return _scatter_weighted(_value_cast(vals, value_dtype), idx, valid,
                                 weights, n).reshape(x_c.shape[1:])

    return T.tree_map(leaf, tree_c)


def _client_payload(payload_c: wire.WirePayload, c: int) -> wire.WirePayload:
    """Client ``c``'s payload out of a client-stacked one."""
    return wire.WirePayload(*(tuple(a[c] for a in part)
                              for part in payload_c))


def wire_gather_sum(compressor, payload_c, like, weights):
    """Aggregate client-stacked :class:`~repro_torch.core.wire.WirePayload`
    s: decode each client's bytes against the params template ``like`` and
    fold them in client order (:func:`weighted_fold`), so the wire
    transport is bitwise the scan round."""
    w = weights.to(_F32)
    acc = None
    for c in range(w.shape[0]):
        acc = weighted_fold(acc, w[c], tuple(compressor.unpack_wire(
            _client_payload(payload_c, c), like)))
    return acc


def packed_gather_sum(compressor, sW_c, sM_c, sV_c, weights, *, alpha,
                      value_dtype=None, sort_free=True,
                      payload_c=None, like=None):
    """Aggregate any compressor's packed representation.

    With ``payload_c`` (client-stacked payloads of ``make_client_step(...,
    emit="wire")``) the transport is the wire format itself
    (:func:`wire_gather_sum`).  Otherwise the COO paths, keyed on the
    ``transport`` tag: ``shared_sparse`` (one index set, three value
    sets), ``independent_sparse`` (three packs), and anything else the
    dense weighted sum."""
    if payload_c is not None:
        return wire_gather_sum(compressor, payload_c, like, weights)
    t = getattr(compressor, "transport", "dense")
    if t == "shared_sparse":
        return sparse_shared_gather_sum(sW_c, sM_c, sV_c, alpha, weights,
                                        value_dtype, sort_free)
    if t == "independent_sparse":
        agg = lambda tr: sparse_independent_gather_sum(
            tr, alpha, weights, value_dtype, sort_free)
        return agg(sW_c), agg(sM_c), agg(sV_c)
    return (dense_weighted_sum(sW_c, weights),
            dense_weighted_sum(sM_c, weights),
            dense_weighted_sum(sV_c, weights))


# ---------------------------------------------------------------------------
# The multi-GPU transport: per-shard bitmaps over torch.distributed
# ---------------------------------------------------------------------------


def _local_pack(wf, alpha):
    """``wf``: (n_loc,) masked dense, this rank's.  -> ``(words, pos, keep,
    kb)``: the support bitmap packed to uint32 words and the compaction
    plan (prefix-sum positions, ``keep`` = supported and under the
    capacity ``kb = k + overselect_bound(k)``)."""
    n = wf.shape[0]
    k = S.k_for(n, alpha)
    kb = min(n, k + overselect_bound(k))
    m = wf != 0
    pos = wire._support_positions(m)
    return wire.pack_bits_1d(m), pos, m & (pos < kb), kb


def _compact_vals(xf, pos, keep, kb):
    """The first ``kb`` values of ``xf`` on the support plan, float32."""
    return wire._compact(keep, pos, xf, kb)


def _expand_vals(words, vals, n_loc):
    """Inverse of the (bitmap, stream) pack: (nw,) uint32 words + (kb,)
    values -> (n_loc,) float32 (capacity-overflow slots decode to 0)."""
    sup = wire.unpack_bits_1d(words, n_loc) == 1
    return wire._expand(sup, wire._support_positions(sup),
                        vals.to(_F32), (n_loc,))


def _gathered_decode_sum(words_g, vals_g, weights, n_loc):
    """``words_g`` (C, nw) + ``vals_g`` (C, kb), gathered -> the (n_loc,)
    float32 weighted sum, folded client 0 first with the scan round's
    arithmetic (:func:`weighted_fold`), so the transport is bitwise the
    scan round when nothing overflows."""
    w = weights.to(_F32)
    acc = None
    for c in range(w.shape[0]):
        acc = weighted_fold(acc, w[c], _expand_vals(words_g[c], vals_g[c],
                                                    n_loc))
    return acc


def _gather_clients(x, mesh):
    """All-gather over the client group -> (C, *x.shape), in rank order:
    the row-major client linearization of JAX's gather over the client
    axes."""
    return mesh.all_gather(x)


def make_shardmap_sparse_aggregate(mesh, param_pspecs, client_axes, alpha,
                                   *, shared: bool = True,
                                   value_dtype=None):
    """The multi-GPU sparse transport::

        agg(sW_c, sM_c, sV_c, weights)           -> (aW, aM, aV)
        agg(sW_c, sM_c, sV_c, weights, comp_err) -> (aW, aM, aV), new_err

    (weighted SUMS, float32, the same on every rank of a model index).
    ``mesh``: the rank's :class:`~repro_torch.launch.mesh.ClientMesh`,
    whose client axes must be ``client_axes``.  ``param_pspecs``: the
    params' :class:`~repro_torch.models.params.Spec` tree (JAX's
    signature; ``None`` on a model axis of 1): each rank packs the shards
    it holds, each with its own capacity ``k_for(n_loc) +
    overselect_bound``, as JAX's shard_map body sees a device's shard.
    The carriers ``s*_c`` and ``comp_err`` are this rank's client's,
    stacked ``(1, ...)`` (one spatial client per rank of a model index);
    ``weights`` the (C,) FedAvg weights of every client.

    ``comp_err``: the rank's error-feedback residual tree on dW (the
    round's ``client_state["comp"]["err"]``).  Values the pack's capacity
    drops (``k + overselect_bound(k)`` per leaf) are added back into it
    (drop first, then add: when nothing overflows the drop is 0.0 and the
    residual passes through bitwise).  ``shared=False``: the independent
    masks of FedAdam-Top, three bitmaps per leaf.  ``value_dtype``: the
    value streams' wire cast."""
    if tuple(client_axes) != tuple(mesh.client_axes):
        raise ValueError(f"client axes {tuple(client_axes)} are not the "
                         f"mesh's {mesh.client_axes}")
    mesh.check()
    if mesh.model is not None and param_pspecs is None:
        raise ValueError("a model axis above 1 needs the param specs")
    vdt = None if value_dtype is None else _VALUE_DTYPES[value_dtype]
    gather = lambda t: _gather_clients(t, mesh)

    def stream(xf, pos, keep, kb):
        vals = _compact_vals(xf, pos, keep, kb)
        return vals if vdt is None else vals.to(vdt)

    def leaf(w, m, v, err, weights):
        if w.shape[0] != 1:
            raise ValueError("one spatial client per rank: carriers of "
                             f"shape {tuple(w.shape)}")
        shape_loc = w.shape[1:]
        n_loc = math.prod(shape_loc)
        wf = w.reshape(n_loc)
        words, pos, keep, kb = _local_pack(wf, alpha)
        vals_w = stream(wf, pos, keep, kb)
        new_err = None
        if err is not None:
            # what the server receives of this client: the (cast) stream
            # expanded back onto the plan; the overflow feeds the residual
            kept = torch.where(keep, vals_w.to(_F32)[pos.clamp(0, kb - 1)],
                               torch.zeros((), dtype=_F32, device=w.device))
            drop = wf.to(_F32) - kept
            new_err = (err.reshape(n_loc).to(_F32) + drop).to(err.dtype) \
                .reshape(err.shape)
        # THE UPLINK: the bitmap words and the value streams are the only
        # tensors that cross the group
        words_g = gather(words)
        out_w = _gathered_decode_sum(words_g, gather(vals_w), weights, n_loc)
        if shared:
            # the SSM alignment: ONE bitmap describes all three streams
            out_m, out_v = (_gathered_decode_sum(
                words_g, gather(stream(t.reshape(n_loc), pos, keep, kb)),
                weights, n_loc) for t in (m, v))
        else:
            # independent masks: M and V ship bitmaps of their own
            outs = []
            for t in (m, v):
                tf = t.reshape(n_loc)
                wds, ps, kp, cap = _local_pack(tf, alpha)
                outs.append(_gathered_decode_sum(
                    gather(wds), gather(stream(tf, ps, kp, cap)), weights,
                    n_loc))
            out_m, out_v = outs
        return tuple(o.reshape(shape_loc) for o in (out_w, out_m, out_v)), \
            new_err

    def agg(sW_c, sM_c, sV_c, weights, comp_err=None):
        lw, td = T.flatten(sW_c)
        if param_pspecs is not None and \
                len(T.leaves(param_pspecs)) != len(lw):
            raise ValueError(f"{len(lw)} carriers for "
                             f"{len(T.leaves(param_pspecs))} param specs")
        lm, lv = T.leaves(sM_c), T.leaves(sV_c)
        lerr = [None] * len(lw)
        err_td = None
        if comp_err is not None:
            lerr, err_td = T.flatten(comp_err)
        outs, errs = [], []
        for w, m, v, e in zip(lw, lm, lv, lerr):
            o, ne = leaf(w, m, v, e, weights)
            outs.append(o)
            errs.append(ne)
        sums = tuple(td.unflatten([o[i] for o in outs]) for i in range(3))
        if comp_err is None:
            return sums
        return sums, err_td.unflatten(errs)

    return agg
