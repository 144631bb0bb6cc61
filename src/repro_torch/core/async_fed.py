"""Buffered-asynchronous FL rounds under client churn.

Counterpart of ``repro/core/async_fed.py``.  The synchronous round
(:mod:`repro_torch.core.fed`) waits for every client of the cohort; this
driver serves traffic where clients arrive, straggle and drop:

* clients train against **stale snapshots**: a dispatch captures
  ``(W, M, V)`` at server version ``v``; the update may land at ``v + s``;
* a server **buffer** collects ``K`` compressed updates and the server
  steps once it holds exactly ``K``, never fewer;
* aggregation is **staleness-weighted**: update ``i`` contributes
  ``weight_i * (1 + s_i) ** -power`` (exactly 1.0 at ``s == 0``, which
  makes the zero-churn configuration with ``K`` = cohort bitwise the
  synchronous round);
* updates staler than ``max_staleness`` at arrival are **discarded**;
* per-client state (error-feedback residuals, ``local_adam`` moments) is
  committed **only when an update is accepted**: a dropped or discarded
  client keeps its state bitwise, and only landed updates are billed.

Everything runs on a **virtual clock** driven by the seeded event model
of :mod:`repro_torch.data.churn`, so a simulation replays bitwise from
its seed, and the event schedule is the JAX package's for the same seed.

The per-client work and the server arithmetic are the synchronous
round's own builders (``fed.make_round_client_step``,
``fed.make_server_apply``, and the scan fold:
``aggregate.weighted_fold`` over the buffer's list in arrival order /
``wire_gather_sum`` / ``weight_total``).  The JAX builders are
``jax.jit``-wrapped; here they are plain functions.  A group of
simultaneous dispatches runs two ways:

* ``client_exec="scan"``: a loop over its clients through
  ``client_step``;
* ``client_exec="shardmap"``: one client per row of a
  :class:`~repro_torch.launch.mesh.ClientMesh`, as the spatial round
  runs them (:func:`make_mesh_cohort_exec`).  The event loop is
  replicated on every rank (the churn is seeded); a group is padded to
  the mesh's clients by repeating its last client, the ranks of client
  index i run lane i, the lanes' outputs are all-gathered over the
  client group and the padded lanes discarded.

Both run on split leaves too, with ``mesh`` and the params' specs
(``pspecs``), as the synchronous round does: the group cohort on a
model axis above 1 (the ``tp`` plans: each rank holds its model shard of
W, M, V and of every client's state, stacked ``(C, ...)``), and the
scan cohort on a mesh with FSDP axes (the ``fsdp`` plans' virtual
clients: each rank holds its shards and its ``fed.local_batch`` slice of
each client's batch).  The masks, scales and norms are the whole
leaves' (``sparsify.LeafSplit``).  On the group cohort the records in
flight hold each carrier leaf as its nonzeros (:class:`Nonzeros`),
gathered that way.  On whole leaves the step keeps the wire round
trip, as the JAX cohort's does, and a landed update is buffered as its
payload and billed at its measured bytes; on split leaves a shard's
payload would be packed with a shard's capacity, so the buffer keeps
the carriers, the server step folds them in arrival order, and each
landed update is billed at the whole leaves' static layout, as the
synchronous round bills them.  The metrics and the bill are the whole
leaves', the same on every rank.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import aggregate, compressors, wire
from repro_torch.core.compressors import Deltas
from repro_torch.core.fed import (
    FedConfig, FedState, active_client_count, check_ported,
    make_round_client_step, make_server_apply, stack_payloads)
from repro_torch.data.churn import ChurnConfig, ChurnModel

_F32 = torch.float32


# ---------------------------------------------------------------------------
# Staleness weighting
# ---------------------------------------------------------------------------


def staleness_scale(staleness, power: float = 0.5):
    """Per-update multiplier ``(1 + s) ** -power`` (host math, float64):
    monotone non-increasing in ``s``, in ``(0, 1]``, and exactly 1.0 at
    ``s == 0``."""
    s = np.asarray(staleness, np.float64)
    if not (np.all(s >= 0) and power >= 0.0):
        raise ValueError(f"staleness {staleness} and power {power} must be "
                         "nonnegative")
    return (1.0 + s) ** (-float(power))


def staleness_weights(staleness, power: float = 0.5) -> np.ndarray:
    """Normalized buffer weights ``scale(s_i) / sum_j scale(s_j)``:
    nonnegative, summing to 1, non-increasing in staleness."""
    s = staleness_scale(staleness, power)
    return s / s.sum()


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Buffered-async server policy (the churn schedule itself lives in
    :class:`repro_torch.data.churn.ChurnConfig`)."""
    buffer_size: int = 4              # K: updates per server step
    max_staleness: Optional[int] = None   # arrival cutoff; None = accept all
    staleness_power: float = 0.5      # (1+s)**-power aggregation weight

    def __post_init__(self):
        if self.buffer_size < 1 or self.staleness_power < 0.0 or (
                self.max_staleness is not None and self.max_staleness < 0):
            raise ValueError(f"invalid {self}")


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def _client(tree, c: int):
    """Client ``c``'s slice of a client-stacked ``(C, ...)`` tree (views),
    or ``None``."""
    return None if tree is None else T.tree_map(lambda x: x[c], tree)


class Nonzeros:
    """A carrier leaf held as its nonzeros (flat indices and values) while
    it waits in flight or in the buffer: a mask's carriers are mostly
    zeros.  :meth:`dense` gives the leaf back; a zero of either sign
    comes back as +0.0, which adds the same to every FedAvg sum."""

    __slots__ = ("shape", "idx", "vals")

    def __init__(self, shape, idx, vals):
        self.shape, self.idx, self.vals = shape, idx, vals

    def dense(self) -> torch.Tensor:
        out = self.vals.new_zeros(self.shape.numel())
        out[self.idx] = self.vals
        return out.reshape(self.shape)


def hold_nonzeros(x: torch.Tensor):
    """``x`` as :class:`Nonzeros` where under a third of it is nonzero
    (the index and the value then take less than the dense leaf), else
    ``x``."""
    flat = x.reshape(-1)
    idx = flat.nonzero().squeeze(1)
    if 3 * idx.numel() >= flat.numel():
        return x
    return Nonzeros(x.shape, idx, flat[idx])


def _dense(leaf):
    return leaf.dense() if isinstance(leaf, Nonzeros) else leaf


def make_cohort_exec(client_step: Callable):
    """A group of simultaneously dispatched clients, one after another
    through the round's ``client_step`` (``fed.make_round_client_step``),
    so each client's outputs are bitwise the synchronous driver's.
    ``exec_cohort(W, M, V, batches, cstates, group)``: ``batches`` and
    ``cstates`` client-stacked ``(C, ...)`` (``cstates`` None without
    client state), client ``c`` of ``group`` on slice ``c``; returns one
    ``(sW, sM, sV, new_cstate, mets)`` per client of ``group``, in its
    order."""

    def exec_cohort(W, M, V, batches, cstates, group):
        return [client_step(W, M, V, _client(batches, c),
                            _client(cstates, c)) for c in group]

    return exec_cohort


def make_mesh_cohort_exec(client_step: Callable, mesh):
    """The cohort on the client group, ``exec_cohort`` as
    :func:`make_cohort_exec`'s: the group padded to the clients of
    ``mesh`` by repeating its last client, the ranks of client index i
    run lane i's ``client_step`` (on a model axis above 1 each on its
    shards of the leaves and of the client state), every output is
    all-gathered over the client group leaf by leaf, and the padded
    lanes' parts are dropped at once; the same outputs on every rank of
    a model index.  Every rank holds every client's carriers: a carrier
    leaf is gathered and held as its nonzeros (:func:`_gather_nonzeros`).
    The records hold each client's gathered parts alone, so a client's
    record never keeps another's alive."""

    def exec_cohort(W, M, V, batches, cstates, group):
        n = mesh.n_clients
        if len(group) > n:
            raise ValueError(f"{len(group)} simultaneous dispatches on a "
                             f"group of {n} clients")
        lanes = list(group) + [group[-1]] * (n - len(group))
        c = lanes[mesh.client_index]
        out = list(client_step(W, M, V, _client(batches, c),
                               _client(cstates, c)))
        parts = []
        for j, o in enumerate(out):
            # this rank's output goes once gathered
            out[j] = None
            parts.append(None if o is None else _gather_clients(
                mesh, o, len(group), j < 3))
        return [tuple(None if p is None else p[i] for p in parts)
                for i in range(len(group))]

    return exec_cohort


def _gather_clients(mesh, tree, n: int, held: bool) -> list:
    """The first ``n`` clients' ``tree`` over the client group, one tree
    each (the others' parts freed); with ``held`` (a carrier) each leaf as
    :func:`hold_nonzeros` holds it (:func:`_gather_nonzeros`)."""
    gather = _gather_nonzeros if held else \
        (lambda mesh, x: mesh.all_gather_list(x))
    leaves, td = T.flatten(tree)
    parts = [gather(mesh, x)[:n] for x in leaves]
    return [td.unflatten([p[i] for p in parts]) for i in range(n)]


def _gather_nonzeros(mesh, x: torch.Tensor) -> list:
    """Every client's ``x`` over the client group as
    :func:`hold_nonzeros` holds it, gathered as the nonzeros alone (the
    counts, then the indices and values padded to the largest count)
    where every client's is under a third nonzero, else whole: the same
    leaves as gathering ``x`` whole and holding each, in fewer bytes."""
    flat = x.reshape(-1)
    idx = flat.nonzero().squeeze(1)
    counts = [int(c) for c in mesh.all_gather_list(
        torch.tensor([idx.numel()], dtype=torch.int64, device=x.device))]
    if any(3 * c >= flat.numel() for c in counts):
        return [hold_nonzeros(p) for p in mesh.all_gather_list(x)]
    most = max(counts)
    if most == 0:
        return [Nonzeros(x.shape, idx, flat[idx]) for _ in counts]
    pad = lambda t: torch.cat([t, t.new_zeros(most - t.numel())])
    idxs = mesh.all_gather_list(pad(idx))
    vals = mesh.all_gather_list(pad(flat[idx]))
    return [Nonzeros(x.shape, i[:c], v[:c])
            for i, v, c in zip(idxs, vals, counts)]


def make_buffer_apply(fed: FedConfig,
                      comp: Optional[compressors.Compressor] = None):
    """One server step from a full buffer: ``apply(W, M, V, bufW, bufM,
    bufV, weights) -> (W', M', V')``, buffers the K landed carriers in
    arrival order (lists of trees, whose leaves may be :class:`Nonzeros`),
    ``weights`` the (K,) effective weights
    (FedAvg weight x staleness scale), folded in ``round_scan``'s order
    and arithmetic (``aggregate.weighted_fold``, as
    ``ordered_weighted_sum`` folds a stack) without stacking them."""
    server_apply = make_server_apply(fed, comp)

    def fold(trees, w):
        acc = None
        for k, tree in enumerate(trees):
            acc = aggregate.weighted_fold(acc, w[k],
                                          T.tree_map(_dense, tree))
        return acc

    def buffer_apply(W, M, V, bufW, bufM, bufV, weights):
        w = weights.to(_F32)
        return server_apply(W, M, V, fold(bufW, w), fold(bufM, w),
                            fold(bufV, w), aggregate.weight_total(weights))

    return buffer_apply


def make_wire_buffer_apply(fed: FedConfig,
                           comp: Optional[compressors.Compressor] = None):
    """Wire twin of :func:`make_buffer_apply`: the buffer holds the K
    landed payloads (stacked ``(K, ...)``), the bytes that crossed the
    uplink, and the server decodes and folds them in arrival order
    (``aggregate.wire_gather_sum``)."""
    if comp is None:
        comp = compressors.make_compressor(fed)
    server_apply = make_server_apply(fed, comp)

    def buffer_apply(W, M, V, payloads, weights):
        aW, aM, aV = aggregate.wire_gather_sum(comp, payloads, W, weights)
        return server_apply(W, M, V, aW, aM, aV,
                            aggregate.weight_total(weights))

    return buffer_apply


def make_commit_client(has_cs: bool):
    """``commit(cs, new_c, c) -> cs``: write ONE accepted client's new
    state into slot ``c`` of the stacked ``client_state``, in place (the
    driver's own copy; the only path that changes it: drops and discards
    never reach it)."""

    def commit(cs, new_c, c):
        if not has_cs:
            return None
        T.tree_map(lambda full, new: full[c].copy_(new), cs, new_c)
        return cs

    return commit


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

_EV_DISPATCH, _EV_ARRIVE = 0, 1


class AsyncRoundDriver:
    """Event-driven buffered-async simulation (see the module docstring);
    build it with :func:`make_async_round`."""

    def __init__(self, fed: FedConfig, loss_fn: Callable,
                 acfg: AsyncConfig, churn: Optional[ChurnModel] = None,
                 client_exec: str = "scan", mesh=None, pspecs=None):
        if client_exec not in ("scan", "shardmap"):
            raise ValueError(f"client_exec={client_exec!r}: scan | "
                             "shardmap")
        if client_exec == "shardmap":
            if not fed.client_axes or mesh is None:
                raise ValueError("the shardmap cohort needs fed.client_axes "
                                 "and the client group (mesh=)")
            mesh.check()
        else:
            check_ported(fed, mesh)
        self.fed = fed
        self.mesh = mesh
        self.acfg = acfg
        self.churn = churn if churn is not None \
            else ChurnModel(ChurnConfig(), fed.n_clients)
        if self.churn.n_clients != fed.n_clients:
            raise ValueError(f"churn model of {self.churn.n_clients} "
                             f"clients for {fed.n_clients}")
        self._comp, self._split, step = make_round_client_step(
            fed, loss_fn, mesh, pspecs)
        self._exec = make_cohort_exec(step) if client_exec == "scan" \
            else make_mesh_cohort_exec(step, mesh)
        self._apply = make_buffer_apply(fed, self._comp)
        self._apply_wire = make_wire_buffer_apply(fed, self._comp)

    def _run_group(self, W, M, V, batches, cs, group):
        """The clients of ``group`` (all dispatched at one tick) against
        the snapshot (W, M, V); one record per client, in group order."""
        return [dict(sW=sW, sM=sM, sV=sV, ncs=ncs, loss=mets["loss"])
                for sW, sM, sV, ncs, mets in self._exec(W, M, V, batches, cs,
                                                        group)]

    def __call__(self, state: FedState, batches, weights=None, *,
                 rounds: int = 1, max_events: Optional[int] = None):
        """Run until ``rounds`` server steps have been applied, or the
        ``max_events`` budget runs out (then ``metrics["server_steps"] <
        rounds``).  ``batches``: client-major tree, leaves ``(C, ...)``;
        client ``c`` trains on slice ``c`` at every dispatch.  ``weights``:
        optional (C,) FedAvg weights.  Returns ``(FedState, metrics)``;
        ``metrics["events"]`` is the replayable event log.  ``state`` is
        left as it was."""
        fed, acfg = self.fed, self.acfg
        C = fed.n_clients
        K = acfg.buffer_size
        if weights is None:
            weights = np.ones((C,), np.float64)
        base_w = np.asarray(weights.cpu() if isinstance(weights, torch.Tensor)
                            else weights, np.float64)
        if base_w.shape != (C,):
            raise ValueError(f"weights of shape {base_w.shape} for {C} "
                             "clients")
        if max_events is None:
            max_events = 64 * C * max(1, rounds) + 256

        has_cs = state.client_state is not None
        W, M, V = state.W, state.M, state.V
        device = T.leaves(W)[0].device
        # commits write slots in place: into the driver's own copy
        cs = T.tree_map(torch.clone, state.client_state) if has_cs else None
        commit = make_commit_client(has_cs)
        server_round = int(state.round)
        round0 = server_round

        split = self._split
        sizes = tuple(x.numel() for x in T.leaves(W)) if split is None \
            else split.sizes(W)
        layout_bits = self._comp.wire_bits_per_client(sizes)
        # wire mode (whole leaves): buffer the payloads and bill their
        # measured bytes.  Else buffer the carriers and bill the whole
        # leaves' static layout, the analytic count where there is no wire
        # realization (the synchronous round's bill)
        wire_mode = split is None and layout_bits is not None
        bits_client = layout_bits if layout_bits is not None \
            else self._comp.bits_per_client(sum(sizes))

        # participation: the dispatch pool is the n_active clients that
        # the churn model admits; everyone else never dispatches
        if fed.participation < 1.0:
            pool = self.churn.participation_pool(active_client_count(fed))
        else:
            pool = np.arange(C)

        q: List = []
        seq = itertools.count()
        push = lambda t, kind, payload: heapq.heappush(
            q, (t, next(seq), kind, payload))
        for c in pool:
            push(0, _EV_DISPATCH, int(c))

        attempts = {int(c): 0 for c in pool}
        inflight: Dict[int, Dict[str, Any]] = {}
        buffer: List[Dict[str, Any]] = []
        events: List[tuple] = []
        landed = dropped = discarded = steps = 0
        bits_total = 0
        bits_per_step: List[int] = []
        step_losses: List[torch.Tensor] = []

        def redispatch(t, c):
            push(t + self.churn.cfg.rejoin_delay, _EV_DISPATCH, c)

        n_events = 0
        while q and steps < rounds and n_events < max_events:
            t, _, kind, c = heapq.heappop(q)
            n_events += 1

            if kind == _EV_DISPATCH:
                # every dispatch of this tick is one group against one
                # snapshot (they are consecutive in the queue)
                group = [c]
                while q and q[0][0] == t and q[0][2] == _EV_DISPATCH:
                    group.append(heapq.heappop(q)[3])
                    n_events += 1
                records = self._run_group(W, M, V, batches, cs, group)
                for gc, rec in zip(group, records):
                    a = attempts[gc]
                    attempts[gc] += 1
                    fate = self.churn.fate(gc, a)
                    rec["ver"] = server_round
                    rec["drop"] = fate.drop
                    inflight[gc] = rec
                    events.append((t, "dispatch", gc, a))
                    push(t + fate.duration, _EV_ARRIVE, gc)
                del records
                continue

            # _EV_ARRIVE: delivery attempt of client c
            rec = inflight.pop(c)
            stale = server_round - rec["ver"]
            if rec["drop"]:
                # lost after compress: nothing lands, is committed or billed
                dropped += 1
                events.append((t, "drop", c, stale))
            elif acfg.max_staleness is not None \
                    and stale > acfg.max_staleness:
                # too stale at arrival: the same guarantees as a drop
                discarded += 1
                events.append((t, "discard", c, stale))
            else:
                # ACCEPT: the only path that commits client state and
                # bills uplink bits
                cs = commit(cs, rec["ncs"], c)
                rec["ncs"] = None
                landed += 1
                if wire_mode:
                    # the landed bytes, repacked from the decoded carriers
                    # (the pack is idempotent on them), billed as measured
                    rec["wire"] = self._comp.pack_wire(Deltas(*(
                        T.tree_map(_dense, rec[k])
                        for k in ("sW", "sM", "sV"))))
                    rec["sW"] = rec["sM"] = rec["sV"] = None
                    bits_total += 8 * wire.payload_nbytes(rec["wire"])
                else:
                    bits_total += bits_client
                eff_w = float(base_w[c]) \
                    * float(staleness_scale(stale, acfg.staleness_power))
                buffer.append(dict(rec, stale=stale, w=eff_w))
                events.append((t, "deliver", c, stale))
                if len(buffer) == K:
                    wts = torch.tensor([e["w"] for e in buffer],
                                       dtype=_F32)
                    if device.type == "cuda":
                        wts = wts.pin_memory()
                    wts = wts.to(device, non_blocking=True)
                    if wire_mode:
                        # the server step decodes the transported bytes
                        W, M, V = self._apply_wire(
                            W, M, V,
                            stack_payloads([e["wire"] for e in buffer]),
                            wts)
                    else:
                        W, M, V = self._apply(
                            W, M, V, *([e[key] for e in buffer]
                                       for key in ("sW", "sM", "sV")), wts)
                    server_round += 1
                    steps += 1
                    bits_per_step.append(bits_total - sum(bits_per_step))
                    step_losses.append(torch.stack(
                        [e["loss"] for e in buffer]).to(torch.float64)
                        .mean())
                    events.append((t, "server_step", steps,
                                   [e["stale"] for e in buffer]))
                    buffer = []
            redispatch(t, c)

        new_state = FedState(W=W, M=M, V=V, round=round0 + steps,
                             client_state=cs)
        # the step losses reach the host once, after the simulation
        loss_per_step = torch.stack(step_losses).cpu().tolist() \
            if step_losses else []
        metrics = {
            "uplink_bits": torch.tensor(float(bits_total), dtype=_F32),
            "bits_per_step": bits_per_step,
            "loss_per_step": loss_per_step,
            "server_steps": steps,
            "landed": landed,
            "dropped": dropped,
            "discarded": discarded,
            "buffer_pending": len(buffer),
            "events": events,
        }
        return new_state, metrics


def make_async_round(fed: FedConfig, loss_fn: Callable,
                     acfg: Optional[AsyncConfig] = None, *,
                     churn: Optional[ChurnModel] = None,
                     client_exec: str = "scan",
                     mesh=None, pspecs=None) -> AsyncRoundDriver:
    """Build the buffered-async driver (mirrors ``make_fl_round``):
    ``run(state, batches, weights=None, rounds=1) -> (state, metrics)``
    on the synchronous round's :class:`FedState`, so the two drivers
    take each other's checkpoints.  ``client_exec="shardmap"`` runs the
    cohorts on the client group ``mesh``.  On split leaves (a model axis
    above 1 with the shardmap cohort, FSDP axes with the scan cohort)
    ``pspecs`` are the params' specs, as ``make_fl_round`` takes them:
    the state's leaves and every client's state ``(C, ...)`` are this
    rank's shards, ``loss_fn`` runs the split layers, and on FSDP axes
    ``batches`` is this rank's ``fed.local_batch``."""
    return AsyncRoundDriver(fed, loss_fn, acfg or AsyncConfig(),
                            churn=churn, client_exec=client_exec, mesh=mesh,
                            pspecs=pspecs)
