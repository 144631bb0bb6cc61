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
round's own builders (``fed.make_client_step`` and
``fed.run_clients_stacked``, ``fed.make_server_apply``, and the scan
fold: ``aggregate.ordered_weighted_sum`` / ``wire_gather_sum`` /
``weight_total``).  The JAX
builders are ``jax.jit``-wrapped; here they are plain functions.  A group
of simultaneous dispatches runs two ways:

* ``client_exec="scan"``: a loop over its clients;
* ``client_exec="shardmap"``: one client per rank of a
  :class:`~repro_torch.launch.mesh.ClientMesh`, as the spatial round
  runs them (:func:`make_mesh_cohort_exec`).  The event loop is
  replicated on every rank (the churn is seeded); a group is padded to
  the world size by repeating its last client, rank r runs lane r, the
  lanes' outputs are all-gathered and the padded lanes discarded.  The
  step keeps the wire round trip, as the JAX cohort's does.
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
    make_client_step, make_server_apply, run_clients_stacked,
    stack_payloads)
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


def make_cohort_exec(fed: FedConfig, loss_fn: Callable,
                     comp: Optional[compressors.Compressor] = None):
    """A group of simultaneously dispatched clients, one after another
    through ``fed.make_client_step`` (``fed.run_clients_stacked``, as
    ``round_vmap`` runs them), so each client's outputs are bitwise the
    synchronous driver's.  ``exec_cohort(W, M, V, batches, cstates) ->
    (sW, sM, sV, new_cs, mets)``, inputs and outputs stacked ``(G, ...)``
    (``cstates`` and ``new_cs`` None without client state)."""
    client_step = make_client_step(fed, loss_fn, comp)

    def exec_cohort(W, M, V, batches, cstates):
        G = T.leaves(batches)[0].shape[0]
        return run_clients_stacked(client_step, W, M, V, batches, cstates,
                                   G)

    return exec_cohort


def make_mesh_cohort_exec(fed: FedConfig, loss_fn: Callable, mesh,
                          comp: Optional[compressors.Compressor] = None):
    """The cohort on the client group: ``exec_cohort(W, M, V, batches,
    cstates)`` with ``(G, ...)`` inputs, G the world size of ``mesh``:
    rank r runs client r's step (``fed.make_client_step``, the wire round
    trip kept), and every output is all-gathered into ``(G, ...)``, the
    same on every rank."""
    client_step = make_client_step(fed, loss_fn, comp)

    def exec_cohort(W, M, V, batches, cstates):
        r = mesh.rank
        pick = lambda t: None if t is None else T.tree_map(
            lambda x: x[r], t)
        out = client_step(W, M, V, pick(batches), pick(cstates))
        return tuple(None if o is None else T.tree_map(mesh.all_gather, o)
                     for o in out)

    return exec_cohort


def make_buffer_apply(fed: FedConfig,
                      comp: Optional[compressors.Compressor] = None):
    """One server step from a full buffer: ``apply(W, M, V, bufW, bufM,
    bufV, weights) -> (W', M', V')``, buffers stacked ``(K, ...)``,
    ``weights`` the (K,) effective weights (FedAvg weight x staleness
    scale), folded in ``round_scan``'s order and arithmetic."""
    server_apply = make_server_apply(fed, comp)

    def buffer_apply(W, M, V, bufW, bufM, bufV, weights):
        aW = aggregate.ordered_weighted_sum(bufW, weights)
        aM = aggregate.ordered_weighted_sum(bufM, weights)
        aV = aggregate.ordered_weighted_sum(bufV, weights)
        return server_apply(W, M, V, aW, aM, aV,
                            aggregate.weight_total(weights))

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
                 client_exec: str = "scan", mesh=None):
        if client_exec not in ("scan", "shardmap"):
            raise ValueError(f"client_exec={client_exec!r}: scan | "
                             "shardmap")
        if mesh is not None and mesh.fsdp_axes:
            from repro_torch.launch.mesh import FSDP_ITEM_REMAINDER
            raise NotImplementedError(
                "the async driver on a mesh with FSDP axes "
                f"{mesh.fsdp_axes} (the virtual clients' leaves split over "
                f"them) is not ported: {FSDP_ITEM_REMAINDER}")
        if client_exec == "shardmap":
            if not fed.client_axes or mesh is None:
                raise ValueError("the shardmap cohort needs fed.client_axes "
                                 "and the client group (mesh=)")
            mesh.check()
            if mesh.model_size > 1:
                from repro_torch.launch.mesh import TENSOR_ITEM
                raise NotImplementedError(
                    "the async group cohort on a model axis above 1 (split "
                    f"leaves) is not ported yet: {TENSOR_ITEM}")
        else:
            check_ported(fed)
            mesh = None
        self.fed = fed
        self.mesh = mesh
        self.acfg = acfg
        self.churn = churn if churn is not None \
            else ChurnModel(ChurnConfig(), fed.n_clients)
        if self.churn.n_clients != fed.n_clients:
            raise ValueError(f"churn model of {self.churn.n_clients} "
                             f"clients for {fed.n_clients}")
        self._comp = compressors.make_compressor(fed)
        self._exec = make_cohort_exec(fed, loss_fn, self._comp) \
            if mesh is None else \
            make_mesh_cohort_exec(fed, loss_fn, mesh, self._comp)
        self._apply = make_buffer_apply(fed, self._comp)
        self._apply_wire = make_wire_buffer_apply(fed, self._comp)

    def _run_group(self, W, M, V, batches, cs, group, has_cs):
        """The clients of ``group`` (all dispatched at one tick) against
        the snapshot (W, M, V); one record per client, in group order.  On
        the client group the group runs in lanes of the world size, the
        last client repeated, and the padded lanes are discarded."""
        lanes = list(group)
        if self.mesh is not None:
            world = self.mesh.world_size
            if len(lanes) > world:
                raise ValueError(f"{len(lanes)} simultaneous dispatches on "
                                 f"a group of {world} ranks")
            lanes += [lanes[-1]] * (world - len(lanes))
        take = lambda t: T.tree_map(
            lambda x: torch.stack([x[c] for c in lanes]), t)
        sW, sM, sV, ncs, mets = self._exec(
            W, M, V, take(batches), take(cs) if has_cs else None)
        out = []
        for i in range(len(group)):
            pick = lambda t: T.tree_map(lambda x: x[i], t)
            out.append(dict(sW=pick(sW), sM=pick(sM), sV=pick(sV),
                            ncs=(pick(ncs) if has_cs else None),
                            loss=mets["loss"][i]))
        return out

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

        sizes = tuple(x.numel() for x in T.leaves(W))
        # wire mode: buffer the payloads and bill their measured bytes;
        # the analytic count only where there is no wire realization
        wire_mode = self._comp.wire_bits_per_client(sizes) is not None
        bits_client = self._comp.bits_per_client(sum(sizes))

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
                records = self._run_group(W, M, V, batches, cs, group,
                                          has_cs)
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
                    rec["wire"] = self._comp.pack_wire(
                        Deltas(rec["sW"], rec["sM"], rec["sV"]))
                    rec["sW"] = rec["sM"] = rec["sV"] = None
                    bits_total += 8 * wire.payload_nbytes(rec["wire"])
                else:
                    bits_total += bits_client
                eff_w = float(base_w[c]) \
                    * float(staleness_scale(stale, acfg.staleness_power))
                buffer.append(dict(rec, stale=stale, w=eff_w))
                events.append((t, "deliver", c, stale))
                if len(buffer) == K:
                    stack = lambda key: T.tree_map(
                        lambda *xs: torch.stack(xs),
                        *[e[key] for e in buffer])
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
                        W, M, V = self._apply(W, M, V, stack("sW"),
                                              stack("sM"), stack("sV"), wts)
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
                     mesh=None) -> AsyncRoundDriver:
    """Build the buffered-async driver (mirrors ``make_fl_round``):
    ``run(state, batches, weights=None, rounds=1) -> (state, metrics)``
    on the synchronous round's :class:`FedState`, so the two drivers
    take each other's checkpoints.  ``client_exec="shardmap"`` runs the
    cohorts on the client group ``mesh``."""
    return AsyncRoundDriver(fed, loss_fn, acfg or AsyncConfig(),
                            churn=churn, client_exec=client_exec, mesh=mesh)
