"""Deterministic client-churn model for the buffered-async driver.

A copy of ``repro/data/churn.py`` (numpy only), so that the port's
driver sees the same event schedule as the JAX package's for the same
seed.

Millions of intermittently-connected devices means the traffic pattern
is churn: clients arrive, straggle, and vanish mid-round.  Async
aggregation bugs live in rare interleavings of exactly those events, so
this model is built for *replay*: every quantity is a pure function of
``(seed, client, attempt)`` — no wall clock, no global RNG state, no
dependence on the order the simulator happens to ask.  Two simulations
with the same ``ChurnConfig`` therefore see the **same** event schedule
bitwise, and any failing schedule is reproducible from its seed alone
(see docs/async.md for the replay recipe).

Time is a *virtual clock*: integer ticks advanced only by the event
queue in :mod:`repro_torch.core.async_fed`.  A tick has no physical
meaning beyond ordering; ``base_duration`` just sets the scale on which
staleness accrues.

The three churn behaviours, per dispatch:

* **jitter**     — uniform extra ticks on the compute duration, so
  deliveries interleave instead of arriving in lockstep;
* **straggler**  — with ``straggler_prob``, the duration is multiplied
  by ``straggler_factor``: the update arrives many server steps late
  and may exceed the driver's staleness cutoff;
* **drop**       — with ``drop_prob``, the client trains and compresses
  but the update is lost before delivery (device offline, network
  partition).  The driver must leave that client's error-feedback
  residual and local moments untouched — per-client compressor state
  survives dropout, it is never rezeroed (the Efficient-Adam lesson).

Tests can pin exact fates via ``script`` without touching the seeded
path for every other (client, attempt).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Seeded churn parameters.  The all-defaults config is ZERO churn:
    every dispatch takes exactly ``base_duration`` ticks and always
    delivers — the degenerate schedule under which the async driver is
    bit-identical to the synchronous round (tests/test_torch_async.py)."""
    seed: int = 0
    base_duration: int = 8        # ticks from dispatch to delivery
    jitter: int = 0               # + uniform{0..jitter} extra ticks
    straggler_prob: float = 0.0   # P[duration *= straggler_factor]
    straggler_factor: int = 6
    drop_prob: float = 0.0        # P[update lost after compress]
    rejoin_delay: int = 0         # ticks before a client re-dispatches

    def __post_init__(self):
        assert self.base_duration >= 1 and self.jitter >= 0
        assert 0.0 <= self.straggler_prob <= 1.0
        assert 0.0 <= self.drop_prob <= 1.0
        assert self.straggler_factor >= 1 and self.rejoin_delay >= 0


class ClientFate(NamedTuple):
    """What happens to one (client, attempt) dispatch."""
    duration: int                 # virtual ticks until delivery/loss
    drop: bool                    # lost after compress, before delivery


class ChurnModel:
    """Pure ``(client, attempt) -> ClientFate`` lookup.

    Each fate draws from ``np.random.default_rng([seed, client,
    attempt])`` — an order-independent counter-mode construction, so the
    schedule does not depend on simulation interleaving and replays
    bitwise from the seed.  ``script`` overrides individual fates
    (fault-injection tests): ``{(client, attempt): ClientFate(...)}``.
    """

    def __init__(self, cfg: ChurnConfig, n_clients: int,
                 script: Optional[Dict[Tuple[int, int],
                                       ClientFate]] = None):
        assert n_clients >= 1
        self.cfg = cfg
        self.n_clients = n_clients
        self.script = dict(script or {})

    def fate(self, client: int, attempt: int) -> ClientFate:
        key = (int(client), int(attempt))
        if key in self.script:
            return self.script[key]
        cfg = self.cfg
        rng = np.random.default_rng([cfg.seed, key[0], key[1]])
        # fixed draw order (jitter, straggler, drop) so adding a knob
        # later appends draws instead of reshuffling existing schedules
        dur = cfg.base_duration
        if cfg.jitter:
            dur += int(rng.integers(0, cfg.jitter + 1))
        if cfg.straggler_prob and rng.random() < cfg.straggler_prob:
            dur *= cfg.straggler_factor
        drop = bool(cfg.drop_prob) and rng.random() < cfg.drop_prob
        return ClientFate(int(dur), bool(drop))

    def participation_pool(self, n_active: int) -> np.ndarray:
        """The ``n_active`` clients admitted to the async dispatch pool
        (partial participation; ``n_active`` comes from
        ``fed.active_client_count`` — the shared sync/async seam).  A
        seeded permutation, independent of per-dispatch fates."""
        assert 1 <= n_active <= self.n_clients
        rng = np.random.default_rng([self.cfg.seed, 0x9001])
        return np.sort(rng.permutation(self.n_clients)[:n_active])
