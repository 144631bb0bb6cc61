"""Deployment plans and the client axes of the multi-GPU driver.

Counterpart of the spatial part of ``repro/sharding.py``, as data:

``spatial`` : FL clients = the ranks of the client group, laid out on
              the data (and pod) axes; each rank holds its own client's
              divergent replica (``core/fed.py``'s spatial round).
``virtual`` : FL clients time-multiplexed over the whole group.

The port holds whole leaves on every rank (a model axis of 1), so the
``tp`` plan of a spatial deployment needs no rule here.  The parameter
and cache rules (``param_rules``, ``fsdp_axes``, ``cache_rules``), which
a model axis above 1 or the ``fsdp`` plans need, are the open half of
ROADMAP §1.10.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def client_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


@dataclasses.dataclass(frozen=True)
class DeployPlan:
    clients: str = "spatial"        # spatial | virtual
    train_params: str = "tp"        # tp | fsdp
    serve_params: str = "tp"        # tp | fsdp  (fsdp = "2D" for serving)
    n_virtual: int = 2              # virtual-client count in dry-run
    why: str = ""


_BIG = DeployPlan(
    clients="virtual", train_params="fsdp", serve_params="fsdp",
    why="FedAdam state (~7x weights) exceeds a 16-chip TP group; params "
        "fully sharded over (data[,pod],model), clients time-multiplexed")

_MID = DeployPlan(
    clients="virtual", train_params="fsdp", serve_params="tp",
    why="training state needs FSDP; serving weights fit a TP group")

PLANS = {
    "kimi-k2-1t-a32b": dataclasses.replace(
        _BIG, why=_BIG.why + "; 1T params — serving also needs 2D"),
    "jamba-1-5-large-398b": _BIG,
    "mistral-large-123b": _MID,
    "gemma3-27b": _MID,
    "deepseek-v2-lite-16b": DeployPlan(
        clients="spatial", train_params="tp", serve_params="tp",
        why="16B: per-client TP state ~14GB — spatial clients on the data "
            "axis exercise the full on-mesh sparse uplink"),
}

_DEFAULT = DeployPlan(why="small arch: spatial clients, TP within client")


def plan_for(arch: str) -> DeployPlan:
    return PLANS.get(arch, _DEFAULT)


def hint(x, *axes):
    """A sharding constraint in the JAX package; every rank holds whole
    leaves here, so the identity."""
    return x
