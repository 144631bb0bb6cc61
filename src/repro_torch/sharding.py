"""Logical-axis -> mesh-axis rules, deployment plans and the client axes
of the multi-GPU driver.

Counterpart of ``repro/sharding.py``, as data:

``tp``      : Megatron-style tensor parallelism: heads, kv_heads, mlp,
              experts, vocab, ssm_heads and ssm_inner over "model",
              everything else replicated (``models/params.pspecs`` turns
              the rules into each leaf's spec, ``models/tensor.py`` and
              the layers' tensor-parallel forms run them).
``fsdp``    : tp + the d_model ("embed") dim over the data[, pod] axes,
              each leaf gathered over the data group at its use
              (``models/tensor.FSDP``).

``spatial`` : FL clients = the client axes of the mesh; each client's
              divergent replica on its own ranks (``core/fed.py``'s
              spatial round), split over its "model" ranks.
``virtual`` : FL clients time-multiplexed over the whole group (the
              scan round on a mesh with no client axes), the leaves
              split by the ``fsdp`` rules.

:func:`cache_rules` lays out the decode caches of the sharded serve steps
(``launch/steps.build_serve_step``): the batch over the client axes, kv
and SSD heads over "model", and for the long shapes (or
``cache_seq_shard``) the cache's sequence over "data", the split-KV
decode whose softmax the ranks combine (``models/layers.py``).  A
serving plan's ``fsdp`` params are the 2-D serving of
``models/tensor.Serve2D``: each leaf's ``embed`` dim stays split over
the data axes, and the activations move instead.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def client_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def fsdp_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("data", "pod") if multi_pod else ("data",)


def param_rules(kind: str, multi_pod: bool) -> dict:
    """Logical axis -> mesh axis (a name, a tuple of names, or None) of
    the ``tp`` or ``fsdp`` parameter rules."""
    rules = {
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "ssm_heads": "model",
        "ssm_inner": "model",
        "embed": None,
        "kv_lora": None,
        "head_dim": None,
        "conv": None,
        "layers": None,
    }
    if kind == "fsdp":
        rules["embed"] = fsdp_axes(multi_pod)
    elif kind != "tp":
        raise ValueError(kind)
    return rules


def cache_rules(shape_kind: str, multi_pod: bool,
                cache_seq_shard=None) -> dict:
    """Logical rules of the decode caches.  ``cache_seq_shard``: an
    optional mesh axis (or tuple) for the cache's sequence dim, the
    split-KV decode of the long shapes."""
    rules = {
        "batch": client_axes(multi_pod),
        "kv_heads": "model",
        "ssm_heads": "model",
        "ssm_inner": "model",
        "kv_lora": None,
        "kv_seq": None,
        "enc_seq": None,
        "head_dim": None,
        "ssm_state": None,
        "conv": None,
        "layers": None,
        "embed": None,
    }
    if shape_kind == "long":
        # batch 1: the cache's sequence axis is sharded instead
        rules["batch"] = None
        rules["kv_seq"] = "data"
    if cache_seq_shard is not None:
        rules["kv_seq"] = cache_seq_shard
    return rules


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
    """A sharding constraint in the JAX package; the port's communication
    is explicit (``models/tensor.py``), so the identity."""
    return x
