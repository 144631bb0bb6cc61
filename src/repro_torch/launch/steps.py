"""Build the spatial train step of a model on the client group.

Counterpart of ``repro/launch/steps.py``'s ``ShapeSpec``, ``SHAPES`` and
``build_train_step`` for a spatial ``tp`` plan (``sharding.plan_for``):
one FL client per row of a :class:`~repro_torch.launch.mesh.ClientMesh`
(its ranks along the "model" axis hold its leaves split by
``sharding.param_rules("tp")``, ``models/params.pspecs``), the round of
``core/fed.py`` (``client_mode="vmap"`` over the client axes), the
transport keyed on the compressor's ``transport`` tag (the per-shard
bitmap aggregate for the sparse ones), threshold masks, and ``remat``
(``"full"`` by default) in the loss, whose layers are the
tensor-parallel ones on a model axis above 1.  The returned bundle's
``fn(state, batch)`` runs one round on the rank.

A ``virtual`` or ``fsdp`` plan is ROADMAP §1.10(b); the prefill and
serve steps of the production mesh are §1.10(c).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from repro_torch import sharding as shd
from repro_torch.configs.base import ArchConfig
from repro_torch.core.aggregate import make_shardmap_sparse_aggregate
from repro_torch.core.compressors import transport_of
from repro_torch.core.fed import FedConfig, fed_init, make_fl_round
from repro_torch.launch.mesh import FSDP_ITEM
from repro_torch.models import model as M
from repro_torch.models import params as PM
from repro_torch.optim.adam import AdamHyper


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode | long


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "long"),
}


@dataclasses.dataclass
class StepBundle:
    """``fn(state, batch) -> (state, metrics)``: one round on this rank;
    ``init(params)``: this rank's FedState from the whole params (its
    shards of them and its ``(1, ...)`` client state); ``batch_shapes``:
    this rank's batch, leading ``(1, per_client)``; ``static``: the
    configuration's bookkeeping, with the params' specs (``"pspecs"``)."""
    fn: Callable
    init: Callable
    batch_shapes: Dict[str, tuple]
    static: Dict[str, Any]


def _front_len(cfg: ArchConfig, seq_len: int) -> int:
    """Stub-frontend token budget within the sequence."""
    if cfg.encoder is not None:
        return cfg.encoder.src_len
    if cfg.stub_frontend:
        return min(cfg.stub_frontend_tokens, max(seq_len // 2, 16))
    return 0


def build_train_step(cfg: ArchConfig, mesh, shape: ShapeSpec, *,
                     algorithm: str = "fedadam_ssm", alpha: float = 0.05,
                     local_epochs: int = 2, remat: str = "full",
                     aggregate: Optional[str] = None,
                     plan: Optional[shd.DeployPlan] = None,
                     lr: float = 1e-3,
                     error_feedback: bool = False,
                     sparsify_backend: str = "auto",
                     participation: float = 1.0) -> StepBundle:
    """The spatial train step of ``cfg`` at ``shape`` on ``mesh``: as many
    clients as the client axes hold, ``shape.global_batch // clients``
    sequences each, each client's leaves split over the model axis."""
    plan = plan or shd.plan_for(cfg.name)
    if plan.clients != "spatial" or plan.train_params != "tp":
        raise NotImplementedError(
            f"{cfg.name}: the {plan.clients}/{plan.train_params} plan "
            "needs the virtual clients and the FSDP sharding of the "
            f"leaves, not ported yet: {FSDP_ITEM}")
    mesh.check()
    multi_pod = "pod" in mesh.shape
    caxes = shd.client_axes(multi_pod)
    n_clients = mesh.n_clients
    tp = mesh.model
    pspec = PM.pspecs(M.abstract_params(cfg),
                      shd.param_rules(plan.train_params, multi_pod), mesh)
    if aggregate is None:
        # keyed on the compressor's transport tag: any sparse scheme gets
        # the per-shard bitmap uplink
        aggregate = ("sparse_gather" if transport_of(algorithm) in
                     ("shared_sparse", "independent_sparse") else "dense")
    fed = FedConfig(
        algorithm=algorithm, alpha=alpha, local_epochs=local_epochs,
        n_clients=n_clients, adam=AdamHyper(lr=lr),
        client_mode="vmap", aggregate=aggregate,
        # production masks: the O(d) threshold selection, which the
        # backend sends through the kernels on the card
        exact_topk=False, mask_scope="per_tensor",
        sparsify_backend=sparsify_backend,
        error_feedback=error_feedback, participation=participation,
        client_axes=caxes)

    n_front = _front_len(cfg, shape.seq_len)
    text_len = max(shape.seq_len - (n_front if cfg.encoder is None else 0),
                   32)
    per_client = max(1, shape.global_batch // n_clients)

    def loss(params, batch):
        return M.loss_fn(cfg, params, batch["tokens"],
                         frontend_embeds=batch.get("embeds"), remat=remat,
                         tp=tp)

    sparse_agg = None
    if aggregate == "sparse_gather":
        sparse_agg = make_shardmap_sparse_aggregate(
            mesh, pspec, caxes, alpha,
            shared=(transport_of(algorithm) == "shared_sparse"))
    round_fn = make_fl_round(fed, loss, sparse_agg, mesh=mesh, pspecs=pspec)

    def init(params):
        # every client's initial state is the same, so this rank's
        # (1, ...) slice is a one-client cohort's, built on its shards
        if tp is not None:
            params = PM.shard(params, pspec, mesh)
        return fed_init(dataclasses.replace(fed, n_clients=1), params)

    batch_shapes = {"tokens": (1, per_client, text_len)}
    if n_front:
        batch_shapes["embeds"] = (1, per_client, n_front, cfg.d_model)
    return StepBundle(
        fn=round_fn, init=init, batch_shapes=batch_shapes,
        static=dict(kind="train", n_clients=n_clients, plan=plan, fed=fed,
                    text_len=text_len, n_front=n_front, remat=remat,
                    pspecs=pspec))
