"""Build the train step of a model on the mesh's ranks.

Counterpart of ``repro/launch/steps.py``'s ``ShapeSpec``, ``SHAPES`` and
``build_train_step`` (``sharding.plan_for`` picks the plan):

* a spatial ``tp`` plan: one FL client per row of a
  :class:`~repro_torch.launch.mesh.ClientMesh` (its ranks along the
  "model" axis hold its leaves split by ``sharding.param_rules("tp")``,
  ``models/params.pspecs``), the round of ``core/fed.py``
  (``client_mode="vmap"`` over the client axes), the transport keyed on
  the compressor's ``transport`` tag (the per-shard bitmap aggregate for
  the sparse ones);
* a virtual ``fsdp`` plan, on a mesh with no client axes: ``n_virtual``
  clients one after another (``client_mode="scan"``), each on the whole
  mesh, the dense aggregate, every leaf split over "model" by the tp
  rules and along its ``embed`` dim over the data[, pod] axes, and each
  client's ``global_batch`` sequences split over the rows.

Both use threshold masks and ``remat`` (``"full"`` by default) in the
loss, whose layers are the tensor-parallel ones on a model axis above 1.
The returned bundle's ``fn(state, batch)`` runs one round on the rank.

The spatial/fsdp and virtual/tp pairs, which no plan uses, raise naming
ROADMAP §1.10(b)'s remainder; the prefill and serve steps of the
production mesh are §1.10(c).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from repro_torch import sharding as shd
from repro_torch.configs.base import ArchConfig
from repro_torch.core.aggregate import make_shardmap_sparse_aggregate
from repro_torch.core.compressors import transport_of
from repro_torch.core.fed import FedConfig, fed_init, make_fl_round
from repro_torch.launch.mesh import FSDP_ITEM_REMAINDER
from repro_torch.models import model as M
from repro_torch.models import params as PM
from repro_torch.models.tensor import FSDP
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
    ``init(params, sharded=False)``: this rank's FedState from the whole
    params (``sharded``: from this rank's shards of them, e.g.
    ``models/params.materialize_shards``), with its client state (the
    spatial plans' ``(1, ...)``, the virtual plans' ``(n_virtual,
    ...)``); ``batch_shapes``: this rank's batch, leading ``(1,
    per_client)`` (spatial) or ``(n_virtual, global_batch / rows)``
    (virtual); ``static``: the configuration's bookkeeping, with the
    params' specs (``"pspecs"``)."""
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
    """The train step of ``cfg`` at ``shape`` on ``mesh`` under ``plan``
    (``sharding.plan_for(cfg.name)`` by default).  Spatial/tp: as many
    clients as the client axes hold, ``shape.global_batch // clients``
    sequences each, each client's leaves split over the model axis.
    Virtual/fsdp (``mesh`` with no client axes): ``plan.n_virtual``
    clients of ``shape.global_batch`` sequences each, in turn on every
    rank, each rank holding ``global_batch / rows`` of them and its
    shard of every leaf."""
    plan = plan or shd.plan_for(cfg.name)
    pair = (plan.clients, plan.train_params)
    if pair not in (("spatial", "tp"), ("virtual", "fsdp")):
        raise NotImplementedError(
            f"{cfg.name}: the {plan.clients}/{plan.train_params} plan (no "
            f"plan of the zoo uses it) is not ported: {FSDP_ITEM_REMAINDER}")
    virtual = plan.clients == "virtual"
    if virtual == bool(mesh.client_axes):
        raise ValueError(f"the {plan.clients} clients take a mesh with "
                         f"{'no ' if virtual else ''}client axes, got "
                         f"{mesh.client_axes}")
    mesh.check()
    multi_pod = "pod" in mesh.shape
    caxes = shd.client_axes(multi_pod)
    tp = mesh.model
    pspec = PM.pspecs(M.abstract_params(cfg),
                      shd.param_rules(plan.train_params, multi_pod), mesh)
    rows = mesh.world_size // mesh.model_size
    if virtual:
        n_clients = plan.n_virtual
        aggregate = aggregate or "dense"
        if shape.global_batch % rows:
            raise ValueError(f"a global batch of {shape.global_batch} on "
                             f"{rows} rows")
        batch_lead = (n_clients, shape.global_batch // rows)
        dg = mesh.data
        fsdp = None if dg is None else FSDP(dg, pspec, mesh.fsdp_axes)
    else:
        n_clients = mesh.n_clients
        if aggregate is None:
            # keyed on the compressor's transport tag: any sparse scheme
            # gets the per-shard bitmap uplink
            aggregate = ("sparse_gather" if transport_of(algorithm) in
                         ("shared_sparse", "independent_sparse")
                         else "dense")
        batch_lead = (1, max(1, shape.global_batch // n_clients))
        fsdp = None
    fed = FedConfig(
        algorithm=algorithm, alpha=alpha, local_epochs=local_epochs,
        n_clients=n_clients, adam=AdamHyper(lr=lr),
        client_mode="scan" if virtual else "vmap", aggregate=aggregate,
        # production masks: the O(d) threshold selection, which the
        # backend sends through the kernels on the card
        exact_topk=False, mask_scope="per_tensor",
        sparsify_backend=sparsify_backend,
        error_feedback=error_feedback, participation=participation,
        client_axes=None if virtual else caxes)

    n_front = _front_len(cfg, shape.seq_len)
    text_len = max(shape.seq_len - (n_front if cfg.encoder is None else 0),
                   32)

    def loss(params, batch):
        return M.loss_fn(cfg, params, batch["tokens"],
                         frontend_embeds=batch.get("embeds"), remat=remat,
                         tp=tp, fsdp=fsdp)

    sparse_agg = None
    if aggregate == "sparse_gather" and not virtual:
        sparse_agg = make_shardmap_sparse_aggregate(
            mesh, pspec, caxes, alpha,
            shared=(transport_of(algorithm) == "shared_sparse"))
    round_fn = make_fl_round(fed, loss, sparse_agg, mesh=mesh, pspecs=pspec)
    split = tp is not None or fsdp is not None

    def init(params, sharded: bool = False):
        # every client's initial state is the same: this rank's (1, ...)
        # slice of the spatial cohort, or the virtual clients' stack,
        # built on its shards
        if split and not sharded:
            params = PM.shard(params, pspec, mesh)
        return fed_init(dataclasses.replace(fed, n_clients=batch_lead[0]),
                        params)

    batch_shapes = {"tokens": batch_lead + (text_len,)}
    if n_front:
        batch_shapes["embeds"] = batch_lead + (n_front, cfg.d_model)
    return StepBundle(
        fn=round_fn, init=init, batch_shapes=batch_shapes,
        static=dict(kind="train", n_clients=n_clients, plan=plan, fed=fed,
                    fsdp=fsdp,
                    text_len=text_len, n_front=n_front, remat=remat,
                    pspecs=pspec))
