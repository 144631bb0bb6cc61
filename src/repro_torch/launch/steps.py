"""Build the train, prefill and serve (decode) steps of a model on the
mesh's ranks.

Counterpart of ``repro/launch/steps.py`` (``sharding.plan_for`` picks the
plan, ``build_step`` the builder by the shape's kind):

* the train step (:func:`build_train_step`), for a spatial ``tp`` plan:
  one FL client per row of a :class:`~repro_torch.launch.mesh.ClientMesh`
  (its ranks along the "model" axis hold its leaves split by
  ``sharding.param_rules("tp")``, ``models/params.pspecs``), the round of
  ``core/fed.py`` (``client_mode="vmap"`` over the client axes), the
  transport keyed on the compressor's ``transport`` tag (the per-shard
  bitmap aggregate for the sparse ones); for a virtual ``fsdp`` plan, on
  a mesh with no client axes: ``n_virtual`` clients one after another
  (``client_mode="scan"``), each on the whole mesh, the dense aggregate,
  every leaf split over "model" by the tp rules and along its ``embed``
  dim over the data[, pod] axes, and each client's ``global_batch``
  sequences split over the rows.  Both use threshold masks and ``remat``
  (``"full"`` by default) in the loss, whose layers are the
  tensor-parallel ones on a model axis above 1.  ``fn(state, batch)``
  runs one round on the rank.
* the prefill and serve steps (:func:`build_prefill_step`,
  :func:`build_serve_step`), on a serving mesh (no client axes): the
  batch split over the data[, pod] axes in JAX's row-major ``("pod",
  "data")`` order, each leaf split by ``param_rules(plan.serve_params)``
  (the ``fsdp`` plans' 2-D serving: ``embed`` over the data[, pod] axes
  too, ``models.tensor.Serve2D``), each cache leaf by
  ``sharding.cache_rules`` (the long shapes' split-KV cache: ``kv_seq``
  over "data" and the batch whole on every rank; ``cache_seq_shard``).
  ``fn(params, batch)`` returns this rank's rows' last logits over the
  whole vocabulary and its prefill cache shards; ``fn(params, caches,
  pos, token)`` one decode step, its cache shards written in place.

Every registered compressor runs on both train plans (its masks, scales
and norms the whole leaves', ``core/sparsify.LeafSplit``).  The
spatial/fsdp and virtual/tp train plan pairs, which no plan uses, raise
naming ROADMAP §1.10(b)'s remainder.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import sharding as shd
from repro_torch.configs.base import ArchConfig
from repro_torch.core.aggregate import make_shardmap_sparse_aggregate
from repro_torch.core.compressors import transport_of
from repro_torch.core.fed import FedConfig, fed_init, make_fl_round
from repro_torch.launch.mesh import FSDP_ITEM_REMAINDER, MODEL_AXIS
from repro_torch.models import model as M
from repro_torch.models import params as PM
from repro_torch.models.tensor import FSDP, KVSplit, Serve2D
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
    """A train step: ``fn(state, batch) -> (state, metrics)``: one round
    on this rank;
    ``init(params, sharded=False)``: this rank's FedState from the whole
    params (``sharded``: from this rank's shards of them, e.g.
    ``models/params.materialize_shards``), with its client state (the
    spatial plans' ``(1, ...)``, the virtual plans' ``(n_virtual,
    ...)``); ``batch_shapes``: this rank's batch, leading ``(1,
    per_client)`` (spatial) or ``(n_virtual, global_batch / rows)``
    (virtual); ``static``: the configuration's bookkeeping, with the
    params' specs (``"pspecs"``) and the split loss (``"loss"``), which
    with ``"fed"`` build the same plan's buffered-async driver
    (``core/async_fed.make_async_round(fed, loss, ..., mesh=,
    pspecs=)``: the spatial plans' group cohort, the virtual plans'
    scan cohort).

    A prefill or serve step: ``fn`` as the module docstring says;
    ``init(params, sharded=False)``: this rank's parameter shards (as they
    are with ``sharded``); ``batch_shapes``: this rank's batch (prefill)
    or token (decode); ``new_caches(device=None)`` (decode): this rank's
    zeroed cache shards; ``static``: the params' and the caches' specs
    (``"pspecs"``, ``"cspecs"``) and ``loop_trips``.

    ``args(params, device)``: this rank's arguments of ``fn`` from its
    parameter shards ``params``: ``(state, batch)`` (train), ``(params,
    batch)`` (prefill) or ``(params, caches, pos, token)`` (decode, at
    the shape's last position); tokens drawn from PyTorch's global
    generator, a frontend's embeddings normal, caches zeroed.  Under a
    ``FakeTensorMode`` with ``models/params.abstract_shards``' params it
    is JAX's ``args_sds``: nothing is allocated (``launch/dryrun.py``).
    Every ``static`` holds ``kind``, ``fed`` and ``n_clients`` (``None``
    for serving), ``plan`` and ``loop_trips``."""
    fn: Callable
    init: Callable
    batch_shapes: Dict[str, tuple]
    static: Dict[str, Any]
    args: Callable
    new_caches: Optional[Callable] = None


def _batch(cfg: ArchConfig, shapes: Dict[str, tuple], device) -> dict:
    """A batch of ``shapes``: int32 tokens below the vocabulary, a
    frontend's ``embeds`` in the model's dtype."""
    out = {"tokens": torch.randint(0, cfg.vocab_size, shapes["tokens"],
                                   dtype=torch.int32, device=device)}
    if "embeds" in shapes:
        out["embeds"] = torch.randn(shapes["embeds"], device=device,
                                    dtype=PM.DTYPES[cfg.dtype])
    return out


def _front_len(cfg: ArchConfig, seq_len: int) -> int:
    """Stub-frontend token budget within the sequence."""
    if cfg.encoder is not None:
        return cfg.encoder.src_len
    if cfg.stub_frontend:
        return min(cfg.stub_frontend_tokens, max(seq_len // 2, 16))
    return 0


def skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.kind == "long" and not cfg.supports_long_decode():
        if cfg.encoder is not None:
            return ("decoder positional capacity is 448 tokens by family "
                    "design — 500k decode is not a meaningful configuration")
        return ("pure full-attention family without a shipped sliding-window "
                "variant — 500k decode skipped per docs/ARCHITECTURE.md §6")
    return None


def _loop_trips(cfg: ArchConfig, kind: str, *, local_epochs: int = 1,
                n_virtual: int = 1, chunk: int = 1024,
                kv_len: int = 0) -> tuple:
    """Static trip counts of the nested loops, outermost first (JAX's
    scan nesting, which its roofline uses to scale the collective bytes
    of loop bodies)."""
    maxgroup = max(c for _, c in M.pattern_groups(cfg))
    chunks = max(1, kv_len // chunk)
    if kind == "train":
        lead = ([n_virtual] if n_virtual > 1 else []) + [local_epochs]
        return tuple(lead + [cfg.pattern_repeats, maxgroup, chunks])
    if kind == "prefill":
        return (cfg.pattern_repeats, maxgroup, chunks)
    return (cfg.pattern_repeats, maxgroup)


def build_train_step(cfg: ArchConfig, mesh, shape: ShapeSpec, *,
                     algorithm: str = "fedadam_ssm", alpha: float = 0.05,
                     local_epochs: int = 2, remat: str = "full",
                     aggregate: Optional[str] = None,
                     plan: Optional[shd.DeployPlan] = None,
                     lr: float = 1e-3,
                     error_feedback: bool = False,
                     sparsify_backend: str = "auto",
                     participation: float = 1.0,
                     exact_topk: bool = False,
                     mask_scope: str = "per_tensor") -> StepBundle:
    """The train step of ``cfg`` at ``shape`` on ``mesh`` under ``plan``
    (``sharding.plan_for(cfg.name)`` by default).  Spatial/tp: as many
    clients as the client axes hold, ``shape.global_batch // clients``
    sequences each, each client's leaves split over the model axis.
    Virtual/fsdp (``mesh`` with no client axes): ``plan.n_virtual``
    clients of ``shape.global_batch`` sequences each, in turn on every
    rank, each rank holding ``global_batch / rows`` of them and its
    shard of every leaf.  ``algorithm``: any registered compressor, on
    either plan.  ``exact_topk``, ``mask_scope``: the masks (JAX's
    builder fixes the production ones, threshold and per tensor); other
    masks on a model axis take ``aggregate="dense"``: the per-shard
    bitmap transport keeps alpha of each shard, and would drop what an
    exact or a global mask selects in a shard beyond it."""
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
    if not virtual and aggregate is None:
        # keyed on the compressor's transport tag: any sparse scheme gets
        # the per-shard bitmap uplink
        aggregate = ("sparse_gather" if transport_of(algorithm) in
                     ("shared_sparse", "independent_sparse") else "dense")
    if not virtual and aggregate == "sparse_gather" and \
            mesh.model_size > 1 and (exact_topk or mask_scope != "per_tensor"):
        raise ValueError(
            f"exact_topk={exact_topk}, mask_scope={mask_scope!r} on a "
            f"model axis: the per-shard bitmap transport keeps alpha of "
            f"each shard; pass aggregate='dense'")
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
        batch_lead = (1, max(1, shape.global_batch // n_clients))
        fsdp = None
    fed = FedConfig(
        algorithm=algorithm, alpha=alpha, local_epochs=local_epochs,
        n_clients=n_clients, adam=AdamHyper(lr=lr),
        client_mode="scan" if virtual else "vmap", aggregate=aggregate,
        # production masks by default: the O(d) threshold selection,
        # which the backend sends through the kernels on the card
        exact_topk=exact_topk, mask_scope=mask_scope,
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
        args=lambda params, device: (init(params, sharded=True),
                                     _batch(cfg, batch_shapes, device)),
        static=dict(kind="train", n_clients=n_clients, plan=plan, fed=fed,
                    fsdp=fsdp, loss=loss,
                    text_len=text_len, n_front=n_front, remat=remat,
                    pspecs=pspec, loop_trips=_loop_trips(
                        cfg, "train", local_epochs=local_epochs,
                        n_virtual=n_clients if virtual else 1,
                        kv_len=shape.seq_len)))


# ---------------------------------------------------------------------------
# Prefill and serve (decode) steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Serving:
    """What both serving steps share on this rank: the plan, the params'
    specs, the model group, the 2-D context and the batch split."""
    plan: shd.DeployPlan
    pspec: Any
    tp: Any
    fsdp: Any
    rows: Any
    multi_pod: bool


def _serving(cfg: ArchConfig, mesh, plan, long_mode: bool) -> _Serving:
    plan = plan or shd.plan_for(cfg.name)
    if mesh.client_axes:
        raise ValueError(f"a serving mesh has no client axes, got "
                         f"{mesh.client_axes}")
    mesh.check()
    multi_pod = "pod" in mesh.shape
    pspec = PM.pspecs(M.abstract_params(cfg),
                      shd.param_rules(plan.serve_params, multi_pod), mesh)
    # the batch over the client axes' ranks, in their (pod, data) order;
    # the long shapes' one sequence whole on every rank
    rows = None if long_mode else mesh.axis_group(shd.client_axes(multi_pod))
    fsdp = None
    if plan.serve_params == "fsdp" and mesh.data is not None:
        fsdp = Serve2D(mesh.data, pspec, mesh.fsdp_axes, rows)
    return _Serving(plan, pspec, mesh.model, fsdp, rows, multi_pod)


def _local_batch(b: int, rows) -> int:
    n = 1 if rows is None else rows.size
    if b % n:
        raise ValueError(f"a batch of {b} on {n} rows")
    return b // n


def _init(sv: _Serving, mesh):
    def init(params, sharded: bool = False):
        """This rank's parameter shards (``params`` whole, or its shards
        already with ``sharded``)."""
        return params if sharded else PM.shard(params, sv.pspec, mesh)
    return init


def build_prefill_step(cfg: ArchConfig, mesh, shape: ShapeSpec, *,
                       plan: Optional[shd.DeployPlan] = None) -> StepBundle:
    """The prefill step of ``cfg`` at ``shape`` on a serving ``mesh``:
    ``fn(params, batch)`` with this rank's shards and its rows of the
    batch (``{"tokens": (b_loc, text_len)}``, a stub frontend's
    ``"embeds"``) returns (logits (b_loc, V), this rank's cache shards
    over the prompt, laid out by ``cache_rules("decode")``)."""
    sv = _serving(cfg, mesh, plan, False)
    n_front = _front_len(cfg, shape.seq_len)
    text_len = max(shape.seq_len - (n_front if cfg.encoder is None else 0),
                   32)
    b_loc = _local_batch(shape.global_batch, sv.rows)
    prompt = text_len + (n_front if cfg.encoder is None else 0)
    cspec = PM.pspecs(M.prefill_cache_meta(cfg, shape.global_batch, prompt),
                      shd.cache_rules("decode", sv.multi_pod), mesh)

    def prefill_step(params, batch):
        with torch.inference_mode():
            return M.prefill(cfg, params, batch["tokens"],
                             frontend_embeds=batch.get("embeds"), tp=sv.tp,
                             fsdp=sv.fsdp)

    batch_shapes = {"tokens": (b_loc, text_len)}
    if n_front:
        batch_shapes["embeds"] = (b_loc, n_front, cfg.d_model)
    return StepBundle(
        fn=prefill_step, init=_init(sv, mesh), batch_shapes=batch_shapes,
        args=lambda params, device: (params,
                                     _batch(cfg, batch_shapes, device)),
        static=dict(kind="prefill", plan=sv.plan, text_len=text_len,
                    fed=None, n_clients=None,
                    n_front=n_front, pspecs=sv.pspec, cspecs=cspec,
                    fsdp=sv.fsdp,
                    loop_trips=_loop_trips(cfg, "prefill",
                                           kv_len=shape.seq_len)))


def build_serve_step(cfg: ArchConfig, mesh, shape: ShapeSpec, *,
                     plan: Optional[shd.DeployPlan] = None,
                     cache_seq_shard=None) -> StepBundle:
    """The decode step of ``cfg`` at ``shape`` (``decode`` or ``long``)
    on a serving ``mesh``: ``fn(params, caches, pos, token)`` with this
    rank's shards, cache shards (``new_caches``) and its rows' tokens
    (``(b_loc,)``; the long shapes' whole batch) returns (logits (b_loc,
    V), caches), the caches written in place.  The cache leaves follow
    ``cache_rules``: with ``kv_seq`` split (the long shapes, or
    ``cache_seq_shard``) each rank attends over its slots and the
    softmax is combined over their group (``models.tensor.KVSplit``)."""
    long_mode = shape.kind == "long"
    sv = _serving(cfg, mesh, plan, long_mode)
    b = shape.global_batch
    cmeta = M.cache_meta(cfg, b, shape.seq_len, long_mode)
    crules = shd.cache_rules("long" if long_mode else "decode", sv.multi_pod,
                             cache_seq_shard=cache_seq_shard)
    cspec = PM.pspecs(cmeta, crules, mesh)
    kv = None
    if crules["kv_seq"] is not None:
        axes = crules["kv_seq"]
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        group = mesh.axis_group(axes)
        if group is not None:
            kv = KVSplit(group, MODEL_AXIS in axes)

    def serve_step(params, caches, pos, token):
        with torch.inference_mode():
            return M.decode_step(cfg, params, caches, int(pos), token,
                                 seq_len=shape.seq_len, long_mode=long_mode,
                                 tp=sv.tp, fsdp=sv.fsdp, kv=kv)

    def new_caches(device=None):
        """This rank's zeroed cache shards."""
        return PM.zeros_shards(cmeta, cspec, mesh, cfg.dtype,
                               mesh.device if device is None else device)

    batch_shapes = {"token": (_local_batch(b, sv.rows),)}
    return StepBundle(
        fn=serve_step, init=_init(sv, mesh), batch_shapes=batch_shapes,
        args=lambda params, device: (
            params, new_caches(device), shape.seq_len - 1,
            _batch(cfg, {"tokens": batch_shapes["token"]},
                   device)["tokens"]),
        new_caches=new_caches,
        static=dict(kind="long" if long_mode else "decode", plan=sv.plan,
                    fed=None, n_clients=None,
                    pspecs=sv.pspec, cspecs=cspec, kv=kv, fsdp=sv.fsdp,
                    loop_trips=_loop_trips(cfg, "decode")))


def build_step(cfg: ArchConfig, mesh, shape_name: str, *,
               shape: Optional[ShapeSpec] = None, **kw) -> StepBundle:
    """The step of ``SHAPES[shape_name]`` (or of ``shape``, a cut of it,
    given) by its kind: train, prefill, or decode and long (serve)."""
    shape = shape or SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, **kw)
    return build_serve_step(cfg, mesh, shape, **kw)
