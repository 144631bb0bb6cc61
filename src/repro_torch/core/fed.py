"""FedAdam-SSM and its baselines: Algorithms 1 and 2 of the paper.

Counterpart of ``repro/core/fed.py`` with the scan driver.  One round:

1. every client starts from the global (W, M, V);
2. the compressor's ``local_update``: L local Adam epochs (no bias
   correction) on the client's batch (the FedAdam family), L SGD epochs
   (FedSGD), one momentum step with V frozen (1-bit Adam), or L Adam
   epochs from the client's own persistent moments (Efficient-Adam);
3. the deltas dW, dM, dV (zeros where the algorithm sends nothing);
4. the round's compressor encodes them (FedAdam-SSM: one shared mask,
   Top_k(|dW|)), carrying any per-client error-feedback residual, and
   the server sees what its wire payload decodes to;
5. FedAvg over the decoded deltas in client order, then the compressor's
   ``server_update`` rule advances the globals.

The JAX ``lax.scan`` over clients is a Python loop here, and per-client
state is stacked ``(C, ...)`` tensors.  Parameters are trees of tensors
(dicts, flattened in sorted key order); ``loss_fn(params, batch)``
returns a scalar tensor and gradients come from ``torch.autograd``.

Client execution modes, as in the JAX package:

* ``scan``: the clients one after another, each folded into the running
  FedAvg sums as it finishes (memory: one client).
* ``vmap``: every client's output stacked ``(C, ...)``, then the
  ``aggregate`` transport of :mod:`repro_torch.core.aggregate` folds the
  stack: ``dense`` (a weighted sum over the client axis) or
  ``sparse_gather`` (the clients' wire payloads, or a COO pack where the
  compressor has no wire realization).
* ``vmap`` with ``client_axes`` (the multi-GPU spatial round, JAX's
  ``round_shardmap``): one client per ``torch.distributed`` rank of a
  :class:`~repro_torch.launch.mesh.ClientMesh`, each against the same
  replicated (W, M, V); the injected transport
  (``aggregate.make_shardmap_sparse_aggregate``) or, without one, the
  dense carriers all-gathered and folded in client order.  A rank holds
  its own client's batch and client state, stacked ``(1, ...)``
  (:func:`local_clients`, :func:`gather_client_state`).  On a mesh with a
  model axis above 1 (the ``tp`` plans) a client's ranks each hold their
  shard of every leaf (``pspecs``: W, M, V, the EF residual and the
  ``local_adam`` moments alike, :func:`client_state_pspecs`), the loss
  runs its tensor-parallel layers, the masks keep each whole leaf's
  threshold (``sparsify.LeafSplit``), the transport packs each shard,
  and the bill counts the whole leaves.
* ``scan`` on a mesh with no client axes (the virtual clients of the
  ``fsdp`` plans, JAX's ``plan.clients == "virtual"``): every client one
  after another on the whole mesh, each rank holding its shard of every
  leaf (split over "model" and, along ``embed``, over the data[, pod]
  axes) and its slice of each client's batch (:func:`local_batch`); the
  loss gathers each leaf over the data group at its use, the masks keep
  each whole leaf's threshold over the group that holds its shards, the
  dense FedAvg folds each shard, and the bill and the metrics are the
  whole leaves', the same on every rank.

Partial participation draws the round's clients as the JAX round does,
``jax.random.permutation(fold_in(PRNGKey(17), round), C)`` (reproduced
in numpy by :mod:`repro_torch.core._threefry`; the same draw on every
rank), and masks the FedAvg weights of the others.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import _threefry, aggregate, compressors, wire
from repro_torch.core.compressors import Deltas
from repro_torch.core.compressors.base import tree_add as _tree_add
from repro_torch.core.compressors.base import tree_sub as _tree_sub
from repro_torch.optim.adam import (AdamHyper, AdamState, sqrt_rn,
                                    adam_step, sgd_step)

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class FedConfig:
    algorithm: str = "fedadam_ssm"
    alpha: float = 0.05                   # sparsification ratio k/d
    local_epochs: int = 30
    n_clients: int = 20
    adam: AdamHyper = AdamHyper()
    mask_scope: str = "per_tensor"        # per_tensor | global
    exact_topk: bool = True               # exact sort vs threshold selection
    # auto | kernel | reference (core/sparsify.resolve_backend: auto sends
    # CUDA tensors to the kernels; REPRO_TORCH_SPARSIFY_BACKEND overrides)
    sparsify_backend: str = "auto"
    error_feedback: bool = False
    quant_bits: int = 8                   # efficient_adam
    q_bits: int = 32                      # accounting float precision
    client_mode: str = "scan"             # scan | vmap
    aggregate: str = "dense"              # dense | sparse_gather (vmap only)
    client_axes: Optional[Tuple[str, ...]] = None  # the group's client axes
    use_kernel_adam: bool = False         # fused_adam kernel per leaf
    value_dtype: Optional[str] = None     # None | bfloat16 | float16
    # fraction of clients sampled per round, by masking FedAvg weights
    participation: float = 1.0

    def __post_init__(self):
        compressors.check_algorithm(self.algorithm)


def active_client_count(fed: FedConfig) -> int:
    """Clients sampled per round: ``round(participation * n_clients)``,
    never below one (Python's banker's rounding, as in the JAX package)."""
    return max(1, int(round(fed.participation * fed.n_clients)))


class FedState(NamedTuple):
    W: Any                                # global model
    M: Any                                # global first moments
    V: Any                                # global second moments
    round: int
    client_state: Any                     # per-client (C, ...) state or None:
    #   {"comp": EF state, "m"/"v": persistent local moments (local_adam)}


def fed_init(fed: FedConfig, params) -> FedState:
    comp = compressors.make_compressor(fed)
    C = fed.n_clients
    parts = {}
    cs1 = comp.init_state(params)
    if cs1 is not None:
        parts["comp"] = T.tree_map(lambda x: torch.stack([x] * C), cs1)
    if comp.local_update == "local_adam":
        # persistent local Adam moments (Efficient-Adam: never aggregated)
        stack0 = lambda: T.tree_map(lambda x: torch.zeros(
            (C,) + tuple(x.shape), dtype=x.dtype, device=x.device), params)
        parts["m"], parts["v"] = stack0(), stack0()
    zeros = lambda: T.tree_map(torch.zeros_like, params)
    return FedState(W=params, M=zeros(), V=zeros(), round=0,
                    client_state=parts or None)


#: The registered algorithm names, in registration order (JAX's
#: ``fed.ALGORITHMS``).
ALGORITHMS = compressors.available()


def client_state_pspecs(client_state, param_pspecs, client_axes):
    """The :class:`~repro_torch.models.params.Spec` tree of a
    client-stacked ``client_state`` (JAX's ``client_state_pspecs``): each
    leaf's leading client axis on ``client_axes`` (``None``: the scan
    driver's virtual clients), and its trailing dims as the params' where
    a sub-tree has the params' structure (the EF residual
    ``{"comp": {"err": ...}}``, the ``local_adam`` moments ``"m"``/``"v"``),
    so a client's residual shard lies like its param shard; any other
    sub-tree is split on the client axis alone."""
    from repro_torch.models.params import Spec
    if client_state is None:
        return None
    cax = (tuple(client_axes) if len(client_axes) > 1 else client_axes[0]) \
        if client_axes else None
    pleaves, ptd = T.flatten(param_pspecs)

    def spec_for(sub):
        if T.flatten(sub)[1] == ptd:
            return ptd.unflatten([Spec((cax,) + tuple(sp)) for sp in pleaves])
        if isinstance(sub, dict):
            return {k: spec_for(v) for k, v in sub.items()}
        return T.tree_map(lambda x: Spec((cax,) + (None,) * (x.dim() - 1)),
                          sub)

    return spec_for(client_state)


def spatial(fed: FedConfig) -> bool:
    """Whether ``fed`` runs the multi-GPU spatial round (JAX's
    ``round_fn`` dispatch: a client mode other than scan, with client
    axes)."""
    return fed.client_mode != "scan" and fed.client_axes is not None


def check_ported(fed: FedConfig, mesh=None) -> None:
    """Raise for a configuration the port cannot run: an unknown client
    mode; a mesh that ``ClientMesh.check`` refuses (an axis beyond the
    client axes, "model" and a virtual mesh's FSDP axes: ROADMAP
    §1.10(b)'s remainder); for the spatial round, a missing or
    mismatched client group."""
    if fed.client_mode not in ("scan", "vmap"):
        raise ValueError(f"client_mode={fed.client_mode!r}: scan | vmap")
    if not spatial(fed):
        if mesh is not None:
            mesh.check()
        return
    if mesh is None:
        raise ValueError(f"client_axes={fed.client_axes!r}: the spatial "
                         "round needs the client group (mesh=)")
    mesh.check()
    if tuple(fed.client_axes) != tuple(mesh.client_axes):
        raise ValueError(f"client_axes={fed.client_axes!r} are not the "
                         f"mesh's {mesh.client_axes}")
    if fed.n_clients != mesh.n_clients:
        raise ValueError(f"{fed.n_clients} clients on a mesh of "
                         f"{mesh.n_clients}: one client per rank (per "
                         "model group on a model axis)")


def _leaf_split(fed: FedConfig, comp, mesh, pspecs):
    """The round's ``sparsify.LeafSplit`` on a model axis above 1 or FSDP
    axes (else ``None``), after checking that the configuration runs
    there: the spatial round on a model axis, the scan round on FSDP
    axes, a threshold-mask sparse compressor."""
    from repro_torch.core import sparsify as S
    from repro_torch.launch.mesh import FSDP_ITEM_REMAINDER, TENSOR_ITEM
    from repro_torch.models.params import split_kinds
    if mesh is None:
        return None
    fsdp = mesh.data is not None
    if mesh.model is None and not fsdp:
        return None
    if fsdp and fed.client_mode != "scan":
        raise ValueError("leaves split over the FSDP axes need the scan "
                         "round of the virtual clients (client_mode='scan')")
    if not fsdp and not spatial(fed):
        raise ValueError("a model axis above 1 needs the spatial round "
                         "(client_mode='vmap' with client_axes)")
    if pspecs is None:
        raise ValueError("split leaves need the param specs (pspecs=)")
    if comp.transport not in ("shared_sparse", "independent_sparse") \
            or getattr(comp, "rule", "ssm_w") == "fairness_top" \
            or fed.exact_topk:
        raise NotImplementedError(
            f"{comp.name}{' with exact masks' if fed.exact_topk else ''} "
            "on split leaves (its scales, norms or sorts over a whole "
            "leaf) is not ported: "
            f"{FSDP_ITEM_REMAINDER if fsdp else TENSOR_ITEM}")
    groups = {None: None, "model": mesh.model, "data": mesh.data,
              "both": mesh.leaf}
    return S.LeafSplit(tuple(groups[k] for k in split_kinds(pspecs, mesh)))


def local_clients(tree, mesh):
    """This rank's slice ``(1, ...)`` of a client-stacked ``(C, ...)``
    tree (a batch, a client state): its client's, the counterpart of JAX
    placing the client axis on the mesh (every model rank of a client
    takes the same slice)."""
    if tree is None:
        return None
    r = mesh.client_index
    return T.tree_map(lambda x: x[r:r + 1].clone(), tree)


def local_batch(tree, mesh):
    """This rank's slice of a virtual-client batch ``(C, global_batch,
    ...)``: ``(C, global_batch / rows, ...)`` along dim 1, its row of the
    mesh's (data[, pod]) rows in row-major order, the layout of JAX's
    ``P(None, client_axes, None)`` (every model rank of a row takes the
    same slice)."""
    if tree is None:
        return None
    rows = mesh.world_size // mesh.model_size

    def one(x):
        if x.shape[1] % rows:
            raise ValueError(f"a batch of {x.shape[1]} sequences on "
                             f"{rows} rows")
        n = x.shape[1] // rows
        return x[:, mesh.client_index * n:(mesh.client_index + 1) * n] \
            .clone()

    return T.tree_map(one, tree)


def gather_client_state(state: FedState, mesh) -> FedState:
    """``state`` with every rank's ``(1, ...)`` client state all-gathered
    into the ``(C, ...)`` stack of the scan round (for tests and
    checkpoints); every rank must call it."""
    if state.client_state is None:
        return state
    return state._replace(client_state=T.tree_map(
        lambda x: mesh.all_gather(x[0]), state.client_state))


# ---------------------------------------------------------------------------
# Local training
# ---------------------------------------------------------------------------


def _value_and_grad(loss_fn, params, batch):
    leaves, td = T.flatten(params)
    req = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        loss = loss_fn(td.unflatten(req), batch)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return loss.detach(), td.unflatten(grads)


def _local_adam(loss_fn, W, M, V, batch, fed: FedConfig):
    """L local Adam epochs from the downloaded global state."""
    w, st = W, AdamState(M, V, 0)
    losses = []
    for _ in range(fed.local_epochs):
        loss, g = _value_and_grad(loss_fn, w, batch)
        w, st = adam_step(w, g, st, fed.adam, use_kernel=fed.use_kernel_adam)
        losses.append(loss)
    return w, st.m, st.v, torch.stack(losses).mean()


def _local_sgd(loss_fn, W, batch, fed: FedConfig):
    w, losses = W, []
    for _ in range(fed.local_epochs):
        loss, g = _value_and_grad(loss_fn, w, batch)
        w = sgd_step(w, g, fed.adam.lr)
        losses.append(loss)
    return w, torch.stack(losses).mean()


def _local_momentum(loss_fn, W, M, batch, fed: FedConfig):
    """One momentum step (1-bit Adam's compressed phase: V frozen)."""
    loss, g = _value_and_grad(loss_fn, W, batch)
    h = fed.adam
    m_new = T.tree_map(
        lambda m, gg: (h.beta1 * m.to(_F32)
                       + (1 - h.beta1) * gg.to(_F32)).to(m.dtype), M, g)
    return m_new, loss


def _local_deltas(local_update: str, loss_fn, W, M, V, batch, cstate,
                  fed: FedConfig):
    """``(deltas, loss, extras)`` of one client's local update;
    ``extras`` is the client state it writes back (Efficient-Adam's
    moments)."""
    if local_update == "sgd":
        w, loss = _local_sgd(loss_fn, W, batch, fed)
        dW = _tree_sub(w, W)
        z = T.tree_map(torch.zeros_like, dW)
        return Deltas(dW, z, z), loss, {}
    if local_update == "momentum":
        m, loss = _local_momentum(loss_fn, W, M, batch, fed)
        dM = _tree_sub(m, M)
        z = T.tree_map(torch.zeros_like, dM)
        return Deltas(z, dM, z), loss, {}
    if local_update == "local_adam":
        # the client's own moments, never aggregated (the staleness the
        # paper criticizes)
        w, m, v, loss = _local_adam(loss_fn, W, cstate["m"], cstate["v"],
                                    batch, fed)
        dW = _tree_sub(w, W)
        z = T.tree_map(torch.zeros_like, dW)
        return Deltas(dW, z, z), loss, {"m": m, "v": v}
    # "adam": the FedAdam family
    w, m, v, loss = _local_adam(loss_fn, W, M, V, batch, fed)
    return Deltas(_tree_sub(w, W), _tree_sub(m, M), _tree_sub(v, V)), \
        loss, {}


# ---------------------------------------------------------------------------
# The round
# ---------------------------------------------------------------------------


def make_client_step(fed: FedConfig, loss_fn: Callable,
                     comp: Optional[compressors.Compressor] = None,
                     *, emit: str = "dense", wire_roundtrip: bool = True):
    """ONE client's round: local epochs + compression.

    ``client_step(W, M, V, batch, cstate) -> (sW, sM, sV, new_cstate,
    metrics)``; the carriers are the ones the wire payload decodes to
    (dense transport skips the round trip, as in the JAX round: decoding
    is the identity, and FedSGD's payload holds W alone).  ``emit="wire"``
    (the vmap sparse-gather transport) returns ``(payload, new_cstate,
    metrics)``: the client's :class:`~repro_torch.core.wire.WirePayload`
    is its output, and the server decodes it.

    ``wire_roundtrip=False`` (the spatial round's step) returns the
    encoder's carriers and builds no payload at all: its transport is the
    per-shard bitmap of ``aggregate.make_shardmap_sparse_aggregate``.  The
    round trip being bitwise, the numbers are the same; the JAX package's
    jit drops the unused pack as dead code, the port never launches it."""
    if comp is None:
        comp = compressors.make_compressor(fed)
    if emit not in ("dense", "wire"):
        raise ValueError(f"emit={emit!r}")

    def client_step(W, M, V, batch, cstate):
        comp_state = cstate.get("comp") if cstate is not None else None
        # the local state lives only inside _local_deltas: the deltas carry
        # it from there, which keeps a model's worth of trees out of the
        # compress's peak memory
        deltas, loss, extras = _local_deltas(comp.local_update, loss_fn,
                                             W, M, V, batch, cstate, fed)
        packed, new_comp_state, _bits = comp.compress(
            deltas, comp_state, emit_wire=wire_roundtrip or emit == "wire")
        new_cstate = None
        if cstate is not None:
            new_cstate = dict(cstate)
            if "comp" in cstate:
                new_cstate["comp"] = new_comp_state
            new_cstate.update(extras)
        mets = dict(packed.diag, loss=loss)
        if emit == "wire":
            if packed.wire is None:
                raise ValueError(f"{comp.name}: emit='wire' but compress "
                                 "built no payload")
            return packed.wire, new_cstate, mets
        if wire_roundtrip and packed.wire is not None \
                and comp.transport != "dense":
            sW, sM, sV = comp.unpack_wire(packed.wire, deltas.W)
        else:
            sW, sM, sV = comp.decompress(packed)
        return sW, sM, sV, new_cstate, mets

    return client_step


def make_server_apply(fed: FedConfig,
                      comp: Optional[compressors.Compressor] = None):
    """The server tail of a round: FedAvg mean + the compressor's
    ``server_update`` rule.  ``server_apply(W, M, V, aW, aM, aV, wsum)``
    takes weighted SUMS and their weight total."""
    if comp is None:
        comp = compressors.make_compressor(fed)
    h = fed.adam

    def server_apply(W, M, V, aW, aM, aV, wsum):
        mean = lambda t: T.tree_map(lambda x: x / wsum, t)
        aW, aM, aV = mean(aW), mean(aM), mean(aV)
        if comp.server_update == "precond_m":
            # 1-bit Adam: M advances by the aggregated momentum delta, W by
            # the step preconditioned with the frozen V (the root correctly
            # rounded, as XLA's; the warm-up rounds are a dense FedAdam
            # FedConfig of their own)
            M_new = _tree_add(M, aM)
            W_new = T.tree_map(
                lambda w, mm, vv: (w.to(_F32) - h.lr * mm.to(_F32)
                                   / sqrt_rn(vv.to(_F32) + h.eps)
                                   ).to(w.dtype), W, M_new, V)
            return W_new, M_new, V
        if comp.server_update == "w_only":
            return _tree_add(W, aW), M, V
        return _tree_add(W, aW), _tree_add(M, aM), _tree_add(V, aV)

    return server_apply


class _Stack:
    """Client outputs stacked ``(C, ...)`` as they arrive: the first
    client's tree allocates the stack, every client's is copied into its
    slot, so a round holds the stack and one client's output, never a
    list of all of them beside the stack."""

    def __init__(self, n: int):
        self.n, self.leaves, self.treedef = n, None, None

    def put(self, c: int, tree) -> None:
        leaves, td = T.flatten(tree)
        if self.leaves is None:
            self.treedef = td
            self.leaves = [torch.empty((self.n,) + tuple(x.shape),
                                       dtype=x.dtype, device=x.device)
                           for x in leaves]
        for buf, x in zip(self.leaves, leaves):
            buf[c].copy_(x)

    def tree(self):
        return self.treedef.unflatten(self.leaves)


def stack_payloads(payloads) -> wire.WirePayload:
    """Client payloads of one layout as one ``WirePayload`` of ``(C,
    ...)`` tensors."""
    return wire.WirePayload(*(
        tuple(torch.stack(xs) for xs in zip(*parts))
        for parts in zip(*payloads)))


def run_clients_stacked(step, W, M, V, batches, cs, n: int):
    """Clients ``0 .. n-1`` one after another through ``step(W, M, V,
    batch, cstate)`` (client ``c`` on slice ``c`` of ``batches`` and of
    the stacked client state ``cs``), each output of the tuple it returns
    stacked ``(n, ...)`` slot by slot as it arrives (:class:`_Stack`; an
    output that is ``None`` stays ``None``)."""
    stacks = None
    for c in range(n):
        batch = T.tree_map(lambda x: x[c], batches)
        cstate = None if cs is None else T.tree_map(lambda x: x[c], cs)
        out = step(W, M, V, batch, cstate)
        if stacks is None:
            stacks = [None if o is None else _Stack(n) for o in out]
        for s, o in zip(stacks, out):
            if s is not None:
                s.put(c, o)
        del out
    return tuple(None if s is None else s.tree() for s in stacks)


def participation_weights(fed: FedConfig, weights: torch.Tensor,
                          round_: int, rng=None) -> torch.Tensor:
    """``weights`` with every client outside the round's draw set to 0.0:
    the first ``active_client_count`` of ``permutation(fold_in(
    PRNGKey(17), round), C)``, or of ``permutation(rng, C)`` for an
    explicit uint32 key pair, exactly the JAX round's clients."""
    key = None if rng is None else np.asarray(
        rng.cpu() if isinstance(rng, torch.Tensor) else rng, np.uint32)
    perm = _threefry.client_permutation(int(round_), fed.n_clients, key)
    active = np.zeros(fed.n_clients, np.float32)
    active[perm[:active_client_count(fed)]] = 1.0
    host = torch.from_numpy(active)
    if weights.is_cuda:
        # pinned and asynchronous: the copy does not stall the stream
        host = host.pin_memory()
    return weights * host.to(weights.device, non_blocking=True)


def make_fl_round(fed: FedConfig, loss_fn: Callable,
                  sparse_aggregate_fn: Optional[Callable] = None, *,
                  mesh=None, pspecs=None):
    """Build ``round_fn(state, batches, weights=None, rng=None) -> (state,
    metrics)``.

    ``batches``: a tree whose leaves have leading dims (C, [L,] ...), on
    the device of the parameters.  ``weights``: optional (C,) FedAvg
    weights |D_n| (uniform by default).  ``rng``: with ``participation <
    1``, an optional uint32 key pair for the client draw (by default the
    round counter's).

    The spatial round (``client_axes`` with ``client_mode="vmap"``) runs
    on every rank of ``mesh`` (a
    :class:`~repro_torch.launch.mesh.ClientMesh`): ``batches`` and the
    state's client state are this rank's ``(1, ...)`` slices, ``weights``
    every client's, and the metrics come back gathered ``(C,)``.
    ``sparse_aggregate_fn(sW_c, sM_c, sV_c, weights[, comp_err])``: the
    injected transport (``aggregate.make_shardmap_sparse_aggregate``),
    taken with ``aggregate="sparse_gather"``.

    On a mesh with a model axis above 1, ``pspecs`` (the params'
    :class:`~repro_torch.models.params.Spec` tree) says which leaves are
    split: the state's leaves are this rank's shards, ``loss_fn`` runs
    the split layers, and the metrics are the same on every model rank.
    The scan round on a mesh with FSDP axes (no client axes) likewise:
    ``batches`` is then this rank's :func:`local_batch`, and ``loss_fn``
    returns the whole batch's loss on every rank."""
    check_ported(fed, mesh)
    comp = compressors.make_compressor(fed)
    split = _leaf_split(fed, comp, mesh, pspecs)
    if split is not None:
        comp = dataclasses.replace(comp, split=split)
    n_active = active_client_count(fed)
    # on split leaves a payload would pack each shard with a shard's
    # capacity, not the whole leaf's: the scan round's clients hand over
    # the encoder's carriers instead (the round trip is bitwise where no
    # capacity drops a value), as the spatial step does
    client_step = make_client_step(fed, loss_fn, comp,
                                   wire_roundtrip=split is None)
    # the spatial step skips the (bitwise) wire round trip and builds no
    # payload: its transport is the per-shard bitmap aggregate
    mesh_client_step = make_client_step(fed, loss_fn, comp,
                                        wire_roundtrip=False)
    server_apply = make_server_apply(fed, comp)

    def stack(items):
        return T.tree_map(lambda *xs: torch.stack(xs), *items)

    def round_scan(state: FedState, batches, weights):
        W, M, V = state.W, state.M, state.V
        w = weights.to(_F32)
        cs = state.client_state
        acc, new_cs, mets = None, [], []
        for c in range(fed.n_clients):
            batch = T.tree_map(lambda x: x[c], batches)
            cstate = None if cs is None else T.tree_map(lambda x: x[c], cs)
            sW, sM, sV, ncs, m = client_step(W, M, V, batch, cstate)
            acc = aggregate.weighted_fold(acc, w[c], (sW, sM, sV))
            new_cs.append(ncs)
            mets.append(m)
        return acc, aggregate.weight_total(w), \
            (None if cs is None else stack(new_cs)), stack(mets)

    def round_vmap(state: FedState, batches, weights):
        """Every client's output stacked ``(C, ...)``, then the
        ``aggregate`` transport.  JAX batches the clients with
        ``jax.vmap``; ``torch.func.vmap`` cannot batch
        ``torch.autograd.grad`` through the kernels' ctypes bindings, so
        the clients run one after another here and each client's
        numbers are bitwise the scan driver's (the same launches per
        client too).  Only the aggregation differs: the wire transport
        decodes and folds in client order (bitwise ``round_scan``), the
        dense one is a weighted sum over the stack, and the COO pack
        scatter-adds."""
        W, M, V = state.W, state.M, state.V
        wsum = torch.sum(weights.to(_F32))
        sizes = tuple(x.numel() for x in T.leaves(W))
        if (fed.aggregate == "sparse_gather" and comp.transport != "dense"
                and comp.wire_bits_per_client(sizes) is not None):
            emit_wire = make_client_step(fed, loss_fn, comp, emit="wire")

            def wire_step(*args):
                payload, ncs, m = emit_wire(*args)
                # the payload's parts as a tree: three tuples of tensors
                return tuple(payload), ncs, m

            payload, new_cs, mets = run_clients_stacked(
                wire_step, W, M, V, batches, state.client_state,
                fed.n_clients)
            aW, aM, aV = aggregate.packed_gather_sum(
                comp, None, None, None, weights, alpha=fed.alpha,
                value_dtype=fed.value_dtype, sort_free=not fed.exact_topk,
                payload_c=wire.WirePayload(*payload), like=W)
            return (aW, aM, aV), wsum, new_cs, mets
        sW, sM, sV, new_cs, mets = run_clients_stacked(
            client_step, W, M, V, batches, state.client_state, fed.n_clients)
        if fed.aggregate == "sparse_gather":
            aW, aM, aV = aggregate.packed_gather_sum(
                comp, sW, sM, sV, weights, alpha=fed.alpha,
                value_dtype=fed.value_dtype, sort_free=not fed.exact_topk)
        else:
            aW, aM, aV = (aggregate.dense_weighted_sum(t, weights)
                          for t in (sW, sM, sV))
        return (aW, aM, aV), wsum, new_cs, mets

    def round_shardmap(state: FedState, batches, weights):
        """The spatial round on this rank: its client's step against the
        replicated (W, M, V) and its ``(1, ...)`` client state, then the
        injected transport (with the error-feedback residual handed over,
        so that what the pack's capacity drops feeds back) or the dense
        carriers all-gathered and folded in client order (C times the
        parameters in memory, as in JAX's global view; bitwise the scan
        round's fold).  The metrics are all-gathered into ``(C,)``."""
        W, M, V = state.W, state.M, state.V

        def one(tree):
            if tree is None:
                return None
            for x in T.leaves(tree):
                if x.shape[0] != 1:
                    raise ValueError("the spatial round takes this rank's "
                                     f"(1, ...) slice, got {tuple(x.shape)}")
            return T.tree_map(lambda x: x[0], tree)

        lead = lambda t: None if t is None else T.tree_map(
            lambda x: x[None], t)
        sW, sM, sV, ncs, m = mesh_client_step(
            W, M, V, one(batches), one(state.client_state))
        new_cs = lead(ncs)
        mets = {k: mesh.all_gather(v) for k, v in m.items()}
        wsum = torch.sum(weights.to(_F32))
        if fed.aggregate == "sparse_gather" \
                and sparse_aggregate_fn is not None:
            carriers = (lead(sW), lead(sM), lead(sV), weights)
            comp_err = new_cs["comp"].get("err") if new_cs is not None \
                and isinstance(new_cs.get("comp"), dict) else None
            if comp_err is not None and comp.transport in (
                    "shared_sparse", "independent_sparse"):
                (aW, aM, aV), new_err = sparse_aggregate_fn(*carriers,
                                                            comp_err)
                new_cs = dict(new_cs, comp=dict(new_cs["comp"],
                                                err=new_err))
            else:
                aW, aM, aV = sparse_aggregate_fn(*carriers)
        else:
            aW, aM, aV = (aggregate.ordered_weighted_sum(
                T.tree_map(mesh.all_gather, t), weights)
                for t in (sW, sM, sV))
        return (aW, aM, aV), wsum, new_cs, mets

    if fed.client_mode == "scan":
        driver = round_scan
    elif spatial(fed):
        driver = round_shardmap
    else:
        driver = round_vmap

    def round_fn(state: FedState, batches, weights=None, rng=None):
        device = T.leaves(state.W)[0].device
        if weights is None:
            weights = torch.ones((fed.n_clients,), dtype=_F32, device=device)
        if fed.participation < 1.0:
            # inactive clients still run (static work, as in the JAX
            # round): their weight is 0.0 and their client state advances
            weights = participation_weights(fed, weights, state.round, rng)
        (aW, aM, aV), wsum, new_cs, mets = driver(state, batches, weights)
        W_new, M_new, V_new = server_apply(state.W, state.M, state.V,
                                           aW, aM, aV, wsum)
        # uplink accounting: the measured wire bytes when the compressor
        # ships a payload, else the paper-analytic count, times the
        # participating clients; of the whole leaves on a split mesh
        sizes = tuple(x.numel() for x in T.leaves(state.W)) \
            if split is None else split.sizes(state.W)
        per_client = comp.wire_bits_per_client(sizes)
        if per_client is None:
            per_client = comp.bits_per_client(sum(sizes))
        mets = dict(mets)
        mets["uplink_bits"] = torch.full((), float(n_active * per_client),
                                         dtype=_F32, device=device)
        return FedState(W=W_new, M=M_new, V=V_new,
                        round=int(state.round) + 1,
                        client_state=new_cs), mets

    return round_fn
