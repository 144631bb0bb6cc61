"""What each rank runs in tests/test_torch_async_split.py: the port's
buffered-async driver on split leaves, on a (data 2, model 2) gloo group
of CPU processes (``launch.mesh.run_ranks``), through both views of the
one group that ``chip_smoke.p20_run`` takes: the ``tp`` plan's spatial
view (client axis "data": the group cohort, each rank on its model
shards) and the ``fsdp`` plan's virtual view (no client axes: the scan
cohort, each rank on its FSDP+tp shards and its slice of each client's
batch).  It imports no jax, so that a spawned rank starts quickly; it
returns numpy arrays and numbers.

Cases, all in one spawn (:func:`on_group`):

* ``churn``: the driver under seeded churn for each view and algorithm of
  :data:`ALGORITHMS`, from the params and batches JAX's whole-leaf driver
  takes: the event log, the counts, the bill, the losses, the whole
  state, and each dispatch's supports per stream (whole, on rank 0);
* ``degenerate``: zero churn with K = C, 2 server steps, against 2 split
  synchronous rounds of ``build_train_step`` (the tp plan's dense fold,
  the virtual plan's scan round), and round 2 by the async driver from
  round 1's synchronous state (the checkpoint handoff): whether each is
  bit for bit the synchronous rounds' state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MESH = {"data": 2, "model": 2}
WORLD = 4
MODEL = "starcoder2-3b"
#: The clients (the spatial view's client axis, the virtual plan's
#: ``n_virtual``), sequences a client and their length: both views'
#: clients train on the same (C, PER_CLIENT, SEQ) tokens (a virtual
#: client's 2 sequences split one a row), so one JAX run is both
#: views' reference.
C = 2
PER_CLIENT = 2
SEQ = 32
ALPHA = 0.05
LR = 1e-3
LOCAL_EPOCHS = 1
#: Server steps under churn, the buffer policy, and a churn seed whose
#: schedule has a drop, a staleness of 2, a group of 2 and groups of 1
#: (padded to 2 lanes on the client group): 8 dispatches, 6 landed.
STEPS = 3
ASYNC = dict(buffer_size=2, max_staleness=2)
CHURN = dict(seed=3, jitter=3, straggler_prob=0.3, drop_prob=0.2)
#: view -> the algorithms its driver runs under churn (FedAdam-SSM and
#: FedAdam-Top with error feedback; Efficient-Adam's persistent moments
#: are client state too).
ALGORITHMS = {"tp": ("fedadam_ssm", "fedadam_top", "efficient_adam"),
              "fsdp": ("fedadam_ssm", "efficient_adam")}
#: The algorithms of JAX's reference runs (one run serves both views).
JAX_ALGORITHMS = ("fedadam_ssm", "fedadam_top", "efficient_adam")


def smoke_cfg():
    """The smoke starcoder2-3b with its full config's GELU MLP, float32."""
    from repro_torch.configs import get_config, reduce_for_smoke
    cfg = reduce_for_smoke(get_config(MODEL))
    return dataclasses.replace(cfg, dtype="float32", layer_pattern=tuple(
        dataclasses.replace(s, gated_mlp=False) for s in cfg.layer_pattern))


def batch_tokens(cfg, seed: int = 1):
    """(C, PER_CLIENT, SEQ) int32 tokens."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (C, PER_CLIENT, SEQ)) \
        .astype(np.int32)


def _np(tree):
    from repro_torch import tree as T
    return [x.detach().cpu().numpy() for x in T.leaves(tree)]


def views(mesh) -> dict:
    """The group's two views: the spatial (client axis "data") and the
    virtual (no client axes: the client group is the data group)."""
    return {"tp": dataclasses.replace(mesh, client_axes=("data",)),
            "fsdp": dataclasses.replace(mesh, client_axes=())}


def bundle(view, mesh, algorithm, **kw):
    """``build_train_step`` of the view's plan (``kw``: more of its
    keywords): the tp plan's C clients of PER_CLIENT sequences, or C
    virtual clients of PER_CLIENT sequences each."""
    from repro_torch.launch import steps
    from repro_torch.sharding import DeployPlan
    virtual = view == "fsdp"
    shape = dataclasses.replace(
        steps.SHAPES["train_4k"], seq_len=SEQ,
        global_batch=PER_CLIENT * (1 if virtual else C))
    if virtual:
        kw["plan"] = DeployPlan(clients="virtual", train_params="fsdp",
                                n_virtual=C)
    return steps.build_train_step(smoke_cfg(), mesh, shape,
                                  algorithm=algorithm,
                                  local_epochs=LOCAL_EPOCHS, alpha=ALPHA,
                                  lr=LR, error_feedback=True, **kw)


def driver(view, mesh, b, churn_kw, acfg_kw):
    """The plan's buffered-async driver from its bundle: the group cohort
    on the spatial view, the scan cohort on the virtual one."""
    from repro_torch.core import AsyncConfig, make_async_round
    from repro_torch.data import ChurnConfig, ChurnModel
    return make_async_round(
        b.static["fed"], b.static["loss"], AsyncConfig(**acfg_kw),
        churn=ChurnModel(ChurnConfig(**churn_kw), C),
        client_exec="shardmap" if view == "tp" else "scan", mesh=mesh,
        pspecs=b.static["pspecs"])


def async_batches(view, mesh, tokens):
    """Every client's batch (spatial), or this rank's slice of each
    (virtual: ``fed.local_batch``)."""
    from repro_torch.core.fed import local_batch
    t = {"tokens": torch.from_numpy(tokens)}
    return t if view == "tp" else local_batch(t, mesh)


def sync_batch(view, mesh, tokens):
    """This rank's batch of the synchronous step."""
    from repro_torch.core.fed import local_batch, local_clients
    t = {"tokens": torch.from_numpy(tokens)}
    return local_clients(t, mesh) if view == "tp" else local_batch(t, mesh)


def async_state(b, params, mesh):
    """The driver's initial state: this rank's shards and every client's
    state ``(C, ...)``."""
    from repro_torch.core import fed_init
    from repro_torch.models import params as PM
    return fed_init(b.static["fed"], PM.shard(params, b.static["pspecs"],
                                              mesh))


def whole_state(state, specs, mesh) -> dict:
    """W, M, V whole and every client's state whole ``(C, ...)``: the EF
    residual ``err`` and Efficient-Adam's moments ``m``, ``v``."""
    from repro_torch.core.fed import client_state_pspecs
    from repro_torch.models import params as PM
    rec = {k: _np(PM.unshard(getattr(state, k), specs, mesh))
           for k in ("W", "M", "V")}
    cs = state.client_state
    whole = PM.unshard(cs, client_state_pspecs(cs, specs, None), mesh)
    rec["err"] = _np(whole["comp"]["err"])
    for k in ("m", "v"):
        rec[k] = _np(whole[k]) if k in whole else []
    return rec


def log_masks(run, log: list) -> None:
    """Wrap ``run``'s cohort: every client's output appends its carriers'
    supports (nonzero; a leaf the records hold as ``Nonzeros`` made dense
    first) per stream (W, M, V), each over the whole leaves
    in leaf order (each leaf gathered over its group,
    ``sparsify.LeafSplit.gather``), bit-packed, to ``log``, in dispatch
    order; every rank gathers, the same on each."""
    from repro_torch import tree as T
    from repro_torch.core.async_fed import Nonzeros
    inner, split = run._exec, run._split
    dense = lambda x: x.dense() if isinstance(x, Nonzeros) else x

    def exec_cohort(*args):
        outs = inner(*args)
        for o in outs:
            log.append([np.packbits(torch.cat([
                split.gather(i, (dense(x) != 0).to(torch.uint8))
                .reshape(-1) for i, x in enumerate(T.leaves(o[s]))])
                .numpy()) for s in range(3)])
        return outs

    run._exec = exec_cohort


def log_steps(run, specs, mesh, log: list) -> None:
    """Wrap ``run``'s server step: after each, W, M, V whole (every rank
    gathers) appended to ``log``."""
    from repro_torch.models import params as PM
    inner = run._apply

    def apply(*args):
        out = inner(*args)
        log.append({k: _np(PM.unshard(x, specs, mesh))
                    for k, x in zip("WMV", out)})
        return out

    run._apply = apply


def digest(rec) -> str:
    """A hash of a record's arrays, bit for bit, in key order."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(rec):
        for x in rec[k]:
            h.update(np.ascontiguousarray(x).view(np.uint8))
    return h.hexdigest()


def churn_case(view, mesh, params, tokens, algorithm) -> dict:
    """The driver under :data:`CHURN` for :data:`STEPS` server steps:
    the counts, the bill and the losses; on rank 0 the whole state after
    each server step, the final clients' state and every dispatch's
    supports; elsewhere a digest of the final whole state."""
    from repro_torch import tree as T
    b = bundle(view, mesh, algorithm)
    specs = b.static["pspecs"]
    run = driver(view, mesh, b, CHURN, ASYNC)
    masks: list = []
    steps: list = []
    log_masks(run, masks)
    log_steps(run, specs, mesh, steps)
    st, m = run(async_state(b, params, mesh), async_batches(view, mesh,
                                                            tokens),
                rounds=STEPS)
    whole = whole_state(st, specs, mesh)
    rec = {k: m[k] for k in ("events", "server_steps", "landed", "dropped",
                             "discarded", "buffer_pending", "bits_per_step",
                             "loss_per_step")}
    rec.update(
        uplink_bits=float(m["uplink_bits"]), round=st.round,
        digest=digest(whole),
        shard_shapes=[tuple(x.shape) for x in T.leaves(st.W)],
        cs_shapes=[tuple(x.shape) for x in T.leaves(st.client_state)],
        batch_shapes=[tuple(x.shape) for x in T.leaves(
            async_batches(view, mesh, tokens))])
    if mesh.rank == 0:
        rec.update(whole, masks=masks, steps=steps)
    return rec


def _bitwise(a, b) -> bool:
    from repro_torch import tree as T
    la, lb = (T.leaves((s.W, s.M, s.V, s.client_state)) for s in (a, b))
    return a.round == b.round and len(la) == len(lb) and all(
        torch.equal(x, y) for x, y in zip(la, lb))


def degenerate(view, mesh, params, tokens) -> dict:
    """FedAdam-SSM with error feedback: 2 split synchronous rounds (the
    tp plan's dense fold), the driver with zero churn and K = C from the
    same params for 2 server steps, and from round 1's synchronous state
    (its client state gathered on the spatial view) for 1: whether each
    is bitwise round 2's state, and the bills."""
    from repro_torch.core.fed import gather_client_state
    b = bundle(view, mesh, "fedadam_ssm",
               **({"aggregate": "dense"} if view == "tp" else {}))
    batch = sync_batch(view, mesh, tokens)
    st1, m1 = b.fn(b.init(params), batch)
    st2, m2 = b.fn(st1, batch)
    stacked = (lambda s: gather_client_state(s, mesh)) if view == "tp" \
        else (lambda s: s)
    run = driver(view, mesh, b, {}, dict(buffer_size=C))
    batches = async_batches(view, mesh, tokens)
    a2, am = run(async_state(b, params, mesh), batches, rounds=2)
    h2, hm = run(stacked(st1), batches, rounds=1)
    ref = stacked(st2)
    return {"async_bitwise": _bitwise(a2, ref),
            "handoff_bitwise": _bitwise(h2, ref),
            "sync_bits": [float(m1["uplink_bits"]),
                          float(m2["uplink_bits"])],
            "async_bits": float(am["uplink_bits"]),
            "handoff_bits": float(hm["uplink_bits"]),
            "steps": (am["server_steps"], hm["server_steps"]),
            "sync_loss": [m1["loss"].numpy(), m2["loss"].numpy()],
            "async_loss": am["loss_per_step"]}


def on_group(rank, world, store, params_np):
    """One rank's every case.  ``params_np``: the numpy param tree JAX's
    reference runs from."""
    from repro_torch.launch import mesh as MM
    from repro_torch.models import model as TM
    torch.set_num_threads(1)
    mesh = MM.make_test_group(world, rank, store, shape=MESH)
    try:
        cfg = smoke_cfg()
        params = TM.params_from_jax(params_np, cfg, "cpu")
        tokens = batch_tokens(cfg)
        out = {"churn": {}, "degenerate": {}}
        for view, vmesh in views(mesh).items():
            for alg in ALGORITHMS[view]:
                out["churn"][(view, alg)] = churn_case(view, vmesh, params,
                                                       tokens, alg)
            out["degenerate"][view] = degenerate(view, vmesh, params,
                                                 tokens)
        return out
    finally:
        mesh.close()
