"""What each rank runs in tests/test_torch_spatial.py: the port's spatial
round, its async mesh cohort and ``build_train_step`` on a gloo group of
CPU processes (``launch.mesh.run_ranks``).  It imports no jax, so that a
spawned rank starts quickly; it returns numpy arrays.

The toy model: per client, a quadratic pull of each parameter towards the
client's targets, ``mean((w - t_w)^2) + mean((b - t_b)^2)``.  Its
gradient is elementwise (and its means over powers of two), so the
port's rounds can be held bitwise against eager JAX's."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: The spatial round's cases: algorithm and FedConfig fields.  The sparse
#: ones take the injected transport, the dense ones the gathered fold.
ROUND_CASES = {
    "fedadam_ssm": dict(algorithm="fedadam_ssm", error_feedback=True,
                        alpha=0.25, aggregate="sparse_gather"),
    "fedadam_top": dict(algorithm="fedadam_top", error_feedback=True,
                        alpha=0.25, aggregate="sparse_gather"),
    "onebit_adam": dict(algorithm="onebit_adam", aggregate="dense"),
    "efficient_adam": dict(algorithm="efficient_adam", aggregate="dense"),
    "fedadam_ssm_participation": dict(
        algorithm="fedadam_ssm", error_feedback=True, alpha=0.25,
        aggregate="sparse_gather", participation=0.5),
}
ROUNDS = 3
LR = 0.05
LOCAL_EPOCHS = 2


def toy(C: int, seed: int = 0):
    """(params, batches) as numpy: batches ``{"b": (C, 4), "w": (C, 8,
    4)}``, the clients' targets."""
    rng = np.random.default_rng(seed)
    params = {"w": (rng.standard_normal((8, 4)) * 0.1).astype(np.float32),
              "b": np.zeros(4, np.float32)}
    batches = {"w": rng.standard_normal((C, 8, 4)).astype(np.float32),
               "b": rng.standard_normal((C, 4)).astype(np.float32)}
    return params, batches


def toy_loss(p, b):
    return torch.mean((p["w"] - b["w"]) ** 2) \
        + torch.mean((p["b"] - b["b"]) ** 2)


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _numpy_leaves(tree):
    from repro_torch import tree as T
    return [x.detach().cpu().numpy() for x in T.leaves(tree)]


def _state_record(state):
    return {"W": _numpy_leaves(state.W), "M": _numpy_leaves(state.M),
            "V": _numpy_leaves(state.V),
            "cs": _numpy_leaves(state.client_state)}


def _fed(C, case, spatial):
    from repro_torch.core import FedConfig
    from repro_torch.optim.adam import AdamHyper
    kw = dict(ROUND_CASES[case], local_epochs=LOCAL_EPOCHS, n_clients=C,
              adam=AdamHyper(lr=LR))
    if spatial:
        kw.update(client_mode="vmap", client_axes=("data",))
    else:
        kw["aggregate"] = "dense"
    return FedConfig(**kw)


def _same_on_every_rank(mesh, tree) -> bool:
    from repro_torch import tree as T
    for x in T.leaves(tree):
        g = mesh.all_gather(x)
        if not all(torch.equal(g[0], g[r]) for r in range(g.shape[0])):
            return False
    return True


def on_group(rank, world, store, cases, extras=False):
    """What a rank of the tests' gloo group runs: the spatial rounds of
    ``cases``, and with ``extras`` the async cohorts and the train step
    too (one spawn for all)."""
    from repro_torch.launch import mesh as MM

    torch.set_num_threads(1)
    mesh = MM.make_test_group(world, rank, store)
    try:
        out = {"rounds": spatial_rounds(mesh, cases)}
        if extras:
            out["async"] = async_cohorts(mesh)
            out["train_step"] = train_step(mesh)
        return out
    finally:
        mesh.close()


def spatial_rounds(mesh, cases):
    """Every case of ``cases`` for ``ROUNDS`` rounds on the group: the
    spatial round's states (client state gathered to (C, ...)) and
    metrics, whether every rank holds the same W, M, V, and whether each
    round is bitwise the port's scan round on the whole cohort."""
    from repro_torch.core import aggregate, fed_init, make_fl_round
    from repro_torch.core.compressors import transport_of
    from repro_torch.core.fed import gather_client_state, local_clients
    from repro_torch import tree as T

    world = mesh.world_size
    out = {}
    params_np, batches_np = toy(world)
    params, batches = _torch(params_np), _torch(batches_np)
    for case in cases:
        fed_m, fed_s = _fed(world, case, True), _fed(world, case, False)
        agg = None
        if fed_m.aggregate == "sparse_gather":
            agg = aggregate.make_shardmap_sparse_aggregate(
                mesh, None, ("data",), fed_m.alpha,
                shared=transport_of(fed_m.algorithm) == "shared_sparse")
        spatial = make_fl_round(fed_m, toy_loss, agg, mesh=mesh)
        scan = make_fl_round(fed_s, toy_loss)
        st = fed_init(fed_m, params)
        st = st._replace(client_state=local_clients(st.client_state,
                                                    mesh))
        ref = fed_init(fed_s, params)
        mine = local_clients(batches, mesh)
        rec = {"rounds": [], "loss": [], "uplink_bits": [],
               "ranks_agree": True, "scan_bitwise": True}
        for _ in range(ROUNDS):
            st, mets = spatial(st, mine)
            ref, _ = scan(ref, batches)
            full = gather_client_state(st, mesh)
            rec["rounds"].append(_state_record(full))
            rec["loss"].append(mets["loss"].numpy())
            rec["uplink_bits"].append(float(mets["uplink_bits"]))
            rec["ranks_agree"] &= _same_on_every_rank(
                mesh, (st.W, st.M, st.V))
            rec["scan_bitwise"] &= all(
                torch.equal(x, y) for x, y in zip(
                    T.leaves((full.W, full.M, full.V,
                              full.client_state)),
                    T.leaves((ref.W, ref.M, ref.V, ref.client_state))))
        out[case] = rec
    return out


ASYNC_CHURN = dict(seed=5, jitter=3, straggler_prob=0.25, drop_prob=0.15)
ASYNC_STEPS = 4


def async_cohorts(mesh):
    """The buffered-async driver under churn on the group
    (``client_exec="shardmap"``) and with the scan cohort, from one state:
    whether the event logs, W, M, V, client state and bills are equal."""
    from repro_torch.core import AsyncConfig, fed_init, make_async_round
    from repro_torch.data import ChurnConfig, ChurnModel
    from repro_torch import tree as T

    world = mesh.world_size
    params_np, batches_np = toy(world)
    params, batches = _torch(params_np), _torch(batches_np)
    acfg = AsyncConfig(buffer_size=2, max_staleness=2)
    runs = {}
    for kind in ("scan", "shardmap"):
        fed = _fed(world, "fedadam_ssm", kind == "shardmap")
        run = make_async_round(
            fed, toy_loss, acfg,
            churn=ChurnModel(ChurnConfig(**ASYNC_CHURN), world),
            client_exec=kind, mesh=mesh if kind == "shardmap" else None)
        runs[kind] = run(fed_init(fed, params), batches,
                         rounds=ASYNC_STEPS)
    (a, ma), (b, mb) = runs["scan"], runs["shardmap"]
    return {
        "steps": (ma["server_steps"], mb["server_steps"]),
        "events_equal": ma["events"] == mb["events"],
        "landed": (ma["landed"], mb["landed"]),
        "state_bitwise": all(torch.equal(x, y) for x, y in zip(
            T.leaves((a.W, a.M, a.V, a.client_state)),
            T.leaves((b.W, b.M, b.V, b.client_state)))),
        "bits_equal": float(ma["uplink_bits"])
        == float(mb["uplink_bits"])}


def train_step(mesh):
    """``launch.steps.build_train_step`` for the smoke deepseek-v2-lite
    (MLA + MoE) at a short sequence, one round on each rank: its loss
    per client, uplink bits, and whether every rank holds the same W."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core.fed import local_clients
    from repro_torch.launch import steps, train
    from repro_torch.models import model as TM
    from repro_torch import tree as T

    world = mesh.world_size
    cfg = reduce_for_smoke(get_config("deepseek-v2-lite-16b"))
    shape = dataclasses.replace(steps.SHAPES["train_4k"], seq_len=32,
                                global_batch=2 * world)
    bundle = steps.build_train_step(cfg, mesh, shape,
                                    error_feedback=True, local_epochs=1)
    state = bundle.init(TM.init_params(cfg, seed=0, device="cpu"))
    per_client, text_len = bundle.batch_shapes["tokens"][1:]
    batch = local_clients(train.build_client_batches(
        cfg, world, per_client, text_len, seed=0, device="cpu"), mesh)
    state, mets = bundle.fn(state, batch)
    return {"loss": mets["loss"].numpy(),
            "uplink_bits": float(mets["uplink_bits"]),
            "fed": dataclasses.asdict(bundle.static["fed"]),
            "batch_shapes": bundle.batch_shapes,
            "ranks_agree": _same_on_every_rank(mesh, state.W),
            "cs_shapes": [tuple(x.shape) for x in
                          T.leaves(state.client_state)]}
