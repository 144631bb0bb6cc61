"""The port's buffered-async driver on split leaves against the JAX
package on the CPU: ``make_async_round(..., mesh=, pspecs=)`` on the
(data 2, model 2) group of 4 gloo ranks, through both views of the group
(``tests/_torch_async_ranks.py``):

* (a) the ``tp`` plan's group cohort (client axis "data", each rank on
  its model shards and lane ``mesh.client_index``): FedAdam-SSM and
  FedAdam-Top with error feedback, and Efficient-Adam;
* (b) the ``fsdp`` plan's virtual clients (no client axes, the scan
  cohort on every rank's FSDP+tp shards and its slice of each client's
  batch): FedAdam-SSM with error feedback and Efficient-Adam.

Each is held to JAX's whole-leaf async driver (``client_exec="scan"``)
under the same churn seed, params and client batches, in ONE subprocess
beside the spawn: the event log, the counts and the bill exactly; the
state after every server step and the clients' final state within
``tests/test_torch_tensor.py``'s bounds, where the supports that differ
(a value at the whole leaf's threshold that the split products' other
summation order moves across it) are counted and printed, as are the
values JAX's wire capacity cut.  Besides, against the port's own split
synchronous round, bit for bit: zero churn with K = C for 2 server steps
is 2 rounds, and round 2 by the async driver from round 1's synchronous
state (the checkpoint handoff) is round 2.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import _torch_async_ranks as R
from _torch_tensor_ranks import draw_params
from repro_torch.core import wire
from repro_torch.launch import mesh as MM
from repro_torch.models import model as TM
from test_torch_tensor import (ERR_TOL, QUANT_MOVED_SHARE, STEP_TOL,
                               SUPPORT_SHARE, _beyond, _leaf_errors,
                               assert_quantized_round)

_TESTS = Path(__file__).resolve().parent
_REPO = _TESTS.parent
SPAWN_TIMEOUT_S = 300
_CASES = [f"{v}:{a}" for v, algs in R.ALGORITHMS.items() for a in algs]

_JAX_SUB = textwrap.dedent("""
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, reduce_for_smoke
    from repro.core import async_fed as A
    from repro.core import fed as F
    from repro.data import churn as CH
    from repro.models import model as JM
    from repro.optim import adam as JADAM
    sys.path.insert(0, sys.argv[1])
    import _torch_async_ranks as R

    leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
    masks, steps = [], []
    make_step, make_apply, make_wire_apply = (
        A.make_client_step, A.make_buffer_apply, A.make_wire_buffer_apply)

    def logged_step(*args, **kw):
        # the cohort's client step, its (wire-decoded) carriers' supports
        # per stream appended to masks as it runs
        step = make_step(*args, **kw)

        def client_step(*a):
            out = step(*a)
            sel = [jnp.concatenate([(x != 0).reshape(-1)
                                    for x in jax.tree.leaves(t)])
                   for t in out[:3]]
            jax.debug.callback(lambda *m: masks.append(
                [np.packbits(np.asarray(x)) for x in m]), *sel,
                ordered=True)
            return out

        return client_step

    def logged(make):
        # a server step, W, M, V appended to steps after each
        def build(*args, **kw):
            apply = make(*args, **kw)

            def run(*a):
                out = apply(*a)
                steps.append({k: leaves(x) for k, x in zip("WMV", out)})
                return out

            return run

        return build

    A.make_client_step = logged_step
    A.make_buffer_apply = logged(make_apply)
    A.make_wire_buffer_apply = logged(make_wire_apply)
    with open(sys.argv[2], "rb") as f:
        params_np = pickle.load(f)
    cfg = reduce_for_smoke(get_config(R.MODEL))
    cfg = dataclasses.replace(cfg, dtype="float32", layer_pattern=tuple(
        dataclasses.replace(s, gated_mlp=False) for s in cfg.layer_pattern))
    loss = lambda p, b: JM.loss_fn(cfg, p, b["tokens"], remat="full")
    batches = {"tokens": jnp.asarray(R.batch_tokens(cfg))}
    out = {}
    for alg in R.JAX_ALGORITHMS:
        masks.clear()
        steps.clear()
        fed = F.FedConfig(algorithm=alg, alpha=R.ALPHA,
                          local_epochs=R.LOCAL_EPOCHS, n_clients=R.C,
                          adam=JADAM.AdamHyper(lr=R.LR), exact_topk=False,
                          mask_scope="per_tensor", error_feedback=True)
        run = A.make_async_round(
            fed, loss, A.AsyncConfig(**R.ASYNC),
            churn=CH.ChurnModel(CH.ChurnConfig(**R.CHURN), R.C))
        st, m = run(F.fed_init(fed, jax.tree.map(jnp.asarray, params_np)),
                    batches, rounds=R.STEPS)
        jax.effects_barrier()
        cs = st.client_state
        rec = {k: leaves(getattr(st, k)) for k in ("W", "M", "V")}
        rec["err"] = leaves(cs["comp"]["err"])
        for k in ("m", "v"):
            rec[k] = leaves(cs[k]) if k in cs else []
        rec.update({k: m[k] for k in (
            "events", "server_steps", "landed", "dropped", "discarded",
            "buffer_pending", "bits_per_step", "loss_per_step")},
            uplink_bits=float(m["uplink_bits"]), round=int(st.round),
            masks=list(masks), steps=list(steps))
        out[alg] = rec
    with open(sys.argv[3], "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """``(jax, ranks)``: JAX's whole-leaf async runs (a subprocess) and
    every rank's records of the port's cases (``R.on_group``), run at
    the same time from one numpy draw of the params."""
    tmp = tmp_path_factory.mktemp("async_split")
    params_np = draw_params(TM.abstract_params(R.smoke_cfg()), 0)
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(params_np, f)
    env = dict(os.environ, PYTHONPATH=str(_REPO / "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", _JAX_SUB, str(_TESTS),
                            str(tmp / "params.pkl"), str(tmp / "jax.pkl")],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        ranks = MM.run_ranks(R.on_group, R.WORLD, store=str(tmp / "store"),
                             args=(params_np,), timeout_s=SPAWN_TIMEOUT_S)
        _, err = ref.communicate(timeout=SPAWN_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    with open(tmp / "jax.pkl", "rb") as f:
        return pickle.load(f), ranks


def _schedule(events):
    """Per dispatch, in the log's order (the masks' order): its fate
    (``deliver``, ``drop``, ``discard`` or ``None`` in flight) and the
    server step that folded it (``None``: none).  A client has one
    dispatch in flight at a time, so an arrival is its latest."""
    last, out, buf, step = {}, [], [], 0
    for e in events:
        if e[1] == "dispatch":
            last[e[2]] = len(out)
            out.append([None, None])
        elif e[1] in ("drop", "discard", "deliver"):
            out[last[e[2]]][0] = e[1]
            if e[1] == "deliver":
                buf.append(last[e[2]])
        elif e[1] == "server_step":
            step += 1
            for d in buf:
                out[d][1] = step
            buf = []
    return out


def _differ(port_masks, jax_masks, n):
    """Per dispatch and stream, the elements where the two supports
    differ."""
    return [[int((np.unpackbits(a[s])[:n] != np.unpackbits(b[s])[:n])
                 .sum()) for s in range(3)]
            for a, b in zip(port_masks, jax_masks)]


def _cut(port_masks, sizes, alg):
    """Per dispatch and stream, the values JAX's wire would cut: the
    port's selected count (no wire on split leaves) beyond a mask
    stream's value capacity (``core/wire.mask_value_capacity``); none
    for a quantizer, whose wire has no capacity."""
    if alg not in ("fedadam_ssm", "fedadam_top"):
        return [[0] * 3 for _ in port_masks]
    cap = wire.mask_value_capacity(sizes, R.ALPHA, exact_topk=False)
    n = sum(sizes)
    return [[max(0, int(np.unpackbits(m[s])[:n].sum()) - cap)
             for s in range(3)] for m in port_masks]


def _case(spawn, case):
    view, alg = case.split(":")
    return spawn[1], spawn[1][0]["churn"][(view, alg)], spawn[0][alg], alg


@pytest.mark.parametrize("case", _CASES)
def test_async_split_events_and_bill_are_jax(spawn, case):
    """The event log, the counts, the bill (each landed update at the
    whole leaves' static layout, the measured payload bytes JAX bills)
    and the rounds exactly JAX's whole-leaf driver's, on every rank; the
    schedule has a drop, a staleness of 2 and a group of 2 (padded on
    the client group); the step losses within 1e-5."""
    ranks, port, ref, _ = _case(spawn, case)
    view, alg = case.split(":")
    for rk in ranks:
        got = rk["churn"][(view, alg)]
        for key in ("events", "server_steps", "landed", "dropped",
                    "discarded", "buffer_pending", "bits_per_step",
                    "uplink_bits", "round"):
            assert got[key] == ref[key], (case, key, got[key], ref[key])
    assert port["server_steps"] == R.STEPS and port["dropped"] >= 1
    assert any(e[1] == "deliver" and e[3] == 2 for e in port["events"])
    ticks = [e[0] for e in port["events"] if e[1] == "dispatch"]
    assert any(ticks.count(t) == R.C for t in ticks)
    np.testing.assert_allclose(port["loss_per_step"], ref["loss_per_step"],
                               rtol=1e-5)


@pytest.mark.parametrize("case", _CASES)
def test_async_split_state_matches_jax(spawn, case):
    """W, M, V after every server step and the clients' final state
    against JAX's whole-leaf driver.  FedAdam-SSM and -Top: until a server
    step folds an update whose support differs from JAX's, the state
    after it is within ``STEP_TOL`` of each leaf's largest element but at
    no more elements than the supports that differed so far
    (``test_torch_tensor``'s rule for masks); once one has, the clients
    after it train from a W that differs there by a whole update, every
    gradient moves by a little, and each part is held to ten times its
    bound but at those supports and ``SUPPORT_SHARE`` of the elements
    (:func:`_hold`).  The residual: within ``ERR_TOL`` likewise.  Supports differ at no more than ``SUPPORT_SHARE`` of a
    dispatch's elements.  Efficient-Adam: ``assert_quantized_round``
    after every step and on the final residual.  Every rank returns the
    same final state."""
    ranks, port, ref, alg = _case(spawn, case)
    sizes = [np.asarray(x).size for x in ref["W"]]
    n = sum(sizes)
    sched = _schedule(port["events"])
    assert len(port["masks"]) == len(ref["masks"]) == len(sched)
    differ = _differ(port["masks"], ref["masks"], n)
    cut = _cut(port["masks"], sizes, alg)
    print(f"\n{case}: supports differ per dispatch {differ}, values "
          f"JAX's wire cut {cut}, fates {[f for f, _ in sched]}")
    for d in differ:
        assert max(d) <= SUPPORT_SHARE * n, (case, differ)
    for rk in ranks[1:]:
        assert rk["churn"][tuple(case.split(":"))]["digest"] == \
            port["digest"], case
    assert len(port["steps"]) == len(ref["steps"]) == R.STEPS
    if alg == "efficient_adam":
        for s, (a, b) in enumerate(zip(port["steps"], ref["steps"])):
            assert_quantized_round(dict(a, err=[]), dict(b, err=[]),
                                   (case, s + 1), alg)
        assert_quantized_round(port, ref, (case, "final"), alg)
        for k in ("m", "v"):
            assert len(port[k]) == len(sizes)
            beyond = _beyond(port[k], ref[k], STEP_TOL)
            print(f"{case}: client {k} beyond {STEP_TOL}: {beyond}")
            assert beyond <= QUANT_MOVED_SHARE * R.C * n, (case, k, beyond)
        return
    folded = [[d for d, (_, st) in enumerate(sched) if st == s]
              for s in range(1, R.STEPS + 1)]
    parted, so_far = False, np.zeros(3, int)
    for s, (a, b) in enumerate(zip(port["steps"], ref["steps"])):
        for d in folded[s]:
            so_far += differ[d]
        for i, part in enumerate("WMV"):
            _hold(a[part], b[part], so_far[i], parted, STEP_TOL, n,
                  (case, s + 1, part))
        parted = parted or bool(so_far.any())
    flips = sum(int(((np.asarray(x) == 0) != (np.asarray(y) == 0)).sum())
                for x, y in zip(port["err"], ref["err"]))
    assert flips <= SUPPORT_SHARE * R.C * n, (case, flips)
    _hold(port["err"], ref["err"], flips, parted, ERR_TOL, R.C * n,
          (case, "residual"))


def _hold(got, ref, differed, parted, tol, n, what):
    """One part of the state against JAX's: beyond ``tol`` of each leaf's
    largest element at no more elements than the ``differed`` supports;
    once the trajectories have parted (a client trained from a W that
    differs by a whole update where a support differed), beyond ten times
    ``tol`` at no more than those and ``SUPPORT_SHARE`` of the ``n``
    elements.  Prints the counts."""
    beyond = _beyond(got, ref, tol)
    wide = _beyond(got, ref, 10 * tol)
    print(f"{what}: beyond {tol} at {beyond}, beyond {10 * tol} at {wide}, "
          f"supports differed {differed}, parted {parted}, largest "
          f"{max(_leaf_errors(got, ref))}")
    if parted:
        assert wide <= differed + SUPPORT_SHARE * n, (what, wide, differed)
    else:
        assert beyond <= differed, (what, beyond, differed)


@pytest.mark.parametrize("view", ["tp", "fsdp"])
def test_async_split_degenerate_and_handoff_are_the_sync_round(spawn, view):
    """With zero churn and K = C, 2 server steps of the split driver are
    bit for bit 2 split synchronous rounds (the tp plan's dense fold, the
    virtual plan's scan round), and round 2 by the driver from round 1's
    synchronous state (the checkpoint handoff) is round 2, on every rank;
    the driver bills what the synchronous rounds bill."""
    for rank, rk in enumerate(spawn[1]):
        got = rk["degenerate"][view]
        what = (view, rank)
        assert got["steps"] == (2, 1), (what, got["steps"])
        assert got["async_bitwise"], what
        assert got["handoff_bitwise"], what
        assert got["async_bits"] == sum(got["sync_bits"]), (what, got)
        assert got["handoff_bits"] == got["sync_bits"][1], (what, got)
