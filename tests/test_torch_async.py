"""The port's buffered-async driver (``repro_torch.core.async_fed``) under
seeded churn, held to the invariants of the JAX package's suite
(tests/test_async_fed.py) and against ``repro.core.async_fed`` on the
same ``ChurnModel`` seed:

* the same seed replays the event log and the state bitwise;
* the zero-churn configuration with K = cohort is the scan round,
  bitwise (W, M, V, residuals, round, uplink bits);
* a dropped or discarded update leaves its client's state bitwise and is
  not billed; the buffer never applies below K, and consumes updates in
  multiples of K;
* ``staleness_scale(0) == 1``, and the weights equal the JAX package's;
* the event log equals the JAX driver's, and the final state agrees with
  it within the round tolerance of tests/test_torch_fed.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bitwise, to_jax, to_torch
from repro.core import async_fed as jasync
from repro.core import fed as jfed
from repro.data import churn as jchurn
from repro.optim import adam as jadam
from repro_torch import tree as T
from repro_torch.core import (AsyncConfig, FedConfig, fed_init,
                              make_async_round, make_fl_round,
                              staleness_scale, staleness_weights)
from repro_torch.core.compressors import make_compressor
from repro_torch.data import ChurnConfig, ChurnModel, ClientFate
from repro_torch.optim import adam


def _toy(C):
    """A linear regression per client: params, batches (numpy) and the
    loss in both packages."""
    rng = np.random.default_rng(0)
    params = {"w": (rng.standard_normal((8, 4)) * 0.1).astype(np.float32),
              "b": np.zeros(4, np.float32)}
    xs = rng.standard_normal((C, 16, 8)).astype(np.float32)
    ys = np.einsum("cbi,ij->cbj", xs,
                   rng.standard_normal((8, 4))).astype(np.float32)
    loss_t = lambda p, b: ((b[0] @ p["w"] + p["b"] - b[1]) ** 2).mean()
    loss_j = lambda p, b: jnp.mean((b[0] @ p["w"] + p["b"] - b[1]) ** 2)
    return params, (xs, ys), loss_t, loss_j


def _fed(C, **kw):
    kw.setdefault("algorithm", "fedadam_ssm")
    kw.setdefault("error_feedback", True)
    return FedConfig(alpha=0.3, local_epochs=2, n_clients=C,
                     adam=adam.AdamHyper(lr=0.05), **kw)


def _jfed(C, **kw):
    kw.setdefault("algorithm", "fedadam_ssm")
    kw.setdefault("error_feedback", True)
    return jfed.FedConfig(alpha=0.3, local_epochs=2, n_clients=C,
                          adam=jadam.AdamHyper(lr=0.05), **kw)


def _assert_state_bitwise(a, b, what=""):
    la, lb = T.leaves(a._asdict()), T.leaves(b._asdict())
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Tensor):
            assert_bitwise(x, y, f"{what} leaf {i}")
        else:
            assert x == y, what


def _client(cs, c):
    return T.tree_map(lambda x: x[c], cs)


def _tree_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(T.leaves(a), T.leaves(b)))


_CHURN = dict(seed=3, jitter=5, straggler_prob=0.3, drop_prob=0.2,
              rejoin_delay=2)


def test_same_seed_replays_bitwise():
    C = 6
    params, batches, loss_t, _ = _toy(C)
    fed = _fed(C)
    acfg = AsyncConfig(buffer_size=3, max_staleness=2)

    def go():
        run = make_async_round(fed, loss_t, acfg,
                               churn=ChurnModel(ChurnConfig(**_CHURN), C))
        st0 = fed_init(fed, to_torch(params))
        before = T.tree_map(torch.clone, st0.client_state)
        out = run(st0, to_torch(batches), rounds=5)
        # the driver commits into its own copy: the input state is as it was
        assert _tree_equal(st0.client_state, before)
        return out

    s1, m1 = go()
    s2, m2 = go()
    assert m1["events"] == m2["events"]
    assert m1["server_steps"] == 5
    assert m1["dropped"] > 0 and m1["discarded"] > 0
    assert float(m1["uplink_bits"]) == float(m2["uplink_bits"])
    assert m1["loss_per_step"] == m2["loss_per_step"]
    _assert_state_bitwise(s1, s2)


def test_event_log_and_state_match_jax_driver():
    """The same churn seed drives the same schedule through both drivers:
    the event log is equal and the final state is close."""
    C = 6
    params, batches, loss_t, loss_j = _toy(C)
    acfg = AsyncConfig(buffer_size=3, max_staleness=2)
    run = make_async_round(_fed(C), loss_t, acfg,
                           churn=ChurnModel(ChurnConfig(**_CHURN), C))
    ts, tm = run(fed_init(_fed(C), to_torch(params)), to_torch(batches),
                 rounds=4)
    jrun = jasync.make_async_round(
        _jfed(C), loss_j, jasync.AsyncConfig(buffer_size=3, max_staleness=2),
        churn=jchurn.ChurnModel(jchurn.ChurnConfig(**_CHURN), C))
    js, jm = jrun(jfed.fed_init(_jfed(C), to_jax(params)), to_jax(batches),
                  rounds=4)
    assert tm["events"] == jm["events"]
    for key in ("server_steps", "landed", "dropped", "discarded",
                "buffer_pending", "bits_per_step"):
        assert tm[key] == jm[key], key
    assert float(tm["uplink_bits"]) == float(jm["uplink_bits"])
    assert ts.round == int(js.round) == 4
    np.testing.assert_allclose(tm["loss_per_step"], jm["loss_per_step"],
                               rtol=1e-5)
    for name in "WMV":
        for k, a in getattr(ts, name).items():
            b = np.asarray(getattr(js, name)[k])
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                       atol=1e-5 * float(np.abs(b).max()),
                                       err_msg=f"{name}[{k}]")


def test_degenerate_config_matches_round_scan_bitwise():
    """Zero churn, K = cohort, staleness weight 1: three server steps are
    three scan rounds, bit for bit."""
    C = 4
    params, batches, loss_t, _ = _toy(C)
    fed = _fed(C)
    rf = make_fl_round(fed, loss_t)
    st = fed_init(fed, to_torch(params))
    sync_bits = 0.0
    for _ in range(3):
        st, mets = rf(st, to_torch(batches))
        sync_bits += float(mets["uplink_bits"])
    run = make_async_round(fed, loss_t, AsyncConfig(buffer_size=C),
                           churn=ChurnModel(ChurnConfig(), C))
    ast, amets = run(fed_init(fed, to_torch(params)), to_torch(batches),
                     rounds=3)
    assert amets["server_steps"] == 3 and amets["landed"] == 3 * C
    assert float(amets["uplink_bits"]) == sync_bits
    _assert_state_bitwise(st, ast)
    assert ast.round == 3


def _warm_state(fed, params, batches, loss_t):
    """One clean async step, so that the residuals are nonzero before a
    fault is injected."""
    run = make_async_round(fed, loss_t, AsyncConfig(buffer_size=fed.n_clients),
                           churn=ChurnModel(ChurnConfig(), fed.n_clients))
    st, _ = run(fed_init(fed, to_torch(params)), to_torch(batches), rounds=1)
    assert any(bool(x.any()) for x in T.leaves(st.client_state))
    return st


def _per_client_bits(fed, st):
    sizes = tuple(x.numel() for x in T.leaves(st.W))
    return make_compressor(fed).wire_bits_per_client(sizes)


@pytest.mark.parametrize("algorithm", ["fedadam_ssm", "fedadam_top"])
def test_measured_bill_is_the_static_layout(algorithm):
    """On whole leaves the driver bills each landed update at its measured
    payload bytes; under churn they equal the static layout
    (``wire_bits_per_client`` of the leaves' sizes) that split leaves are
    billed at, update by update and step by step: the shared-mask
    payload (FedAdam-SSM) and the three-mask one (FedAdam-Top)."""
    C = 6
    params, batches, loss_t, _ = _toy(C)
    fed = _fed(C, algorithm=algorithm)
    K = 3
    run = make_async_round(fed, loss_t,
                           AsyncConfig(buffer_size=K, max_staleness=2),
                           churn=ChurnModel(ChurnConfig(**_CHURN), C))
    st0 = fed_init(fed, to_torch(params))
    _, mets = run(st0, to_torch(batches), rounds=3)
    per = _per_client_bits(fed, st0)
    assert run._split is None and per is not None
    assert mets["dropped"] > 0 and mets["landed"] >= 3 * K
    assert float(mets["uplink_bits"]) == mets["landed"] * per
    assert mets["bits_per_step"] == [K * per] * 3


def test_drop_keeps_state_and_is_not_billed():
    C = 4
    params, batches, loss_t, _ = _toy(C)
    fed = _fed(C)
    st0 = _warm_state(fed, params, batches, loss_t)
    victim = 1
    churn = ChurnModel(ChurnConfig(), C,
                       script={(victim, 0): ClientFate(8, drop=True)})
    run = make_async_round(fed, loss_t, AsyncConfig(buffer_size=C - 1),
                           churn=churn)
    st1, mets = run(st0, to_torch(batches), rounds=1)
    assert mets["dropped"] == 1 and mets["landed"] == C - 1
    assert _tree_equal(_client(st0.client_state, victim),
                       _client(st1.client_state, victim))
    for c in range(C):
        if c != victim:
            assert not _tree_equal(_client(st0.client_state, c),
                                   _client(st1.client_state, c))
    assert float(mets["uplink_bits"]) == \
        (C - 1) * _per_client_bits(fed, st0)


def test_stale_discard_keeps_state_and_is_not_billed():
    C = 4
    params, batches, loss_t, _ = _toy(C)
    fed = _fed(C)
    st0 = _warm_state(fed, params, batches, loss_t)
    victim = 2
    churn = ChurnModel(ChurnConfig(), C,
                       script={(victim, 0): ClientFate(20, drop=False)})
    run = make_async_round(fed, loss_t,
                           AsyncConfig(buffer_size=C - 1, max_staleness=0),
                           churn=churn)
    st1, mets = run(st0, to_torch(batches), rounds=3)
    discards = [e for e in mets["events"] if e[1] == "discard"]
    assert any(e[2] == victim and e[3] == 2 for e in discards)
    assert float(mets["uplink_bits"]) == \
        mets["landed"] * _per_client_bits(fed, st0)
    if not any(e[1] == "deliver" and e[2] == victim
               for e in mets["events"]):
        assert _tree_equal(_client(st0.client_state, victim),
                           _client(st1.client_state, victim))


def test_buffer_never_applies_below_k():
    C = 4
    params, batches, loss_t, _ = _toy(C)
    fed = _fed(C)
    st0 = fed_init(fed, to_torch(params))
    run = make_async_round(fed, loss_t, AsyncConfig(buffer_size=2),
                           churn=ChurnModel(ChurnConfig(drop_prob=1.0), C))
    st1, mets = run(st0, to_torch(batches), rounds=1, max_events=64)
    assert mets["server_steps"] == 0 and mets["landed"] == 0
    assert float(mets["uplink_bits"]) == 0.0
    _assert_state_bitwise(st0, st1)
    assert not any(e[1] == "server_step" for e in mets["events"])


def test_buffer_consumed_in_multiples_of_k():
    C = 6
    params, batches, loss_t, _ = _toy(C)
    fed = _fed(C, participation=5 / 6)
    cc = ChurnConfig(seed=11, jitter=4, straggler_prob=0.25, drop_prob=0.15)
    K = 4
    run = make_async_round(fed, loss_t, AsyncConfig(buffer_size=K),
                           churn=ChurnModel(cc, C))
    _, mets = run(fed_init(fed, to_torch(params)), to_torch(batches),
                  rounds=4)
    assert mets["landed"] == K * mets["server_steps"] \
        + mets["buffer_pending"]
    for e in mets["events"]:
        if e[1] == "server_step":
            assert len(e[3]) == K
    # participation 5/6: the churn model's pool of 5 clients dispatches
    pool = set(ChurnModel(cc, C).participation_pool(5).tolist())
    assert {e[2] for e in mets["events"] if e[1] == "dispatch"} == pool


@pytest.mark.parametrize("power", [0.0, 0.25, 0.5, 1.0, 2.0])
def test_staleness_weighting_matches_jax(power):
    assert float(staleness_scale(0, power)) == 1.0
    s = np.array([0, 3, 1, 7, 0, 2])
    np.testing.assert_array_equal(staleness_scale(s, power),
                                  jasync.staleness_scale(s, power))
    w = staleness_weights(s, power)
    np.testing.assert_array_equal(w, jasync.staleness_weights(s, power))
    assert abs(float(w.sum()) - 1.0) < 1e-12


def test_churn_model_is_the_jax_model():
    """The copied churn model draws the same fates and pool."""
    cfg = dict(seed=5, jitter=3, straggler_prob=0.1, drop_prob=0.2)
    a = ChurnModel(ChurnConfig(**cfg), 20)
    b = jchurn.ChurnModel(jchurn.ChurnConfig(**cfg), 20)
    for c in range(20):
        for attempt in range(6):
            assert tuple(a.fate(c, attempt)) == tuple(b.fate(c, attempt))
    np.testing.assert_array_equal(a.participation_pool(7),
                                  b.participation_pool(7))


def test_shardmap_exec_raises():
    """The group cohort needs its group, and refuses one with an axis
    beyond the client axes and "model" (§1.10(b)).  On a model axis above
    1 it runs (tests/test_torch_async_split.py)."""
    from repro_torch.launch.mesh import ClientMesh
    fed = _fed(2, client_mode="vmap", client_axes=("data",))
    with pytest.raises(ValueError, match="mesh="):
        make_async_round(fed, lambda p, b: p["w"].sum(),
                         client_exec="shardmap")
    for shape, item in (({"data": 2, "expert": 2}, r"§1\.10\(b\)"),):
        mesh = ClientMesh(shape=shape, client_axes=("data",), rank=0,
                          device=torch.device("cpu"))
        with pytest.raises(NotImplementedError, match=item):
            make_async_round(fed, lambda p, b: p["w"].sum(),
                             client_exec="shardmap", mesh=mesh)
