"""The port's round drivers and their options against the JAX package's,
on the CPU.

* The client draw of ``participation < 1``: ``core/_threefry.py`` gives
  ``jax.random.permutation(fold_in(PRNGKey(17), round), C)`` exactly, and
  ``permutation(rng, C)`` for an explicit key pair.
* A participation-0.5 round of the width-0.25 CNN against jitted JAX,
  within the round tolerances of tests/test_torch_fed.py; the inactive
  clients still run, so their client state advances as in JAX.
* ``make_client_step(..., emit="wire")``: the payload is ``pack_wire`` of
  the encoder's carriers and decodes to the scan step's.
* ``client_mode="vmap"`` with the dense, the wire and the COO
  (``q_bits=16``) aggregation against JAX's ``round_vmap``; the wire
  transport is bitwise the port's scan round.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_bitwise, jax_packed_oracles,  # noqa: F401
                           to_jax, to_torch)
from repro.core import fed as jfed
from repro.models import vision as jvision
from repro.optim import adam as jadam
from repro_torch import tree as T
from repro_torch.core import _threefry, compressors, wire
from repro_torch.core import (FedConfig, fed_init, make_client_step,
                              make_fl_round)
from repro_torch.core.compressors import Deltas
from repro_torch.core.fed import _local_deltas, participation_weights
from repro_torch.data import (client_batches, dirichlet_partition,
                              synthetic_image_dataset)
from repro_torch.models import vision
from repro_torch.optim import adam

# ---------------------------------------------------------------------------
# The client draw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C", [1, 5, 20, 100, 2000])
def test_client_draw_equals_jax_permutation(C):
    for r in range(20):
        ref = jax.random.permutation(
            jax.random.fold_in(jax.random.PRNGKey(17), r), C)
        np.testing.assert_array_equal(_threefry.client_permutation(r, C),
                                      np.asarray(ref), err_msg=f"round {r}")
    key = np.array([123, 4_000_000_007], np.uint32)
    np.testing.assert_array_equal(
        _threefry.client_permutation(5, C, key=key),
        np.asarray(jax.random.permutation(jnp.asarray(key), C)))


def test_participation_weights_mask_the_drawn_clients():
    """The first ``active_client_count`` clients of the draw keep their
    weights, the others get 0.0 (an explicit key overrides the round's)."""
    fed = FedConfig(n_clients=20, participation=0.3)
    w = torch.arange(1, 21, dtype=torch.float32)
    key = np.array([9, 10], np.uint32)
    for r, rng in ((3, None), (3, key), (4, torch.from_numpy(key))):
        got = participation_weights(fed, w, r, rng)
        kept = np.flatnonzero(got.numpy())
        perm = _threefry.client_permutation(
            r, 20, None if rng is None else key)
        np.testing.assert_array_equal(kept, np.sort(perm[:6]))
        assert torch.equal(got[kept], w[kept])


# ---------------------------------------------------------------------------
# Rounds of the width-0.25 CNN, port against jitted JAX
# ---------------------------------------------------------------------------


def _cnn(C=4, rounds=2, B=8):
    jparams, _, jloss, _, ds = jvision.build_vision("cnn", width=0.25)
    params_np = {k: np.asarray(v) for k, v in jparams.items()}
    _, _, tloss, _, _ = vision.build_vision("cnn", width=0.25, device="cpu")
    imgs, labels = synthetic_image_dataset(ds, 256, seed=1)
    parts = dirichlet_partition(labels, n_clients=C, theta=0.1, seed=1)
    data = [client_batches([imgs, labels], parts, B, seed=r)
            for r in range(rounds)]
    return params_np, data, jloss, tloss


def _feds(C, **over):
    kw = dict(algorithm="fedadam_ssm", alpha=0.05, n_clients=C,
              local_epochs=2, exact_topk=False, error_feedback=True,
              sparsify_backend="kernel")
    kw.update(over)
    return (jfed.FedConfig(**kw, adam=jadam.AdamHyper(lr=1e-3)),
            FedConfig(**kw, adam=adam.AdamHyper(lr=1e-3)))


def _rounds(jf, tf, params_np, data, jloss, tloss):
    jround = jax.jit(jfed.make_fl_round(jf, jloss))
    tround = make_fl_round(tf, tloss)
    js = jfed.fed_init(jf, to_jax(params_np))
    ts = fed_init(tf, to_torch(params_np))
    out = []
    for (b, w) in data:
        js, jm = jround(js, to_jax(b), jnp.asarray(w))
        ts, tm = tround(ts, to_torch(b), torch.from_numpy(w))
        out.append((js, jm, ts, tm))
    return out


def _assert_close(a, b, what, rtol=1e-4, atol=1e-5, max_mismatch=2e-3):
    """The CNN round tolerance of tests/test_torch_fed.py: at most 0.2% of
    the elements outside rtol 1e-4 and 1e-5 of the largest |b|."""
    a, b = np.asarray(a), np.asarray(b)
    bad = ~np.isclose(a, b, rtol=rtol, atol=atol * float(np.abs(b).max()))
    assert bad.mean() <= max_mismatch, (what, int(bad.sum()), bad.size)


def _assert_rounds_close(out, client_state=True):
    for r, (js, jm, ts, tm) in enumerate(out):
        assert float(tm["uplink_bits"]) == float(jm["uplink_bits"]), r
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   rtol=1e-5, err_msg=f"round {r} loss")
        for name in "WMV":
            for k, a in getattr(ts, name).items():
                _assert_close(a.numpy(), getattr(js, name)[k],
                              (r, name, k))
        if client_state:
            err_t = ts.client_state["comp"]["err"]
            err_j = js.client_state["comp"]["err"]
            for k in err_t:
                kept_t = err_t[k].numpy() == 0
                kept_j = np.asarray(err_j[k]) == 0
                assert np.mean(kept_t != kept_j) <= 2e-3, (r, k)


def test_participation_round_matches_jitted_jax(jax_packed_oracles):
    """Half of 4 clients a round: the same two clients as JAX's draw carry
    weight, uplink counts two clients, and all four clients' residuals
    advance (the inactive ones run too, as in JAX)."""
    C = 4
    params_np, data, jloss, tloss = _cnn(C)
    jf, tf = _feds(C, participation=0.5)
    out = _rounds(jf, tf, params_np, data, jloss, tloss)
    _assert_rounds_close(out)
    ts, tm = out[0][2], out[0][3]
    per_client = compressors.make_compressor(tf).wire_bits_per_client(
        tuple(x.numel() for x in ts.W.values()))
    assert float(tm["uplink_bits"]) == 2 * per_client
    err = ts.client_state["comp"]["err"]
    assert all(bool(err[k][c].any()) for k in err for c in range(C))
    # the round is the full round with the undrawn clients' weights 0.0
    b, w = data[0]
    w_masked = participation_weights(tf, torch.from_numpy(w), 0)
    assert int((w_masked > 0).sum()) == 2
    full = FedConfig(**{**tf.__dict__, "participation": 1.0})
    ref, _ = make_fl_round(full, tloss)(fed_init(full, to_torch(params_np)),
                                        to_torch(b), w_masked)
    for name in "WMV":
        for k in ts.W:
            assert_bitwise(getattr(ts, name)[k], getattr(ref, name)[k],
                           f"{name}[{k}]")


# ---------------------------------------------------------------------------
# The client step's wire output and the vmap driver
# ---------------------------------------------------------------------------


def test_emit_wire_is_pack_wire_of_the_scan_carriers():
    """``emit="wire"`` returns the payload the scan step decodes: bitwise
    ``pack_wire`` of the encoder's carriers (its ``decompress``, before
    any round trip), which decodes to the scan step's carriers.  Repacking those decoded
    carriers (the async driver's bill) gives the same bytes and the same
    decode; its words may differ, because the value streams' capacity can
    cut off the last leaf's values (here fc2's, in both packages) while
    the first bitmap still marks them."""
    C = 3
    params_np, data, _, tloss = _cnn(C, rounds=1)
    _, tf = _feds(C)
    comp = compressors.make_compressor(tf)
    st = fed_init(tf, to_torch(params_np))
    b = T.tree_map(lambda x: x[0], to_torch(data[0][0]))
    cs = T.tree_map(lambda x: x[0], st.client_state)
    step = lambda **kw: make_client_step(tf, tloss, comp, **kw)(
        st.W, st.M, st.V, b, cs)
    payload, ncs_w, _ = step(emit="wire")
    deltas, _, _ = _local_deltas(comp.local_update, tloss, st.W, st.M, st.V,
                                 b, cs, tf)
    raw = comp.decompress(comp.compress(deltas, cs["comp"])[0])
    sW, sM, sV, ncs, _ = step()
    for part, a, r in zip(("words", "values", "scales"), payload,
                          comp.pack_wire(Deltas(*raw[:3]))):
        assert len(a) == len(r)
        for x, y in zip(a, r):
            assert_bitwise(x, y, part)
    for k in ncs["comp"]["err"]:
        assert_bitwise(ncs_w["comp"]["err"][k], ncs["comp"]["err"][k], k)
    decoded = comp.unpack_wire(payload, st.W)
    repacked = comp.pack_wire(Deltas(sW, sM, sV))
    assert wire.payload_nbytes(repacked) == wire.payload_nbytes(payload)
    for a, r, t in zip(decoded, (sW, sM, sV),
                       comp.unpack_wire(repacked, st.W)):
        for k in r:
            assert_bitwise(a[k], r[k], k)
            assert_bitwise(t[k], r[k], k)


@pytest.mark.parametrize("aggregate,q_bits", [("dense", 32),
                                              ("sparse_gather", 32),
                                              ("sparse_gather", 16)])
def test_vmap_round_matches_jax_round_vmap(aggregate, q_bits,
                                           jax_packed_oracles):
    """``client_mode="vmap"``: the dense weighted sum, the wire transport
    (q = 32) and the COO pack (q = 16: no wire realization) against the
    JAX package's jitted ``round_vmap``, two rounds of 3 clients."""
    C = 3
    params_np, data, jloss, tloss = _cnn(C)
    jf, tf = _feds(C, client_mode="vmap", aggregate=aggregate, q_bits=q_bits)
    out = _rounds(jf, tf, params_np, data, jloss, tloss)
    _assert_rounds_close(out)
    if aggregate == "dense" or q_bits != 32:
        return
    # the wire transport decodes and folds in client order: bitwise the
    # port's scan round, W, M, V and the residuals
    _, sf = _feds(C, q_bits=q_bits)
    scan = make_fl_round(sf, tloss)
    st = fed_init(sf, to_torch(params_np))
    for r, (b, w) in enumerate(data):
        st, sm = scan(st, to_torch(b), torch.from_numpy(w))
        ts, tm = out[r][2], out[r][3]
        assert float(sm["uplink_bits"]) == float(tm["uplink_bits"])
        for name in "WMV":
            for k in st.W:
                assert_bitwise(getattr(ts, name)[k], getattr(st, name)[k],
                               f"round {r} {name}[{k}]")
        for k in st.W:
            assert_bitwise(ts.client_state["comp"]["err"][k],
                           st.client_state["comp"]["err"][k], f"err[{k}]")
