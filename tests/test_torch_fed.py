"""The port's optimizer, models and FL round against the JAX package, and
the port's guards.

* Adam: bitwise against the eager JAX ``_adam_leaf``; against the jitted
  one within an ulp bound (XLA fuses ``b1*m + (1-b1)*g`` into an FMA).
  The fused_adam path is tests/test_torch_perleaf_kernels.py's.
* Vision models: the same weights (carried from JAX through numpy) and
  batch give the same loss and gradients up to float32 summation order.
* The round: 3 rounds of the CNN (FedAdam-SSM with threshold and with
  exact masks, FedAdam-Top, dense FedAdam and FedSGD, Efficient-Adam; 1-bit
  Adam after two dense warm-up rounds), the port on the CPU with the kernel
  backend (its kernels' plain versions) against the JAX jitted round on
  its kernel backend (packed_topk kernels through their jnp oracles, see
  ``_torch_parity.jax_packed_oracles``).  ``uplink_bits`` is exactly
  equal; losses, W/M/V and the client state agree within stated
  tolerances.
* The server's ``precond_m`` rule and ``sgd_step`` against eager JAX.
"""
import ast
from pathlib import Path

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
from repro_torch.core import (FedConfig, fed_init, make_fl_round,
                              make_server_apply)
from repro_torch.data import (client_batches, dirichlet_partition,
                              synthetic_image_dataset)
from repro_torch.models import vision
from repro_torch.optim import adam

REPO = Path(__file__).resolve().parents[1]
EPS32 = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------


def _adam_inputs(n=65_536, seed=0):
    rng = np.random.default_rng(seed)
    w, g, m = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(n)).astype(np.float32) * 0.01
    return w, g, m, v


@pytest.mark.parametrize("h", [jadam.AdamHyper(),
                               jadam.AdamHyper(lr=0.05, weight_decay=0.01)])
def test_adam_leaf_bitwise_vs_eager_jax(h):
    w, g, m, v = _adam_inputs()
    ref = jadam._adam_leaf(*map(jnp.asarray, (w, g, m, v)), h,
                           jnp.zeros((), jnp.int32))
    th = adam.AdamHyper(lr=h.lr, weight_decay=h.weight_decay)
    out = adam._adam_leaf(*map(torch.from_numpy, (w, g, m, v)), th, 0)
    for name, a, b in zip("wmv", out, ref):
        assert_bitwise(a, b, name)


def test_adam_leaf_vs_jitted_jax_within_ulps():
    w, g, m, v = _adam_inputs(seed=1)
    h = jadam.AdamHyper()
    leaf = jax.jit(lambda *a: jadam._adam_leaf(*a, h,
                                               jnp.zeros((), jnp.int32)))
    ref = [np.asarray(x) for x in leaf(*map(jnp.asarray, (w, g, m, v)))]
    out = adam._adam_leaf(*map(torch.from_numpy, (w, g, m, v)),
                          adam.AdamHyper(), 0)
    # an FMA skips one rounding of the product: m and v may differ by two
    # roundings at their terms' magnitude; w by two ulps of its own plus
    # that relative error carried through lr * upd
    m_terms = 0.9 * np.abs(m) + 0.1 * np.abs(g)
    v_terms = 0.999 * np.abs(v) + 0.001 * g * g
    upd = np.abs(ref[1]) / np.sqrt(ref[2].astype(np.float64) + 1e-6)
    w_mag = np.maximum(np.abs(ref[0]), np.abs(out[0].numpy()))
    bound = {"w": 2 * np.spacing(w_mag) + 1e-3 * 8 * EPS32 * upd,
             "m": 2 * EPS32 * m_terms, "v": 2 * EPS32 * v_terms}
    for name, a, b in zip("wmv", out, ref):
        err = np.abs(a.numpy().astype(np.float64) - b.astype(np.float64))
        assert np.all(err <= bound[name]), (name, float(err.max()))
        assert np.mean(err > 0) < 0.5, name


def test_adam_step_kernel_raises_until_ported():
    """The fused_adam kernel is ported: ``use_kernel=True`` runs its plain
    version on CPU tensors and raises only for a device that has neither
    (the per-leaf JAX parity is tests/test_torch_perleaf_kernels.py)."""
    p = {"w": torch.zeros(4)}
    new_p, st = adam.adam_step(p, p, adam.adam_init(p), adam.AdamHyper(),
                               use_kernel=True)
    assert st.count == 1 and torch.equal(new_p["w"], p["w"])
    q = {"w": torch.zeros(4, device="meta")}
    with pytest.raises(ValueError, match="unsupported device"):
        adam.adam_step(q, q, adam.adam_init(q), adam.AdamHyper(),
                       use_kernel=True)


# ---------------------------------------------------------------------------
# Vision models with carried weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,width", [("cnn", 0.25), ("vgg11", 0.125),
                                        ("resnet18", 0.125)])
def test_vision_loss_and_grads_match_jax(name, width):
    jparams, _, jloss, _, ds = jvision.build_vision(name, width=width)
    imgs, labels = synthetic_image_dataset(ds, 4, seed=3)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    params = vision.params_from_jax(np_params, "cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: v.shape for k, v in np_params.items()}
    _, _, loss_fn, _, _ = vision.build_vision(name, width=width,
                                              device="cpu")
    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jparams, (jnp.asarray(imgs), jnp.asarray(labels)))
    req = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(req, (torch.from_numpy(imgs), torch.from_numpy(labels)))
    loss.backward()
    # same float32 math, different summation order inside the convolutions
    # and matrix products: relative error a few hundred ulps at most
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in np_params:
        gj = np.asarray(jg[k])
        np.testing.assert_allclose(req[k].grad.numpy(), gj, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(gj).max()),
                                   err_msg=k)


def test_vision_keeps_the_jax_layout():
    p = vision.init_params("cnn", width=1.0, device="cpu")
    assert list(p) == ["conv1", "conv2", "fc1", "fc2"]
    assert tuple(p["conv2"].shape) == (5, 5, 32, 64)
    assert tuple(p["fc1"].shape) == (3136, 128)
    assert sum(x.numel() for x in p.values()) == 454_688


# ---------------------------------------------------------------------------
# The round
# ---------------------------------------------------------------------------


def _run_both(fed_kw, params_np, batches_np, loss_j, loss_t, rounds=3,
              weights=None, start=None):
    """Run ``rounds`` rounds in both packages from the same weights and
    batches; returns per-round (jax_state, jax_mets, port_state,
    port_mets).  ``start``: a (jax_state, port_state) pair whose W, M and
    V the rounds start from (1-bit Adam after its warm-up), with the
    batches of rounds ``len(batches_np) - rounds`` on."""
    jf = jfed.FedConfig(**fed_kw, sparsify_backend="kernel")
    tf = FedConfig(**{k: (adam.AdamHyper(lr=v.lr) if k == "adam" else v)
                      for k, v in fed_kw.items()},
                   sparsify_backend="kernel")
    jround = jax.jit(jfed.make_fl_round(jf, loss_j))
    tround = make_fl_round(tf, loss_t)
    js = jfed.fed_init(jf, to_jax(params_np))
    ts = fed_init(tf, to_torch(params_np))
    first = 0
    if start is not None:
        js0, ts0 = start
        js = jfed.fed_init(jf, js0.W)._replace(M=js0.M, V=js0.V)
        ts = fed_init(tf, ts0.W)._replace(M=ts0.M, V=ts0.V)
        first = len(batches_np) - rounds
    out = []
    for r in range(first, first + rounds):
        jb, tb = to_jax(batches_np[r]), to_torch(batches_np[r])
        jw = None if weights is None else jnp.asarray(weights[r])
        tw = None if weights is None else torch.from_numpy(weights[r])
        js, jm = jround(js, jb, jw)
        ts, tm = tround(ts, tb, tw)
        out.append((js, jm, ts, tm))
    return out


def _assert_close(a, b, rtol, atol, max_mismatch, what):
    """At most ``max_mismatch`` of the elements of ``a`` outside ``rtol``
    and the absolute ``atol``."""
    a, b = np.asarray(a), np.asarray(b)
    bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
    assert bad.mean() <= max_mismatch, (what, int(bad.sum()), bad.size)


def _assert_round_close(out, rtol, atol, max_mismatch):
    """Per round: uplink bits exactly equal; loss and W/M/V close.  At
    most ``max_mismatch`` of the elements may fall outside the tolerance:
    an element that sits on a segment's tau within the ulps that separate
    the two packages (jitted XLA fuses Adam's and the refine candidates'
    multiply-adds) is kept by one and masked by the other."""
    for r, (js, jm, ts, tm) in enumerate(out):
        assert float(tm["uplink_bits"]) == float(jm["uplink_bits"]), r
        np.testing.assert_allclose(tm["loss"].numpy(),
                                   np.asarray(jm["loss"]), rtol=1e-5,
                                   err_msg=f"round {r} loss")
        for name in "WMV":
            for k, a in getattr(ts, name).items():
                b = np.asarray(getattr(js, name)[k])
                a = a.numpy()
                bad = ~np.isclose(a, b, rtol=rtol,
                                  atol=atol * float(np.abs(b).max()))
                assert bad.mean() <= max_mismatch, \
                    (r, name, k, int(bad.sum()), bad.size)


def test_round_matches_jitted_jax_on_readme_loss(jax_packed_oracles):
    C, d = 8, 4096
    rng = np.random.default_rng(7)
    batches = [rng.standard_normal((C, d)).astype(np.float32)
               for _ in range(3)]
    loss_j = lambda p, b: jnp.mean((p["w"] - b) ** 2)
    loss_t = lambda p, b: ((p["w"] - b) ** 2).mean()
    fed_kw = dict(algorithm="fedadam_ssm", alpha=0.05, n_clients=C,
                  local_epochs=3, exact_topk=False, error_feedback=True,
                  adam=jadam.AdamHyper(lr=1e-3))
    out = _run_both(fed_kw, {"w": np.zeros(d, np.float32)}, batches,
                    loss_j, loss_t)
    _assert_round_close(out, rtol=1e-5, atol=1e-5, max_mismatch=2e-3)
    sizes = (d,)
    from repro_torch.core import wire
    assert float(out[0][3]["uplink_bits"]) == \
        C * wire.mask_wire_bits(sizes, 0.05, exact_topk=False)


def _cnn_setup(rounds=3):
    """The width-0.25 CNN in both packages, 3 clients with Dirichlet 0.1
    label skew, ``rounds`` rounds of batches and FedAvg weights."""
    C, B = 3, 8
    jparams, _, jloss, _, ds = jvision.build_vision("cnn", width=0.25)
    params_np = {k: np.asarray(v) for k, v in jparams.items()}
    _, _, tloss, _, _ = vision.build_vision("cnn", width=0.25, device="cpu")
    imgs, labels = synthetic_image_dataset(ds, 256, seed=1)
    parts = dirichlet_partition(labels, n_clients=C, theta=0.1, seed=1)
    batches, weights = [], []
    for r in range(rounds):
        (bx, by), w = client_batches([imgs, labels], parts, B, seed=r)
        batches.append((bx, by))
        weights.append(w)
    return C, params_np, batches, weights, jloss, tloss


def _cnn_rounds_match_jitted_jax(algorithm, **fed_over):
    """3 rounds of the width-0.25 CNN, 3 clients with Dirichlet 0.1 label
    skew, error feedback, threshold masks (unless ``fed_over`` says
    otherwise), in both packages."""
    C, params_np, batches, weights, jloss, tloss = _cnn_setup()
    fed_kw = dict(algorithm=algorithm, alpha=0.05, n_clients=C,
                  local_epochs=2, exact_topk=False, error_feedback=True,
                  adam=jadam.AdamHyper(lr=1e-3))
    fed_kw.update(fed_over)
    out = _run_both(fed_kw, params_np, batches, jloss, tloss,
                    weights=weights)
    _assert_round_close(out, rtol=1e-4, atol=1e-5, max_mismatch=2e-3)
    js, _, ts, _ = out[-1]
    if ts.client_state is None or algorithm == "efficient_adam":
        return out
    err_t = ts.client_state["comp"]["err"]
    err_j = js.client_state["comp"]["err"]
    for k in err_t:
        # kept positions have a zero residual: the supports agree except
        # for elements on the tau boundary
        kept_t = err_t[k].numpy() == 0
        kept_j = np.asarray(err_j[k]) == 0
        assert np.mean(kept_t != kept_j) <= 2e-3, k
    return out


def test_round_matches_jitted_jax_on_cnn(jax_packed_oracles):
    _cnn_rounds_match_jitted_jax("fedadam_ssm")


def test_top_round_matches_jitted_jax_on_cnn(jax_packed_oracles):
    """FedAdam-Top: the packed independent compress (3L tau segments) and
    the three-bitmap wire, to the FedAdam-SSM round's tolerances; its
    uplink is the independent layout's (3 bitmaps, 3 streams)."""
    out = _cnn_rounds_match_jitted_jax("fedadam_top")
    from repro_torch.core import wire
    sizes = tuple(x.numel() for x in out[0][2].W.values())
    assert float(out[0][3]["uplink_bits"]) == float(np.float32(
        3 * wire.mask_wire_bits(sizes, 0.05, exact_topk=False,
                                shared=False)))


def test_exact_topk_round_matches_jitted_jax_on_cnn():
    """FedAdam-SSM with exact masks (``FedConfig``'s default): the
    per-tensor top-k by a stable sort, ties kept at the lower index as
    ``lax.top_k`` keeps them."""
    out = _cnn_rounds_match_jitted_jax("fedadam_ssm", exact_topk=True)
    from repro_torch.core import wire
    sizes = tuple(x.numel() for x in out[0][2].W.values())
    assert float(out[0][3]["uplink_bits"]) == float(np.float32(
        3 * wire.mask_wire_bits(sizes, 0.05, exact_topk=True)))


@pytest.mark.parametrize("algorithm,over", [
    ("ssm_m", {}), ("ssm_v", {}), ("fairness_top", {}),
    ("fairness_top", {"exact_topk": True}),
    ("fedadam_ssm", {"mask_scope": "global"}),
    ("fedadam_top", {"mask_scope": "global"})])
def test_mask_rules_and_scopes_match_jitted_jax_on_cnn(
        jax_packed_oracles, algorithm, over):
    """The shared-mask rules beside ``ssm_w`` (``ssm_m``, ``ssm_v``,
    ``fairness_top`` with threshold and exact masks) and the ``global``
    mask scope (FedAdam-SSM, FedAdam-Top): 3 rounds of the width-0.25 CNN
    against JAX's jitted round, to the FedAdam-SSM round's tolerances.
    These are the whole-leaf baselines of the split leaves' masks."""
    _cnn_rounds_match_jitted_jax(algorithm, **over)


@pytest.mark.parametrize("algorithm,n_tensors", [("fedadam", 3),
                                                 ("fedsgd", 1)])
def test_dense_rounds_match_jitted_jax_on_cnn(algorithm, n_tensors):
    """Dense FedAdam (the whole triple) and FedSGD (W only, local SGD,
    the server advances W alone): no wire round trip, uplink the dense
    planes' bytes."""
    out = _cnn_rounds_match_jitted_jax(algorithm, alpha=1.0)
    from repro_torch.core import wire
    js, _, ts, tm = out[-1]
    sizes = tuple(x.numel() for x in ts.W.values())
    assert float(tm["uplink_bits"]) == float(np.float32(
        3 * wire.dense_wire_bits(sizes, n_tensors)))
    assert ts.client_state is None
    if algorithm == "fedsgd":
        for name in "MV":
            assert not any(bool(x.any()) for x in getattr(ts, name).values())


def test_efficient_adam_rounds_match_jitted_jax_on_cnn():
    """Efficient-Adam (8-bit codes of dW with error feedback, each
    client's persistent local moments): the EF residuals and the moments
    agree within the round's tolerances.  A residual and the quantized dW
    sum to dW, so the residual carries dW's absolute error (a few ulps of
    W): it is held to W's absolute tolerance, 1e-5 of the leaf's largest
    |W|; a code that flips where those ulps cross a half step moves it by
    a whole step, and such elements count against the 0.2%."""
    out = _cnn_rounds_match_jitted_jax("efficient_adam", alpha=1.0)
    from repro_torch.core import wire
    js, _, ts, tm = out[-1]
    sizes = tuple(x.numel() for x in ts.W.values())
    assert float(tm["uplink_bits"]) == float(np.float32(
        3 * wire.bbit_wire_bits(sizes, 8)))
    assert sorted(ts.client_state) == sorted(js.client_state) == \
        ["comp", "m", "v"]
    for k in ts.W:
        for part in ("m", "v"):
            b = np.asarray(js.client_state[part][k])
            _assert_close(ts.client_state[part][k].numpy(), b, 1e-4,
                          1e-5 * float(np.abs(b).max()), 2e-3,
                          f"{part}[{k}]")
        _assert_close(ts.client_state["comp"]["err"][k].numpy(),
                      js.client_state["comp"]["err"][k], 1e-4,
                      1e-5 * float(np.abs(np.asarray(js.W[k])).max()),
                      2e-3, f"err[{k}]")


def test_onebit_adam_two_phase_matches_jitted_jax_on_cnn():
    """1-bit Adam as the paper's runner drives it: 2 dense FedAdam warm-up
    rounds fill V, then 2 compressed rounds (one momentum step, the sign
    plane of dM with error feedback, W by the step preconditioned with the
    frozen V) start from the warm-up's W, M and V.  The residual of dM is
    held to M's absolute tolerance, as Efficient-Adam's is to W's."""
    C, params_np, batches, weights, jloss, tloss = _cnn_setup(rounds=4)
    kw = dict(alpha=1.0, n_clients=C, local_epochs=2,
              adam=jadam.AdamHyper(lr=1e-3))
    warm = _run_both(dict(kw, algorithm="fedadam"), params_np, batches[:2],
                     jloss, tloss, rounds=2, weights=weights[:2])
    _assert_round_close(warm, rtol=1e-4, atol=1e-5, max_mismatch=2e-3)
    js, _, ts, _ = warm[-1]
    out = _run_both(dict(kw, algorithm="onebit_adam"), params_np, batches,
                    jloss, tloss, rounds=2, weights=weights,
                    start=(js, ts))
    _assert_round_close(out, rtol=1e-4, atol=1e-5, max_mismatch=2e-3)
    from repro_torch.core import wire
    js, _, ts, tm = out[-1]
    sizes = tuple(x.numel() for x in ts.W.values())
    assert float(tm["uplink_bits"]) == float(np.float32(
        3 * wire.sign_wire_bits(sizes)))
    for k in ts.W:
        # V stays frozen at the warm-up's, bitwise in each package
        assert torch.equal(ts.V[k], warm[-1][2].V[k])
        _assert_close(ts.client_state["comp"]["err"][k].numpy(),
                      js.client_state["comp"]["err"][k], 1e-4,
                      1e-5 * float(np.abs(np.asarray(js.M[k])).max()),
                      2e-3, f"err[{k}]")


# ---------------------------------------------------------------------------
# The server's precond_m rule and SGD against eager JAX
# ---------------------------------------------------------------------------


def test_precond_m_bitwise_vs_eager_jax():
    """1-bit Adam's server step ``W - lr * M' / sqrt(V + eps)`` with the
    root correctly rounded (PyTorch's vectorised CPU sqrt is not)."""
    rng = np.random.default_rng(11)
    shapes = {"a": (65_536,), "b": (37, 5)}
    mk = lambda scale, pos=False: {
        k: (np.abs(x) if pos else x) for k, x in
        ((k, (rng.standard_normal(s) * scale).astype(np.float32))
         for k, s in shapes.items())}
    # W far below the step, so that an ulp of the root shows in W'
    W, M, aM = mk(1e-6), mk(1e-3), mk(1e-3)
    V = mk(1e-4, pos=True)
    zero = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    wsum = np.float32(3.0)
    jf = jfed.FedConfig(algorithm="onebit_adam",
                        adam=jadam.AdamHyper(lr=1e-2))
    tf = FedConfig(algorithm="onebit_adam", adam=adam.AdamHyper(lr=1e-2))
    args = (W, M, V, zero, aM, zero)
    ref = jfed.make_server_apply(jf)(*map(to_jax, args), jnp.asarray(wsum))
    out = make_server_apply(tf)(*map(to_torch, args), torch.tensor(wsum))
    for name, a, b in zip("WMV", out, ref):
        for k in shapes:
            assert_bitwise(a[k], np.asarray(b[k]), f"{name}[{k}]")


def test_sgd_step_bitwise_vs_eager_jax():
    """FedSGD's local step, on a float32 and a bfloat16 leaf."""
    rng = np.random.default_rng(12)
    p, g = ({"w": rng.standard_normal(10_000).astype(np.float32)}
            for _ in range(2))
    ref, _ = jadam.sgd_step(to_jax(p), to_jax(g), 0.05)
    out = adam.sgd_step(to_torch(p), to_torch(g), 0.05)
    assert_bitwise(out["w"], np.asarray(ref["w"]), "params")
    pb = {"w": to_torch(p)["w"].to(torch.bfloat16)}
    ref, _ = jadam.sgd_step({"w": jnp.asarray(p["w"], jnp.bfloat16)},
                            to_jax(g), 0.05)
    out = adam.sgd_step(pb, to_torch(g), 0.05)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), torch.from_numpy(
        np.asarray(ref["w"]).view(np.int16)))


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} "
                               f"{name}")
    assert len(_port_files()) > 20
    assert not bad, bad


def test_tree_ops_leave_no_reference_cycles():
    """Flattening a tree must not keep its tensors alive: with the cyclic
    collector off, a tree_map's inputs are freed as soon as the caller
    drops them (a self-recursive nested walk once held them until the
    collector ran, so a round's peak memory moved with its timing)."""
    import gc
    import weakref
    from repro_torch import tree as T
    x = torch.zeros(1000)
    alive = weakref.ref(x)
    gc.collect()
    gc.disable()
    try:
        out = T.tree_map(lambda a: a + 1,
                         {"a": x, "b": (torch.ones(3), None)})
        assert float(out["a"][0]) == 1.0 and out["b"][1] is None
        leaves, td = T.flatten(out)
        assert td.unflatten(leaves)["b"][1] is None
        del x, out, leaves, td
        assert alive() is None
    finally:
        gc.enable()


def test_entry_points_need_a_card_or_device_cpu(monkeypatch):
    from repro_torch import quickstart
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vision.build_vision("cnn", width=0.25)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vision.params_from_jax({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main(["--rounds", "1"])
    params, *_ = vision.build_vision("cnn", width=0.25, device="cpu")
    assert all(x.device.type == "cpu" for x in params.values())


def _model_axis_mesh():
    """A client group's view with a model axis of 2 (no process group is
    needed to refuse it)."""
    from repro_torch.launch.mesh import ClientMesh
    return ClientMesh(shape={"data": 1, "model": 2}, client_axes=("data",),
                      rank=0, device=torch.device("cpu"))


def _unknown_axis_mesh():
    """A mesh with an axis beyond the client axes and "model" (the FSDP
    plans' sharding of the leaves over another axis)."""
    from repro_torch.launch.mesh import ClientMesh
    return ClientMesh(shape={"data": 1, "expert": 2}, client_axes=("data",),
                      rank=0, device=torch.device("cpu"))


def _fsdp_mesh():
    """A virtual-client mesh view (no client axes) whose data axis splits
    the leaves (no process group is needed to refuse it)."""
    from repro_torch.launch.mesh import ClientMesh
    return ClientMesh(shape={"data": 2, "model": 1}, client_axes=(),
                      rank=0, device=torch.device("cpu"))


def _serve_on_unknown_axis(loss):
    """A serve step on a serving mesh with an axis beyond "model" and the
    data[, pod] axes that split its batch (and the 2-D leaves)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import ClientMesh
    mesh = ClientMesh(shape={"data": 1, "expert": 2, "model": 1},
                      client_axes=(), rank=0, device=torch.device("cpu"))
    return steps.build_serve_step(
        reduce_for_smoke(get_config("starcoder2-3b")), mesh,
        steps.SHAPES["decode_32k"])


def _train_step_of_plan(mesh, clients, train_params):
    """``build_train_step`` of the smoke starcoder2-3b under a plan pair
    that no plan of the zoo uses."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch import steps
    from repro_torch.sharding import DeployPlan
    return steps.build_train_step(
        reduce_for_smoke(get_config("starcoder2-3b")), mesh,
        steps.SHAPES["train_4k"],
        plan=DeployPlan(clients=clients, train_params=train_params))


_SPATIAL = FedConfig(client_mode="vmap", client_axes=("data",),
                     n_clients=1)
_REMAINDER = r"§1\.10\(b\) remainder"


@pytest.mark.parametrize("build,what", [
    (lambda loss: make_fl_round(_SPATIAL, loss, mesh=_unknown_axis_mesh()),
     _REMAINDER),
    (lambda loss: _train_step_of_plan(_model_axis_mesh(), "spatial",
                                      "fsdp"), _REMAINDER),
    (lambda loss: _train_step_of_plan(_fsdp_mesh(), "virtual", "tp"),
     _REMAINDER),
    (_serve_on_unknown_axis, _REMAINDER),
])
def test_round_outside_the_slice_raises(build, what):
    """What stays outside the port raises naming its ROADMAP item, all
    §1.10(b)'s remainder: a mesh axis beyond the client axes, "model" and
    a virtual mesh's FSDP axes, the spatial/fsdp and virtual/tp train
    plan pairs (no plan of the zoo uses them), and a serve step on a mesh
    with such an axis.  The spatial round on a model axis, the virtual
    clients' FSDP round with every compressor, the async driver on both
    (tests/test_torch_async_split.py) and the sharded prefill and serve
    steps themselves run (tests/test_torch_tensor.py,
    tests/test_torch_fsdp.py, tests/test_torch_serve_mesh.py, and
    :func:`test_quantized_step_runs_on_fsdp_leaves`)."""
    with pytest.raises(NotImplementedError, match=what):
        build(lambda p, b: p["w"].sum())


@pytest.mark.parametrize("masks", [dict(exact_topk=True),
                                   dict(mask_scope="global")])
def test_exact_or_global_masks_refuse_the_bitmap_transport(masks):
    """On a model axis the per-shard bitmap transport keeps alpha of each
    shard, so ``build_train_step`` refuses exact or global masks with it
    (the default for a sparse compressor) and names the dense fold."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch import steps
    with pytest.raises(ValueError, match="aggregate='dense'"):
        steps.build_train_step(
            reduce_for_smoke(get_config("starcoder2-3b")), _model_axis_mesh(),
            steps.SHAPES["train_4k"], algorithm="fedadam_ssm", **masks)


def test_quantized_step_runs_on_fsdp_leaves():
    """Efficient-Adam's step on FSDP leaves (mistral-large-123b's smoke
    config, the virtual/fsdp plan on a (data 2) view, its peer standing
    in: ``launch.mesh.stand_in``) builds and runs one round: the 8-bit
    codes' block scales reduced over the data group, the residuals and
    the persistent moments this rank's shards, the state finite, and the
    bill the whole leaves' (JAX's: 7,434,432 bits for 2 virtual clients,
    tests/test_torch_fsdp.py)."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch import mesh as MM
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import params as PM
    from repro_torch.sharding import DeployPlan
    cfg = reduce_for_smoke(get_config("mistral-large-123b"))
    mesh = _fsdp_mesh()
    shape = dataclasses.replace(steps.SHAPES["train_4k"], seq_len=32,
                                global_batch=2)
    bundle = steps.build_train_step(
        cfg, mesh, shape, algorithm="efficient_adam", local_epochs=1,
        error_feedback=True,
        plan=DeployPlan(clients="virtual", train_params="fsdp",
                        n_virtual=2))
    specs = bundle.static["pspecs"]
    params = PM.materialize_shards(M.abstract_params(cfg), specs, mesh, 0,
                                   cfg.dtype)
    torch.manual_seed(0)
    MM.reset_collectives()
    with MM.stand_in(bounded=True):
        state, batch = bundle.args(params, torch.device("cpu"))
        new, mets = bundle.fn(state, batch)
    assert float(mets["uplink_bits"]) == 7_434_432
    assert "data/all_reduce" in {f"{g}/{k}" for k, g in MM.COLLECTIVES}
    for x, p in zip(T.leaves(new.client_state["comp"]["err"]),
                    T.leaves(params)):
        assert tuple(x.shape) == (2,) + tuple(p.shape)
    assert all(bool(torch.isfinite(x.float()).all())
               for x in T.leaves((new.W, new.client_state)))


def test_port_registers_every_jax_algorithm():
    """Every algorithm the JAX package registers, in its order; an unknown
    name raises KeyError."""
    from repro.core import compressors as jcompressors
    from repro_torch.core import compressors
    assert compressors.available() == jcompressors.available()
    for name in compressors.available():
        assert FedConfig(algorithm=name).algorithm == name
        assert compressors.transport_of(name) == \
            jcompressors.transport_of(name)
    with pytest.raises(KeyError):
        FedConfig(algorithm="no_such_algorithm")


def test_quickstart_runs_on_cpu(capsys):
    from repro_torch import quickstart
    quickstart.main(["--device", "cpu", "--rounds", "1", "--clients", "2",
                     "--width", "0.125"])
    out = capsys.readouterr().out
    assert "round  0 loss=" in out and "device: cpu" in out
    # both halves: FedAdam-SSM, then dense FedAdam
    ssm, dense = out.split("== fedadam_ssm")[1].split("== fedadam (")
    assert "round  0 loss=" in ssm and "round  0 loss=" in dense
