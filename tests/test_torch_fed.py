"""The port's optimizer, models and FL round against the JAX package, and
the port's guards.

* Adam: bitwise against the eager JAX ``_adam_leaf``; against the jitted
  one within an ulp bound (XLA fuses ``b1*m + (1-b1)*g`` into an FMA).
  The fused_adam path is tests/test_torch_perleaf_kernels.py's.
* Vision models: the same weights (carried from JAX through numpy) and
  batch give the same loss and gradients up to float32 summation order.
* The round: 3 rounds with error feedback (FedAdam-SSM, and FedAdam-Top
  on the CNN), the port on the CPU with the kernel backend (its kernels'
  plain versions) against the JAX jitted round on its kernel backend (packed_topk kernels through their jnp
  oracles, see ``_torch_parity.jax_packed_oracles``).  ``uplink_bits``
  is exactly equal; losses and W/M/V agree within stated tolerances.
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
from repro_torch.core import FedConfig, fed_init, make_fl_round
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
              weights=None):
    """Run ``rounds`` rounds in both packages from the same weights and
    batches; returns per-round (jax_state, jax_mets, port_state,
    port_mets)."""
    jf = jfed.FedConfig(**fed_kw, sparsify_backend="kernel")
    tf = FedConfig(**{k: (adam.AdamHyper(lr=v.lr) if k == "adam" else v)
                      for k, v in fed_kw.items()},
                   sparsify_backend="kernel")
    jround = jax.jit(jfed.make_fl_round(jf, loss_j))
    tround = make_fl_round(tf, loss_t)
    js = jfed.fed_init(jf, to_jax(params_np))
    ts = fed_init(tf, to_torch(params_np))
    out = []
    for r in range(rounds):
        jb, tb = to_jax(batches_np[r]), to_torch(batches_np[r])
        jw = None if weights is None else jnp.asarray(weights[r])
        tw = None if weights is None else torch.from_numpy(weights[r])
        js, jm = jround(js, jb, jw)
        ts, tm = tround(ts, tb, tw)
        out.append((js, jm, ts, tm))
    return out


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


def _cnn_rounds_match_jitted_jax(algorithm):
    """3 rounds of the width-0.25 CNN, 3 clients with Dirichlet 0.1 label
    skew, error feedback, threshold masks, in both packages."""
    C, B = 3, 8
    jparams, _, jloss, _, ds = jvision.build_vision("cnn", width=0.25)
    params_np = {k: np.asarray(v) for k, v in jparams.items()}
    _, _, tloss, _, _ = vision.build_vision("cnn", width=0.25, device="cpu")
    imgs, labels = synthetic_image_dataset(ds, 256, seed=1)
    parts = dirichlet_partition(labels, n_clients=C, theta=0.1, seed=1)
    batches, weights = [], []
    for r in range(3):
        (bx, by), w = client_batches([imgs, labels], parts, B, seed=r)
        batches.append((bx, by))
        weights.append(w)
    fed_kw = dict(algorithm=algorithm, alpha=0.05, n_clients=C,
                  local_epochs=2, exact_topk=False, error_feedback=True,
                  adam=jadam.AdamHyper(lr=1e-3))
    out = _run_both(fed_kw, params_np, batches, jloss, tloss,
                    weights=weights)
    _assert_round_close(out, rtol=1e-4, atol=1e-5, max_mismatch=2e-3)
    js, _, ts, _ = out[-1]
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


@pytest.mark.parametrize("kw,what", [
    (dict(client_mode="vmap"), "§1.9"),
    (dict(participation=0.5), "§1.6"),
    (dict(client_mode="shard_map"), "§1.10"),
])
def test_round_outside_the_slice_raises(kw, what):
    fed = FedConfig(**kw)
    with pytest.raises(NotImplementedError, match=what):
        make_fl_round(fed, lambda p, b: p["w"].sum())


def test_algorithms_outside_the_port_raise():
    from repro_torch.core import compressors
    with pytest.raises(NotImplementedError, match="ROADMAP §1.8"):
        FedConfig(algorithm="fedadam")
    assert "fedadam_top" not in compressors.NOT_PORTED
    assert FedConfig(algorithm="fedadam_top").algorithm == "fedadam_top"
    with pytest.raises(KeyError):
        FedConfig(algorithm="no_such_algorithm")


def test_quickstart_runs_on_cpu(capsys):
    from repro_torch import quickstart
    quickstart.main(["--device", "cpu", "--rounds", "1", "--clients", "2",
                     "--width", "0.125"])
    out = capsys.readouterr().out
    assert "round  0 loss=" in out and "device: cpu" in out
