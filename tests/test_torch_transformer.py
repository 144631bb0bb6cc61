"""The port's transformer path against the JAX package: the starcoder2-3b
config, its parameter tree, ``loss_fn`` and its gradients, two FL rounds of
each slice (FedAdam-SSM and FedAdam-Top, error feedback, threshold masks,
fused Adam, kernel backend) in bfloat16 with float32 norm scales, and the
trainer CLI.

Weights cross from JAX as numpy arrays, bfloat16 as its bits, so both
sides start from the same values.  Tolerances are stated where they are
used, each with its reason.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import leaf_to_torch, np_bits_tree
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core import fed as jfed
from repro.launch import train as jtrain
from repro.models import model as JM
from repro.optim import adam as jadam
from repro_torch import tree as T
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import FedConfig, fed_init, make_fl_round
from repro_torch.core import wire
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.launch import train
from repro_torch.models import model as TM
from repro_torch.models.params import count_params
from repro_torch.optim import AdamHyper

#: Leaf sizes of starcoder2-3b at full width with 2 pattern repeats, in the
#: tree's flatten order (w_down, w_up, wk, wo, wq, wv, the two block norms,
#: embed, final_norm, lm_head).
FULL_WIDTH_SIZES = (75_497_472, 75_497_472, 1_572_864, 18_874_368,
                    18_874_368, 1_572_864, 6_144, 6_144, 150_994_944,
                    3_072, 150_994_944)


def _with_mlp(cfg, dtype, gated):
    pattern = tuple(dataclasses.replace(s, gated_mlp=gated)
                    for s in cfg.layer_pattern)
    return dataclasses.replace(cfg, dtype=dtype, layer_pattern=pattern)


def _configs(dtype="bfloat16", gated=False):
    """The smoke starcoder2 of both packages.  ``reduce_for_smoke`` rebuilds
    each layer with the default gated MLP; ``gated=False`` puts back
    starcoder2's tanh-GELU MLP, the one the full-width path runs (11
    leaves)."""
    return (_with_mlp(jreduce(jget_config("starcoder2-3b")), dtype, gated),
            _with_mlp(reduce_for_smoke(get_config("starcoder2-3b")), dtype,
                      gated))


# ---------------------------------------------------------------------------
# Config and parameter tree
# ---------------------------------------------------------------------------


def test_config_is_the_jax_packages():
    """The port registers every architecture of the JAX package's zoo,
    each the JAX package's, full and reduced; no name of the zoo
    raises."""
    from repro.configs import available_archs as javailable
    from repro_torch.configs import available_archs
    assert set(available_archs()) == set(javailable())
    for name in available_archs():
        for full in (True, False):
            j, t = jget_config(name), get_config(name)
            if not full:
                j, t = jreduce(j), reduce_for_smoke(t)
            assert dataclasses.asdict(t) == dataclasses.asdict(j), name
            assert t.padded_vocab == j.padded_vocab
            assert t.param_count() == j.param_count()
            assert t.active_param_count() == j.active_param_count()
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_full_width_tree_matches_jax_at_two_repeats():
    j = dataclasses.replace(jget_config("starcoder2-3b"), pattern_repeats=2)
    t = dataclasses.replace(get_config("starcoder2-3b"), pattern_repeats=2)
    jl = jax.tree_util.tree_leaves(JM.abstract_params_sds(j))
    tl = T.leaves(TM.abstract_params(t))
    assert [p.shape for p in tl] == [x.shape for x in jl]
    assert [p.dtype or t.dtype for p in tl] == [x.dtype.name for x in jl]
    assert tuple(int(np.prod(p.shape)) for p in tl) == FULL_WIDTH_SIZES
    assert count_params(TM.abstract_params(t)) == 493_894_656
    # the slice's wire: 375,854,948 bytes per client (alpha 0.05,
    # per-tensor threshold masks)
    assert wire.mask_wire_bits(FULL_WIDTH_SIZES, 0.05,
                               exact_topk=False) == 8 * 375_854_948
    # FedAdam-Top's: three (bitmap, stream) pairs, 499,328,868 bytes
    assert wire.mask_wire_bits(FULL_WIDTH_SIZES, 0.05, exact_topk=False,
                               shared=False) == 8 * 499_328_868


def test_smoke_init_has_the_jax_layout():
    _, tcfg = _configs()
    p = TM.init_params(tcfg, seed=0, device="cpu")
    assert sorted(p) == ["blocks", "embed", "final_norm", "lm_head"]
    assert isinstance(p["blocks"], tuple) and len(p["blocks"]) == 1
    assert len(T.leaves(p)) == len(FULL_WIDTH_SIZES)
    blk = p["blocks"][0]
    assert sorted(blk["ffn"]) == ["w_down", "w_up"]
    assert tuple(blk["mixer"]["wq"].shape) == (2, 1, 128, 4, 32)
    assert blk["mixer"]["wq"].dtype == torch.bfloat16
    assert blk["norm_ffn"]["scale"].dtype == torch.float32
    assert bool((blk["norm_ffn"]["scale"] == 1).all())
    # remat runs, and changes no bit of the forward
    toks = torch.zeros((1, 4), dtype=torch.int32)
    full, none = (TM.forward(tcfg, p, toks, remat=r) for r in ("full",
                                                             "none"))
    assert all(torch.equal(a, b) for a, b in zip(full, none))


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------


def _loss_and_grads(dtype, gated, seq=64):
    jcfg, tcfg = _configs(dtype, gated)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.params_from_jax(np_bits_tree(jp), tcfg, "cpu")
    for a, b in zip(T.leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert a.dtype == getattr(torch, b.dtype.name)
    toks = np.random.default_rng(0).integers(0, 512, (2, seq)) \
        .astype(np.int32)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, t: JM.loss_fn(jcfg, p, t, remat="none")))(
            jp, jnp.asarray(toks))
    leaves, td = T.flatten(tp)
    req = [x.clone().requires_grad_(True) for x in leaves]
    loss = TM.loss_fn(tcfg, td.unflatten(req), torch.from_numpy(toks),
                      remat="none")
    loss.backward()
    grads = [(x.grad.float().numpy(), np.asarray(g).astype(np.float32))
             for x, g in zip(req, jax.tree_util.tree_leaves(jg))]
    return float(loss.detach()), float(jl), grads


#: starcoder2's tanh-GELU MLP (the main path's) and the gated MLP that the
#: CLI's ``--smoke`` runs
MLPS = pytest.mark.parametrize("gated", [False, True],
                               ids=["gelu", "gated"])


@MLPS
def test_loss_and_grads_match_jax_in_float32(gated):
    """The algorithm: same float32 math, other summation orders in the
    matrix products and reductions (measured: loss within 2.1e-7 relative,
    gradients within 1.8e-6 of each leaf's largest)."""
    loss, jl, grads = _loss_and_grads("float32", gated)
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    for a, b in grads:
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()))


@MLPS
def test_loss_and_grads_match_jax_in_bfloat16(gated):
    """bfloat16 matrices, float32 norm scales.  bfloat16 keeps 8 bits, so
    each rounding is up to 2^-9 relative and the two frameworks round at
    other places (PyTorch's CPU GELU and matrix products round once from
    float32; XLA rounds the tanh GELU op by op): loss within 1e-3
    relative (measured 1.8e-4 GELU, 6e-5 gated), every gradient element
    within 4e-2 of its leaf's largest (measured at most 1.3e-2 GELU,
    1.8e-2 gated)."""
    loss, jl, grads = _loss_and_grads("bfloat16", gated)
    np.testing.assert_allclose(loss, jl, rtol=1e-3)
    for a, b in grads:
        assert np.abs(a - b).max() <= 4e-2 * np.abs(b).max()


# ---------------------------------------------------------------------------
# Two rounds of the slice
# ---------------------------------------------------------------------------

ROUNDS, CLIENTS, SEQ = 2, 4, 64


def _two_rounds(algorithm):
    """Both packages' rounds from the same weights and batches: the port on
    the CPU (the kernels' plain versions) against JAX's jitted round (its
    Pallas kernels in interpret mode)."""
    jcfg, tcfg = _configs()
    fed_kw = dict(algorithm=algorithm, alpha=0.05, n_clients=CLIENTS,
                  local_epochs=3, exact_topk=False, error_feedback=True,
                  use_kernel_adam=True, sparsify_backend="kernel")
    jf = jfed.FedConfig(**fed_kw, adam=jadam.AdamHyper(lr=1e-3))
    tf = FedConfig(**fed_kw, adam=AdamHyper(lr=1e-3))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.params_from_jax(np_bits_tree(jp), tcfg, "cpu")
    jround = jax.jit(jfed.make_fl_round(
        jf, lambda p, b: JM.loss_fn(jcfg, p, b["tokens"], remat="none")))
    tround = make_fl_round(
        tf, lambda p, b: TM.loss_fn(tcfg, p, b["tokens"], remat="none"))
    js, ts = jfed.fed_init(jf, jp), fed_init(tf, tp)
    reset_launches()
    out = []
    for r in range(ROUNDS):
        jb = jtrain.build_client_batches(jcfg, CLIENTS, 2, SEQ, seed=r)
        tb = train.build_client_batches(tcfg, CLIENTS, 2, SEQ, seed=r,
                                        device="cpu")
        assert np.array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))
        js, jm = jround(js, jb)
        ts, tm = tround(ts, tb)
        out.append((js, jm, ts, tm))
    return out, dict(LAUNCHES)


@pytest.fixture(scope="module")
def two_rounds():
    return _two_rounds("fedadam_ssm")


@pytest.fixture(scope="module")
def two_top_rounds():
    """FedAdam-Top: the mixed tree takes the per-leaf threshold masks
    (topk_mask per leaf and delta) and the three-bitmap wire.

    JAX's round takes each mask from ``topk_mask_ref``, the jnp oracle of
    ``topk_mask_kernel`` (the same two-level selection; its integer counts
    equal the kernel's float32 ones below 2^24), which gives the jitted
    round bitwise the same state: the Pallas kernels in interpret mode
    would add one lowering per leaf and delta, about 30 s of XLA compile
    on a CPU.  ``tests/test_torch_perleaf_kernels.py`` holds the port's
    ``topk_mask`` and ``apply_mask`` bitwise against the Pallas kernels
    themselves."""
    import repro.core.sparsify as JS
    from repro.kernels.topk_mask.ref import topk_mask_ref
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "topk_mask_kernel",
                   lambda x, k: (topk_mask_ref(x, k), None, None))
        return _two_rounds("fedadam_top")


def test_round_runs_no_kernel_on_the_cpu(two_rounds):
    assert all(v == 0 for v in two_rounds[1].values())


def _assert_uplink_exact(rounds, shared):
    for js, jm, ts, tm in rounds:
        assert float(tm["uplink_bits"]) == float(jm["uplink_bits"])
    sizes = tuple(x.numel() for x in T.leaves(ts.W))
    assert float(tm["uplink_bits"]) == float(np.float32(
        CLIENTS * wire.mask_wire_bits(sizes, 0.05, exact_topk=False,
                                      shared=shared)))


def test_round_uplink_bits_are_exact(two_rounds):
    _assert_uplink_exact(two_rounds[0], shared=True)


def test_top_round_uplink_bits_are_exact(two_top_rounds):
    _assert_uplink_exact(two_top_rounds[0], shared=False)
    assert all(v == 0 for v in two_top_rounds[1].values())


def test_round_matches_jitted_jax(two_rounds):
    """Loss, masks and W/M/V of the bfloat16 round.

    The gradients differ by bfloat16 roundings (see the loss test) and the
    jitted round fuses Adam's multiply-adds, so the deltas differ in their
    last bits.  A bfloat16 delta is a few ulps of its weight, so many
    elements tie near a leaf's tau and one ulp moves them across: an
    element is then kept by one package and dropped by the other.
    Tolerances (measured values in brackets):

    * loss within 2e-3 relative [2.5e-4];
    * a client's support (its residual is 0 where kept) differs on at most
      4% of a leaf's elements [1.4%];
    * W within 2 bfloat16 ulps (rtol 2^-7) plus 1e-3 of the leaf's
      largest except at most 3% of a leaf [0.79%], and at most 1% of the
      elements whose support agreed for every client and round [0.22%];
    * M and V, which start from zero so that every flipped element shows:
      on the elements whose support agreed, within rtol 2^-7 plus 4e-2 of
      the leaf's largest (the gradient test's tolerance) except at most
      0.1% [0.068%]."""
    _assert_rounds_close(two_rounds[0], shared=True)


def test_top_round_matches_jitted_jax(two_top_rounds):
    """FedAdam-Top's bfloat16 round, to the bounds of
    :func:`test_round_matches_jitted_jax` where they carry over.  Each
    delta now has its own selection, so the ties at tau that move a
    shared mask move three masks: the dW support (seen through the
    residual) within 4% [1.4%]; W within tolerance except at most 3% of a
    leaf [1.66%] and 1% where the dW supports agreed [0.74%]; the loss
    within 2e-3 relative [2.5e-4].  The M and V supports cannot be read
    from the state, so M and V get W's overall bound: at most 3% of a leaf
    beyond rtol 2^-7 plus 4e-2 of the leaf's largest [1.17% and 1.95%];
    they start from zero, so every element that one package kept and the
    other dropped shows."""
    _assert_rounds_close(two_top_rounds[0], shared=False)


def _assert_rounds_close(rounds, shared):
    agree = None
    for r, (js, jm, ts, tm) in enumerate(rounds):
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   rtol=2e-3, err_msg=f"round {r} loss")
        kept = [(a.float().numpy() == 0, np.asarray(b) == 0) for a, b in
                zip(T.leaves(ts.client_state["comp"]["err"]),
                    jax.tree_util.tree_leaves(
                        js.client_state["comp"]["err"]))]
        for ka, kb in kept:
            assert np.mean(ka != kb) <= 4e-2, (r, ka.shape)
        same = [(ka == kb).all(axis=0) for ka, kb in kept]
        agree = same if agree is None else [x & y for x, y in
                                            zip(agree, same)]
        for name, atol in (("W", 1e-3), ("M", 4e-2), ("V", 4e-2)):
            tl = T.leaves(getattr(ts, name))
            jl = jax.tree_util.tree_leaves(getattr(js, name))
            for a, b, ok in zip(tl, jl, agree):
                assert a.dtype == getattr(torch, b.dtype.name)
                a = a.float().numpy()
                b = np.asarray(b).astype(np.float32)
                bad = ~np.isclose(a, b, rtol=2.0 ** -7,
                                  atol=atol * float(np.abs(b).max()))
                what = (r, name, a.shape)
                if name == "W":
                    assert bad.mean() <= 3e-2, what
                    assert bad[ok].mean() <= 1e-2, what
                elif shared:
                    assert bad[ok].mean() <= 1e-3, what
                else:
                    assert bad.mean() <= 3e-2, what


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_runs_the_slice_on_cpu(capsys, monkeypatch):
    import repro_torch.core.sparsify as S
    calls = []
    monkeypatch.setenv(S.SPARSIFY_BACKEND_ENV, "kernel")
    real = S.select_tau
    monkeypatch.setattr(S, "select_tau",
                        lambda *a: calls.append(1) or real(*a))
    train.main(["--arch", "starcoder2-3b", "--smoke", "--rounds", "1",
                "--device", "cpu", "--kernel-adam", "--threshold-topk",
                "--clients", "2", "--local-epochs", "1", "--seq", "32"])
    out = capsys.readouterr().out
    assert "device: cpu" in out
    line = [x for x in out.splitlines() if x.startswith("[round   0]")][0]
    assert np.isfinite(float(line.split("loss=")[1].split()[0]))
    # the per-leaf path: one selection per leaf and client (12 leaves: the
    # CLI's --smoke is reduce_for_smoke's, which has the gated MLP)
    assert len(calls) == 2 * 12


def test_cli_runs_fedadam_top_on_cpu(capsys, monkeypatch):
    import repro_torch.core.sparsify as S
    calls = []
    monkeypatch.setenv(S.SPARSIFY_BACKEND_ENV, "kernel")
    real = S.topk_mask
    monkeypatch.setattr(S, "topk_mask",
                        lambda *a: calls.append(1) or real(*a))
    train.main(["--arch", "starcoder2-3b", "--smoke", "--rounds", "1",
                "--device", "cpu", "--threshold-topk", "--algorithm",
                "fedadam_top", "--clients", "2", "--local-epochs", "1",
                "--seq", "32"])
    out = capsys.readouterr().out
    assert "algo=fedadam_top (transport=independent_sparse" in out
    line = [x for x in out.splitlines() if x.startswith("[round   0]")][0]
    assert np.isfinite(float(line.split("loss=")[1].split()[0]))
    # three masks per leaf (12 leaves with the gated MLP) and client
    assert len(calls) == 2 * 3 * 12


def test_cli_needs_a_card_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "starcoder2-3b", "--smoke", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(_configs()[1])


def test_params_from_jax_takes_bfloat16_bits():
    jcfg, tcfg = _configs()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = TM.params_from_jax(np_bits_tree(jp), tcfg, "cpu")
    for a, b in zip(T.leaves(tp), jax.tree_util.tree_leaves(jp)):
        ref = leaf_to_torch(np.asarray(b).view(np.uint16)
                            if b.dtype.itemsize == 2 else np.asarray(b))
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, ref.view(torch.int16)
                           if ref.dtype == torch.bfloat16 else ref)
