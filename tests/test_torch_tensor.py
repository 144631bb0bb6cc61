"""The port's tensor parallelism on a model axis (the ``tp`` train plans)
against the JAX package on the CPU, and §1.12(a)'s small gaps.

* As data: ``sharding.param_rules``, ``fsdp_axes``, ``cache_rules``,
  ``models/params.pspecs`` and ``core/fed.client_state_pspecs`` equal
  JAX's (as tuples) for every config on the (2, 2) and (2, 16, 16) mesh
  shapes.
* One spawn of 4 gloo ranks, a (data 2, model 2) group
  (``tests/_torch_tensor_ranks.py``), beside ONE subprocess with 4 host
  devices that runs JAX's side:

  (i) the per-shard bitmap transport (shared, independent, bfloat16
  values, error feedback with and without overflow): bitwise JAX's
  jitted ``make_shardmap_sparse_aggregate`` on the (2, 2) mesh;
  (ii) each tensor-parallel layer's output and gradients (and five
  families' whole loss) within ``LAYER_TOL`` of the port's whole layer;
  (iii) the threshold selection of a split leaf bitwise the whole leaf's;
  (iv) two rounds with error feedback of ``build_train_step`` for
  starcoder2-3b (FedAdam-SSM and -Top) and mamba2-1-3b against JAX's
  jitted step on the (2, 2) mesh, within ``STEP_TOL``, no support
  differing, the bill exactly JAX's; for starcoder2-3b with one local
  epoch, the dense and quantized baselines, exact masks and the global
  scope against JAX's whole-leaf scan round (its jitted tp step fails at
  their dense fold on this jax), ``fairness_top`` against its jitted tp
  step;
  (v) deepseek-v2-lite-16b's split round against the port's whole-leaf
  spatial round (JAX's fails at ``repro/models/layers.py:418`` on this
  jax): equal but where the per-shard capacity dropped values;
  (vi) every compressor's compress on split leaves bitwise the whole
  leaves' (1-bit Adam's scales within 8 ulps).
* ``core/theory.py`` under JAX's own ``tests/test_theory.py`` cases,
  ``repro_torch.core.ALGORITHMS``, and ``forward(long_mode=True)``.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import _torch_tensor_ranks as R
from _torch_parity import bits, np_model_params
from repro import sharding as jshd
from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro_torch import sharding as shd
from repro_torch import tree as T
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import mesh as MM
from repro_torch.models import model as TM
from repro_torch.models import params as PM

_TESTS = Path(__file__).resolve().parent
_REPO = _TESTS.parent
SPAWN_TIMEOUT_S = 300

#: A split layer against the whole one, float32: the largest error of its
#: output and of every gradient, as a share of the whole form's largest
#: element (the partial sums of a split product add in another order;
#: seen up to 2.1e-6).
LAYER_TOL = 1e-5
#: The split round against JAX's jitted step: W, M, V within ``STEP_TOL``
#: of a leaf's largest element, the EF residual within ``ERR_TOL`` (XLA
#: fuses Adam's multiply-adds; seen up to 1.9e-5 and 1.25e-4), and the
#: share of elements whose support (a zero residual) differs at most
#: ``SUPPORT_SHARE`` (seen 0).
STEP_TOL = 1e-4
ERR_TOL = 1e-3
SUPPORT_SHARE = 1e-4


class _Shape:
    """A mesh stand-in for JAX's ``pspecs``: its ``shape`` alone."""

    def __init__(self, shape):
        self.shape = shape


# ---------------------------------------------------------------------------
# The rules and specs as data
# ---------------------------------------------------------------------------

_MESHES = {"test": MM.make_test_mesh(),
           "production_multi_pod": MM.make_production_mesh(multi_pod=True)}


def test_mesh_shapes_are_jax_meshes():
    """The counterparts of ``make_test_mesh`` and ``make_production_mesh``
    as shapes (axes in mesh order, sizes)."""
    assert MM.make_test_mesh() == {"data": 2, "model": 2}
    assert MM.make_test_mesh(multi_pod=True) == \
        {"pod": 2, "data": 2, "model": 2}
    assert MM.make_production_mesh() == {"data": 16, "model": 16}
    assert list(MM.make_production_mesh(multi_pod=True).items()) == \
        [("pod", 2), ("data", 16), ("model", 16)]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_rules_equal_jax(multi_pod):
    assert shd.fsdp_axes(multi_pod) == jshd.fsdp_axes(multi_pod)
    for kind in ("tp", "fsdp"):
        assert shd.param_rules(kind, multi_pod) == \
            jshd.param_rules(kind, multi_pod)
    with pytest.raises(ValueError):
        shd.param_rules("zero3", multi_pod)
    for kind in ("decode", "long"):
        for seq in (None, "model", ("data", "model")):
            assert shd.cache_rules(kind, multi_pod, seq) == \
                jshd.cache_rules(kind, multi_pod, seq)


def _meta_params(meta):
    return T.tree_map(lambda p: torch.empty(p.shape, device="meta"), meta)


@pytest.mark.parametrize("mesh_name", sorted(_MESHES))
def test_pspecs_and_client_state_pspecs_equal_jax(mesh_name):
    """Every config's abstract params under both rule sets: the port's
    specs are JAX's, leaf for leaf, as tuples (kv_heads replicated where
    the axis does not divide them, a mesh axis once per leaf); and the
    client state's (EF residual, local Adam moments) lie like the
    params'."""
    from repro.core import fed as jfed
    from repro.models import model as JM
    from repro.models import params as JP
    from repro_torch.core import FedConfig, fed
    shape = _MESHES[mesh_name]
    multi_pod = "pod" in shape
    caxes = shd.client_axes(multi_pod)
    is_spec = lambda x: isinstance(x, PartitionSpec)
    for name in ASSIGNED_ARCHS:
        for kind in ("tp", "fsdp"):
            rules = shd.param_rules(kind, multi_pod)
            jspec = JP.pspecs(JM.abstract_params(jget_config(name)), rules,
                              _Shape(shape))
            meta = TM.abstract_params(get_config(name))
            tspec = PM.pspecs(meta, rules, shape)
            jl = jax.tree_util.tree_leaves(jspec, is_leaf=is_spec)
            assert [tuple(s) for s in jl] == \
                [tuple(s) for s in T.leaves(tspec)], (name, kind)
        for alg in ("fedadam_ssm", "efficient_adam"):
            fcfg = dict(algorithm=alg, error_feedback=True, n_clients=3)
            jsds = jax.eval_shape(
                lambda p: jfed.fed_init(jfed.FedConfig(**fcfg), p),
                JP.abstract(JM.abstract_params(jget_config(name))))
            jcs = jfed.client_state_pspecs(jsds.client_state, jspec, caxes)
            tcs = fed.client_state_pspecs(
                fed.fed_init(FedConfig(**fcfg), _meta_params(meta))
                .client_state, tspec, caxes)
            assert [tuple(s) for s in jax.tree_util.tree_leaves(
                jcs, is_leaf=is_spec)] == \
                [tuple(s) for s in T.leaves(tcs)], (name, alg)
    assert fed.client_state_pspecs(None, tspec, caxes) is None


# ---------------------------------------------------------------------------
# The spawn: 4 gloo ranks beside one JAX subprocess
# ---------------------------------------------------------------------------

_JAX_SUB = textwrap.dedent("""
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.configs import get_config, reduce_for_smoke
    from repro.core import fed_init, make_fl_round
    from repro.core.aggregate import make_shardmap_sparse_aggregate
    from repro.models import model as JM
    from repro.launch import steps as ST
    from repro.launch.mesh import make_test_mesh
    sys.path.insert(0, sys.argv[1])
    import _torch_tensor_ranks as R

    mesh = make_test_mesh()
    leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
    with open(sys.argv[2], "rb") as f:
        params_np = pickle.load(f)
    out = {"transport": {}, "steps": {}, "params": params_np}
    specs = {k: P(*("model" if d == dim else None
                    for d in range(len(shape))))
             for k, (shape, dim) in R.TRANSPORT_LEAVES.items()}
    for case, kw in R.TRANSPORT_CASES.items():
        car, err, w = R.transport_inputs(case)
        agg = jax.jit(make_shardmap_sparse_aggregate(
            mesh, specs, ("data",), kw["alpha"], shared=kw["shared"],
            value_dtype=kw["value_dtype"]))
        tree = lambda i: {k: jnp.asarray(v[i]) for k, v in car.items()}
        with compat.set_mesh(mesh):
            (aw, am, av), ne = agg(
                tree(0), tree(1), tree(2), jnp.asarray(w),
                {k: jnp.asarray(v) for k, v in err.items()})
        out["transport"][case] = {"sums": [leaves(t) for t in (aw, am, av)],
                                  "err": leaves(ne)}
    def record(state, mets):
        cs = state.client_state
        return dict(W=leaves(state.W), M=leaves(state.M), V=leaves(state.V),
                    err=[] if cs is None else leaves(cs["comp"]["err"]),
                    loss=np.asarray(mets["loss"]),
                    uplink_bits=float(mets["uplink_bits"]),
                    diag={k: np.asarray(v) for k, v in mets.items()
                          if k not in ("loss", "uplink_bits")})

    shape = dataclasses.replace(ST.SHAPES["train_4k"], seq_len=R.SEQ,
                                global_batch=R.BATCH)
    tp_steps = [((name, alg), name, alg, R.LOCAL_EPOCHS)
                for name, alg in R.JAX_STEPS] + \
        [(R.step_key(name, alg, kw), name, alg, R.NEW_EPOCHS)
         for name, alg, kw in R.TP_STEPS]
    for key, name, alg, epochs in tp_steps:
        cfg = dataclasses.replace(reduce_for_smoke(get_config(name)),
                                  dtype="float32")
        bundle = ST.build_train_step(
            cfg, mesh, shape, algorithm=alg, local_epochs=epochs,
            alpha=R.ALPHA, error_feedback=True)
        state = fed_init(bundle.static["fed"],
                         jax.tree.map(jnp.asarray, params_np[name]))
        batch = {"tokens": jnp.asarray(R.batch_tokens(cfg))}
        rounds = []
        with compat.set_mesh(mesh):
            jfn = compat.jit(bundle.fn, in_shardings=bundle.in_shardings,
                             out_shardings=bundle.out_shardings)
            for _ in range(R.ROUNDS):
                state, mets = jfn(state, batch)
                # host arrays between rounds: a second round fed the
                # first round's sharded output fails at the vocab-sharded
                # embedding gather on this jax (ROADMAP §3)
                state = jax.tree.map(
                    lambda a: jnp.asarray(jax.device_get(a)), state)
                rounds.append(record(state, mets))
        out["steps"][key] = rounds
    # the whole-leaf scan round of the tp plan's clients and batches: the
    # reference where JAX's jitted tp step fails (its dense fold's scan
    # over a client-sharded stack, ROADMAP §3)
    for name, alg, kw in R.SCAN_STEPS:
        cfg = dataclasses.replace(reduce_for_smoke(get_config(name)),
                                  dtype="float32")
        bundle = ST.build_train_step(
            cfg, mesh, shape, algorithm=alg, local_epochs=R.NEW_EPOCHS,
            alpha=R.ALPHA, error_feedback=True)
        fed = dataclasses.replace(
            bundle.static["fed"], client_mode="scan", aggregate="dense",
            client_axes=None, exact_topk=kw.get("exact_topk", False),
            mask_scope=kw.get("mask_scope", "per_tensor"))
        loss = lambda p, b, cfg=cfg: JM.loss_fn(cfg, p, b["tokens"],
                                                remat="full")
        rfn = jax.jit(make_fl_round(fed, loss))
        state = fed_init(fed, jax.tree.map(jnp.asarray, params_np[name]))
        batch = {"tokens": jnp.asarray(R.batch_tokens(cfg))}
        rounds = []
        for _ in range(R.ROUNDS):
            state, mets = rfn(state, batch)
            rounds.append(record(state, mets))
        out["steps"][R.step_key(name, alg, kw)] = rounds
    with open(sys.argv[3], "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """``(jax, ranks)``: JAX's transport and jitted rounds (a subprocess
    with 4 host devices, which compiles each model's step once) and every
    rank's records of the port's cases, run at the same time.  The
    JAX-compared models start from one numpy draw, handed to both."""
    tmp = tmp_path_factory.mktemp("tensor")
    params_np = {name: R.draw_params(TM.abstract_params(R.smoke_cfg(name)),
                                     0)
                 for name in {n for n, _ in R.JAX_STEPS}}
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(params_np, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=4", PYTHONPATH=str(_REPO / "src"), JAX_PLATFORMS="cpu")
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


# (i) ------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(R.TRANSPORT_CASES))
def test_per_shard_transport_bitwise_jax(spawn, case):
    """Each rank packs its shard with its own capacity and folds its
    client group's gathers into its shard: the sums (whole, after an
    unshard) and every client's residual are bitwise JAX's jitted
    transport's, on every rank; the overflow case drops into the
    residual as JAX's does."""
    ref = spawn[0]["transport"][case]
    for r, rk in enumerate(spawn[1]):
        got = rk["transport"][case]
        for s in range(3):
            for a, b in zip(got["sums"][s], ref["sums"][s]):
                np.testing.assert_array_equal(bits(a), bits(b),
                                              f"{case} rank {r} sum {s}")
        for a, b in zip(got["err"], ref["err"]):
            np.testing.assert_array_equal(bits(a), bits(b),
                                          f"{case} rank {r} residual")
    if case == "shared_overflow":
        _, err0, _ = R.transport_inputs(case)
        assert any(not np.array_equal(a, b) for a, b in
                   zip(ref["err"], [err0[k] for k in sorted(err0)]))


# (ii) -----------------------------------------------------------------------

_LAYERS = list(R.layer_defs()) + [f"loss:{n}" for n in R.LOSS_MODELS]


@pytest.mark.parametrize("name", _LAYERS)
def test_tensor_parallel_layer_matches_whole(spawn, name):
    """The split form on this rank's shards against the whole layer on
    the whole leaves, float32: the output (a family's loss), the input's
    and every parameter's gradient (unsharded) within ``LAYER_TOL``, on
    every rank; and the axis splits some leaf of it (the kv_heads cases
    keep ``wk``/``wv`` whole, JAX's divisibility fallback)."""
    for r, rk in enumerate(spawn[1]):
        rec = rk["layers"][name]
        assert rec["out"] <= LAYER_TOL and rec["dx"] <= LAYER_TOL, \
            (name, r, rec)
        assert max(rec["params"]) <= LAYER_TOL, (name, r, rec["params"])
        assert any(rec["split"]), name
    if name.startswith("gqa_kv"):
        # wk, wv (leaves 1 and 2 in sorted order: wk, wo, wq, wv) whole
        split = spawn[1][0]["layers"][name]["split"]
        assert split == [False, True, True, False], split


# (iii) ----------------------------------------------------------------------


@pytest.mark.parametrize("leaf", sorted(R.SELECT_LEAVES))
def test_select_tau_on_a_split_leaf_bitwise_whole(spawn, leaf):
    """``select_tau`` (the absmax and count passes on each shard, MAX and
    float64 SUM over the model group, the tile padding of the whole leaf
    on model index 0 only), its mask, and the bisection reference on a
    split leaf: tau and count bitwise the whole leaf's at alpha 0.05,
    0.01 and 1.0, on every rank (a leaf of no whole number of tiles, an
    all-zero leaf, one split along columns, bfloat16 ties)."""
    for r, rk in enumerate(spawn[1]):
        for alpha in R.SELECT_ALPHAS:
            rec = rk["select"][(leaf, alpha)]
            assert rec["tau_bitwise"] and rec["count_bitwise"], \
                (leaf, alpha, r, rec)
            assert rec["mask_bitwise"] and rec["bisection_bitwise"], \
                (leaf, alpha, r, rec)


def test_shard_unshard_round_trip(spawn):
    """``unshard(shard(params))`` is every family's params bit for bit,
    and each rank's shard is its contiguous chunk along the dim its spec
    names (checked here from the whole leaves with numpy)."""
    for name in R.LOSS_MODELS:
        cfg = R.smoke_cfg(name)
        meta = TM.abstract_params(cfg)
        whole = T.leaves(R.draw_params(meta, 500 + R.LOSS_MODELS.index(
            name)))
        specs = T.leaves(PM.pspecs(meta, shd.param_rules("tp", False),
                                   R.MESH))
        for r, rk in enumerate(spawn[1]):
            rec = rk["roundtrip"][name]
            assert rec["bitwise"], (name, r)
            m = r % R.MESH["model"]
            for x, spec, shape, first in zip(whole, specs, rec["shapes"],
                                             rec["first"]):
                for dim, e in enumerate(spec):
                    if e == "model":
                        n = x.shape[dim] // R.MESH["model"]
                        x = np.take(x, range(m * n, (m + 1) * n), axis=dim)
                assert tuple(x.shape) == shape, (name, spec)
                np.testing.assert_array_equal(x.reshape(-1)[:4], first)


# (iv) -----------------------------------------------------------------------


def _leaf_errors(got, ref):
    """Per leaf, the largest |got - ref| over the reference's largest
    element."""
    return [float(np.abs(np.asarray(a, np.float64) - np.asarray(b))
                  .max() / max(float(np.abs(b).max()), 1e-30))
            for a, b in zip(got, ref)]


def assert_rounds_match(ranks, key, ref, mode="strict"):
    """Rank 0's rounds of ``key`` against ``ref``'s: the bill exactly, the
    losses within 1e-5, the diagnostics within 1e-4, W, M, V within
    ``STEP_TOL`` and the residual within ``ERR_TOL`` of each leaf's
    largest element, supports differing at no more than
    ``SUPPORT_SHARE`` of the elements; every rank's whole state is rank
    0's bit for bit.  ``mode``: ``"support"`` (exact masks, where a
    support that differs moves its elements' W, M, V and residual by a
    whole value): the elements beyond those bounds are no more than the
    supports that differed so far; ``"quantized"``: see
    :func:`assert_quantized_round`."""
    port = ranks[0]["steps"][key]["rounds"]
    flipped = 0
    for r in range(R.ROUNDS):
        a, b = port[r], ref[r]
        assert a["uplink_bits"] == b["uplink_bits"], (key, r)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        for k in b["diag"]:
            np.testing.assert_allclose(a["diag"][k], b["diag"][k],
                                       rtol=1e-4, err_msg=f"{key} {k}")
        if mode == "quantized":
            assert_quantized_round(a, b, (key, r), key[1],
                                   (port[r - 1], ref[r - 1]) if r else None)
            continue
        differ = sum(int(((np.asarray(x) == 0) != (np.asarray(y) == 0))
                         .sum()) for x, y in zip(a["err"], b["err"]))
        total = sum(np.asarray(y).size for y in b["err"])
        assert differ <= SUPPORT_SHARE * total, (key, r, differ)
        flipped += differ
        for part, tol in (("W", STEP_TOL), ("M", STEP_TOL), ("V", STEP_TOL),
                          ("err", ERR_TOL)):
            if mode == "support":
                beyond = _beyond(a[part], b[part], tol)
                assert beyond <= flipped, (key, r, part, beyond, flipped)
                continue
            errs = _leaf_errors(a[part], b[part])
            assert max(errs, default=0.0) <= tol, (key, r, part, errs)
    for rk in ranks[1:]:
        other = rk["steps"][key]["rounds"]
        for r in range(R.ROUNDS):
            for part in ("W", "M", "V", "err"):
                for x, y in zip(other[r][part], port[r][part]):
                    np.testing.assert_array_equal(bits(x), bits(y))


def _beyond(got, ref, tol) -> int:
    """The elements farther than ``tol`` of their leaf's largest element
    from the reference."""
    n = 0
    for x, y in zip(got, ref):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        n += int((np.abs(x - y) > tol * max(float(np.abs(y).max()),
                                            1e-30)).sum())
    return n


#: A quantizer's round against JAX's jitted one, where its input differs
#: by ulps (XLA's fused Adam, its reciprocal scale, ``sign_quant``'s sum
#: order): a code may move one step (Efficient-Adam), or a sign flip at an
#: input within ulps of zero (1-bit Adam).  W, M, V are within
#: ``STEP_TOL`` of each leaf's largest element except at no more than
#: ``QUANT_MOVED_SHARE`` of the elements (the moved codes and signs).
QUANT_MOVED_SHARE = 5e-4
#: Efficient-Adam's residual ``x - code * step`` against JAX's: a whole
#: number of its block's steps (a code that moved; the step is twice the
#: block's largest reference residual, the residual of a rounded code
#: lying within half a step) to within this share of a step (the inputs'
#: own difference: below 0.005 of a step in round 1, below 0.05 in round
#: 2, whose inputs follow W's moved codes), except at no more than
#: ``QUANT_MOVED_SHARE`` of the elements (an input in Adam's eps region,
#: where a gradient's last bits move the update by up to a step) and
#: where the previous round's residual differed by a step, which enters
#: this round's input; there within the two rounds' steps.  The codes
#: that moved are no more than ``QUANT_CODE_SHARE`` of the elements.
QUANT_STEP_SLACK = 0.1
QUANT_CODE_SHARE = 1e-3
QUANT_BLOCK = 1024


def _code_steps(x, y, block=QUANT_BLOCK):
    """``(x - y) / step`` per element of a ``(C, ...)`` stack of client
    residuals, each client's leaf on its quantizer blocks, the step of a
    block twice its largest ``|y|``."""
    x, y = (np.asarray(t, np.float64).reshape(len(t), -1) for t in (x, y))
    pad = ((0, 0), (0, (-x.shape[1]) % block))
    xb, yb = (np.pad(t, pad).reshape(len(t), -1, block) for t in (x, y))
    step = 2 * np.abs(yb).max(axis=2, keepdims=True)
    r = (xb - yb) / np.maximum(step, 1e-30)
    return r.reshape(len(r), -1)[:, :x.shape[1]]


def assert_quantized_round(a, b, what, alg, prev=None):
    """``prev``: the previous round's ``(a, b)`` (Efficient-Adam's carry,
    ``QUANT_STEP_SLACK``).  1-bit Adam's residual ``x - sign * scale``
    is within ``ERR_TOL`` of the leaf's largest residual except where a
    sign flipped: no more elements than C times M's beyond ``STEP_TOL``
    (M starts at zero and is the clients' mean sign carrier, so a flip
    shows in it), and within one flip (twice the leaf's largest residual)
    there."""
    for part in ("W", "M", "V"):
        n = sum(np.asarray(y).size for y in b[part])
        beyond = _beyond(a[part], b[part], STEP_TOL)
        assert beyond <= QUANT_MOVED_SHARE * n, (what, part, beyond, n)
    moved = noisy = 0
    for i, (x, y) in enumerate(zip(a["err"], b["err"])):
        if alg == "onebit_adam":
            x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
            top = max(float(np.abs(y).max()), 1e-30)
            flips = _beyond([a["M"][i]], [b["M"][i]], STEP_TOL)
            beyond = int((np.abs(x - y) > ERR_TOL * top).sum())
            assert beyond <= len(y) * flips, (what, i, beyond, flips)
            assert np.abs(x - y).max() <= 2.02 * top, (what, i, top)
            continue
        r = _code_steps(x, y)
        off = np.abs(r - np.round(r))
        carried = np.zeros(r.shape, bool) if prev is None else \
            np.abs(np.round(_code_steps(prev[0]["err"][i],
                                        prev[1]["err"][i]))) >= 1
        noisy += int((off[~carried] > QUANT_STEP_SLACK).sum())
        assert np.abs(r[~carried]).max(initial=0) <= 1 + QUANT_STEP_SLACK, \
            (what, i)
        if carried.any():
            # this round's step beside the previous round's
            assert np.abs(r[carried]).max() <= 2 + QUANT_STEP_SLACK, \
                (what, i)
        moved += int((np.abs(np.round(r)) >= 1).sum())
    n = sum(np.asarray(y).size for y in b["err"])
    assert moved <= QUANT_CODE_SHARE * n, (what, moved, n)
    assert noisy <= QUANT_MOVED_SHARE * n, (what, noisy, n)


@pytest.mark.parametrize("step", [f"{n}:{a}" for n, a in R.JAX_STEPS])
def test_train_step_matches_jax_tp_step(spawn, step):
    """``build_train_step`` on the (data 2, model 2) group, two rounds with
    error feedback, against JAX's jitted ``build_train_step`` bundle on
    its (2, 2) mesh from the same params and batch: W, M, V within
    ``STEP_TOL`` and the residual within ``ERR_TOL`` of each leaf's
    largest element, supports differing at no more than
    ``SUPPORT_SHARE`` of the elements, the losses within 1e-5, the
    diagnostics within 1e-4, and the bill exactly JAX's; every rank
    returns the same whole state."""
    key = tuple(step.split(":"))
    assert_rounds_match(spawn[1], key, spawn[0]["steps"][key])


_SCAN_KEYS = {":".join(map(str, R.step_key(*s))): R.step_key(*s)
              for s in R.SCAN_STEPS}


@pytest.mark.parametrize("step", sorted(_SCAN_KEYS))
def test_train_step_matches_jax_whole_leaf_scan_round(spawn, step):
    """The dense and quantized baselines (FedAdam, FedSGD, Efficient-Adam,
    1-bit Adam from zero V), FedAdam-SSM with exact masks and FedAdam-Top
    with the global scope (both folding the dense carriers) through
    ``build_train_step`` on the (data 2, model 2) group, two rounds with
    error feedback and one local epoch, against JAX's jitted whole-leaf
    scan round of the same clients, batches and weights (JAX's jitted tp
    step fails at these rounds' dense fold on this jax, ROADMAP §3): the
    bounds of :func:`assert_rounds_match` (exact masks: beyond them no
    more elements than supports differed; a quantizer: those of
    :func:`assert_quantized_round`), the bill exactly JAX's."""
    key = _SCAN_KEYS[step]
    mode = "quantized" if key[1] in ("efficient_adam", "onebit_adam") \
        else "support" if dict(key[2:]).get("exact_topk") else "strict"
    assert_rounds_match(spawn[1], key, spawn[0]["steps"][key], mode)


@pytest.mark.parametrize("step", [":".join(map(str, R.step_key(*s)))
                                  for s in R.TP_STEPS])
def test_fairness_top_step_matches_jax_tp_step(spawn, step):
    """``fairness_top`` (each leaf's norms reduced over its group, the
    threshold of the whole leaf) through ``build_train_step`` on the
    (data 2, model 2) group, two rounds with error feedback and one local
    epoch, against JAX's jitted tp step: :func:`assert_rounds_match`."""
    key = R.step_key(*R.TP_STEPS[0])
    assert_rounds_match(spawn[1], key, spawn[0]["steps"][key])


def check_compress(rec, case, where):
    """One rank's record of :func:`_torch_tensor_ranks.compress_cases`:
    the carriers and the EF residual bitwise the whole leaves' block
    (1-bit Adam: the signs equal, the scales within ``SIGN_ULPS``, the
    residual within one more ulp); Efficient-Adam's codes and scales,
    ``fairness_top``'s scores and tau, the global scope's tau (the
    kernels' passes and the bisection) bitwise; the diagnostics within
    1e-5 (a split leaf's norm adds its shards' sums)."""
    if case == "onebit_adam":
        assert rec["signs"], where
        assert rec["carrier_ulps"] <= R.SIGN_ULPS, (where, rec)
        assert rec["err_ulps"] <= R.SIGN_ULPS + 1, (where, rec)
    else:
        assert rec["carriers"] and rec["err"], (where, rec)
    for k in ("codes_scales", "scores", "tau"):
        assert rec.get(k, True), (where, k, rec)
    assert rec["diag"] <= 1e-5, (where, rec)


@pytest.mark.parametrize("case", sorted(R.COMPRESS_CASES))
def test_compress_on_split_leaves_is_the_whole_leaf(spawn, case):
    """Every compressor's compress on this rank's shards of leaves split
    over the model axis (rows of 1536 and 2560, whose quantizer blocks
    straddle the ranks, a vector, and a whole leaf) against the same
    compressor on the whole leaves, on every rank: bitwise the whole
    leaves' block (:func:`check_compress`); exact masks all-gather the
    split leaves' scores whole, the whole leaves' bytes a rank on the
    mesh's counters."""
    # exact masks gather each split leaf's float32 scores whole (one
    # score tree, or FedAdam-Top's three); nothing else gathers
    split = sum(math.prod(shape) * 4 for shape, spec in
                R.COMPRESS_LEAVES.values() if "model" in spec)
    gathered = {"exact_ssm": split, "global_exact_ssm": split,
                "exact_top": 3 * split}.get(case, 0)
    for r, rk in enumerate(spawn[1]):
        rec = rk["compress"][case]
        assert "model" in rec["kinds"] and None in rec["kinds"]
        check_compress(rec, case, (case, r))
        assert rec["gathered_bytes"] == gathered, (case, r, rec)


@pytest.mark.parametrize("step", [f"{n}:{a}" for n, a in R.JAX_STEPS]
                         + ["deepseek"])
def test_train_step_holds_jax_shard_layout(spawn, step):
    """Each rank's W (and so M, V) and EF residual are its shards under
    JAX's specs: the whole leaf's shape with the model dim halved (the
    residual with its leading client axis of 1); the batch is its
    client's (1, per_client, seq)."""
    key = tuple(step.split(":")) if ":" in step else step
    name = key[0] if ":" in step else "deepseek-v2-lite-16b"
    rec = spawn[1][0]["steps"][key]
    if step == "deepseek":
        rec = rec["split"]
    meta = TM.abstract_params(R.smoke_cfg(name))
    specs = T.leaves(PM.pspecs(meta, shd.param_rules("tp", False), R.MESH))
    expect = []
    for p, spec in zip(T.leaves(meta), specs):
        expect.append(tuple(n // R.MESH["model"] if e == "model" else n
                            for n, e in zip(p.shape, spec)))
    assert rec["shard_shapes"] == expect
    assert rec["cs_shapes"] == [(1,) + s for s in expect]
    assert rec["batch_shapes"] == {"tokens": (1, R.BATCH // 2, R.SEQ)}


# (v) ------------------------------------------------------------------------


def test_deepseek_split_round_vs_whole_leaf_spatial_round(spawn):
    """deepseek-v2-lite-16b (MLA + MoE) on the (2, 2) group against the
    whole-leaf spatial round of its client group (data 2), one round with
    error feedback from the same params and batch.  The masks are the
    same (the whole leaf's threshold); the transports' capacities are
    not: a shard keeps at most ``k_for(n_loc) + overselect_bound`` of its
    own, and an expert stack's shards do not select evenly, so the split
    round drops values into the residual that the whole leaf carries.
    So: W differs from the whole round's by exactly the mean of the
    residuals' difference (within ``LAYER_TOL`` of a leaf's largest),
    M, V and the residual agree within ``LAYER_TOL`` off the dropped
    elements, which are under 1% of them; the losses agree within 1e-6
    and the bills exactly."""
    for rk in spawn[1]:
        rec = rk["steps"]["deepseek"]
        a, b = rec["split"]["rounds"][0], rec["whole"]["rounds"][0]
        assert a["uplink_bits"] == b["uplink_bits"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
        dropped = total = 0
        for i, (ea, eb) in enumerate(zip(a["err"], b["err"])):
            ea, eb = np.asarray(ea, np.float64), np.asarray(eb, np.float64)
            scale = lambda x: max(float(np.abs(x).max()), 1e-30)
            drop = np.abs(ea - eb).max(axis=0) > LAYER_TOL * scale(eb)
            dropped += int(drop.sum())
            total += drop.size
            wa, wb = (np.asarray(x[i], np.float64) for x in (a["W"],
                                                             b["W"]))
            np.testing.assert_allclose(wb - wa, (ea - eb).mean(axis=0),
                                       rtol=0, atol=LAYER_TOL * scale(wb))
            for part in ("M", "V"):
                xa, xb = (np.asarray(x[i], np.float64) for x in (a[part],
                                                                 b[part]))
                assert (np.abs(xa - xb)[~drop] <=
                        LAYER_TOL * scale(xb)).all(), (i, part)
            assert (np.abs(ea - eb)[:, ~drop] <= LAYER_TOL * scale(eb)) \
                .all(), i
        assert 0 < dropped < 0.01 * total, dropped


# ---------------------------------------------------------------------------
# §1.12(a): theory, ALGORITHMS, forward(long_mode=)
# ---------------------------------------------------------------------------

sys.path.insert(0, str(_TESTS))
import test_theory as _jax_theory_cases  # noqa: E402

_THEORY_CASES = sorted(n for n in vars(_jax_theory_cases)
                       if n.startswith("test_"))


@pytest.mark.parametrize("case", _THEORY_CASES)
def test_theory_passes_jax_cases(case, monkeypatch):
    """JAX's ``tests/test_theory.py`` cases, run on the port's copy of
    ``core/theory.py``; and the port's numbers equal JAX's on them."""
    from repro.core import theory as jtheory
    from repro_torch.core import theory
    monkeypatch.setattr(_jax_theory_cases, "T", theory)
    getattr(_jax_theory_cases, case)()
    monkeypatch.setattr(_jax_theory_cases, "T", jtheory)
    p, jp = (m.BoundParams(d=1_000_000, G=1.0, rho=1.0, sigma_l=0.5,
                           sigma_g=0.5, eta=1e-12, eps=1e-2, D_n=32)
             for m in (theory, jtheory))
    for fn in ("gamma", "lam", "theta", "phi_const"):
        assert getattr(theory, fn)(p, 3) == getattr(jtheory, fn)(jp, 3)
    for fn, args in (("theorem2_bound", (0.05, 3, 100, 1.0)),
                     ("theorem3_bound", (0.05, 3, 100, 0.1, 1.0)),
                     ("optimal_local_epochs", (0.05, 100, 1.0)),
                     ("divergence_bound", (3, 0.1, 0.2, 0.3))):
        assert getattr(theory, fn)(p, *args) == \
            getattr(jtheory, fn)(jp, *args), fn


def test_algorithms_exported():
    from repro.core import ALGORITHMS as JALGORITHMS
    from repro_torch.core import ALGORITHMS
    assert ALGORITHMS == JALGORITHMS


def test_forward_long_mode_matches_jax():
    """``forward(long_mode=True)`` on a ``window_all`` config (starcoder2,
    its long window cut to 16) at a sequence of 48: the full-attention
    layers take the window, as JAX's ``_window_override``; the logits
    within the zoo tests' float32 tolerance of JAX's, and not those of
    ``long_mode=False``."""
    from repro.models import model as JM
    jcfg = dataclasses.replace(jreduce(jget_config("starcoder2-3b")),
                               dtype="float32", long_context_window=16)
    cfg = dataclasses.replace(reduce_for_smoke(get_config("starcoder2-3b")),
                              dtype="float32", long_context_window=16)
    assert cfg.long_strategy == "window_all"
    jp, tp = np_model_params(jcfg, cfg)
    toks = np.random.default_rng(3).integers(0, 512, (2, 48)) \
        .astype(np.int32)
    jl, _ = jax.jit(lambda p, t: JM.forward(jcfg, p, t, long_mode=True))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = TM.forward(cfg, tp, torch.from_numpy(toks), long_mode=True)
        full, _ = TM.forward(cfg, tp, torch.from_numpy(toks))
    jl = np.asarray(jl)
    np.testing.assert_allclose(got.numpy(), jl, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jl).max()))
    assert not np.allclose(full.numpy()[:, 16:], jl[:, 16:], atol=1e-3)
    np.testing.assert_allclose(full.numpy()[:, :16], jl[:, :16], rtol=1e-5,
                               atol=1e-5 * float(np.abs(jl).max()))
