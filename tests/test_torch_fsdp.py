"""The port's virtual clients and FSDP train plans (the ``fsdp`` rules of
kimi-k2, jamba-1.5-large, mistral-large and gemma3-27b) against the JAX
package on the CPU.

* As data: ``models/params.pspecs`` under ``param_rules("fsdp")`` equals
  JAX's for the four models on the (2, 2) and (2, 2, 2) mesh shapes, and
  each rank's ``shard`` is the block GSPMD places on its device (JAX's
  ``NamedSharding.devices_indices_map``), the ``("data", "pod")`` order
  included; the data group's shard order agrees with it.
* One spawn of 4 gloo ranks, a (data 2, model 2) group with no client
  axes (``tests/_torch_fsdp_ranks.py``), beside ONE subprocess with 8 host
  devices that runs JAX's side:

  (i) ``unshard(shard(params))`` bit for bit;
  (ii) ``select_tau`` (and its mask, and the bisection reference) on a
  leaf split over the data axes alone, over both, and with tile padding,
  bitwise the whole leaf's;
  (iii) one layer of each kind (GQA, MLP, MLA + MoE, SSD) on its FSDP+tp
  shards and this rank's batch slice within ``LAYER_TOL`` of the whole
  layer, forward and gradients;
  (iv) two virtual/fsdp rounds with error feedback of
  mistral-large-123b's smoke config through ``build_train_step`` against
  JAX's jitted virtual step (host arrays between rounds), within
  ``tests/test_torch_tensor.py``'s bounds, the bill exactly JAX's;
  (v) kimi-k2-1t-a32b's split round against the port's whole-leaf scan
  round (JAX's fails in ``moe_fwd`` under FSDP on this jax).
* ``run_ranks`` fails at once, naming the rank and its exit code, when a
  rank's process ends without answering.
"""
import math
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import _torch_fsdp_ranks as R
from _torch_parity import bits
from _torch_tensor_ranks import draw_params
from repro.configs import get_config as jget_config
from repro_torch import sharding as shd
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.launch import mesh as MM
from repro_torch.models import model as TM
from repro_torch.models import params as PM
from test_torch_tensor import (ERR_TOL, LAYER_TOL, STEP_TOL, SUPPORT_SHARE,
                               _leaf_errors, _Shape)

_TESTS = Path(__file__).resolve().parent
_REPO = _TESTS.parent
SPAWN_TIMEOUT_S = 300
_MESHES = {"test": MM.make_test_mesh(),
           "test_multi_pod": MM.make_test_mesh(multi_pod=True)}


def _jax_meta(name):
    from repro.models import model as JM
    return JM.abstract_params(jget_config(name))


# ---------------------------------------------------------------------------
# The specs and the shard layout as data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", sorted(_MESHES))
@pytest.mark.parametrize("name", R.FSDP_MODELS)
def test_fsdp_pspecs_equal_jax(name, mesh_name):
    """The ``fsdp`` rules through ``pspecs``: the port's specs are JAX's,
    leaf for leaf (``embed`` over ``("data", "pod")`` as a tuple entry on
    the multi-pod shape), and some leaf is split over the FSDP axes."""
    from repro.models import params as JP
    shape = _MESHES[mesh_name]
    rules = shd.param_rules("fsdp", "pod" in shape)
    jspec = JP.pspecs(_jax_meta(name), rules, _Shape(shape))
    tspec = PM.pspecs(TM.abstract_params(get_config(name)), rules, shape)
    jl = jax.tree_util.tree_leaves(
        jspec, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert [tuple(s) for s in jl] == [tuple(s) for s in T.leaves(tspec)]
    kinds = PM.split_kinds(tspec, shape)
    assert "both" in kinds and "data" in kinds
    if "pod" in shape:
        assert any(("data", "pod") in tuple(s) for s in T.leaves(tspec))


def _views(shape):
    """Every rank's view of a virtual mesh (no process group)."""
    return [MM.ClientMesh(shape=shape, client_axes=(), rank=r,
                          device=torch.device("cpu"))
            for r in range(math.prod(shape.values()))]


@pytest.mark.parametrize("mesh_name", sorted(_MESHES))
def test_shard_is_jax_device_block(spawn, mesh_name):
    """Each rank's ``shard`` of every leaf of the four models' smoke
    configs is the block JAX places on the device at its position of the
    mesh (``devices_indices_map``): a tuple entry ``("data", "pod")`` is
    ``data * pods + pod``, not the mesh's (pod, data) order.  The data
    group's ``order`` lists its ranks by that index, and each rank's
    ``index`` is its own."""
    shape = _MESHES[mesh_name]
    rules = shd.param_rules("fsdp", "pod" in shape)
    views = _views(shape)
    for name in R.FSDP_MODELS:
        meta = TM.abstract_params(R.smoke_cfg(name))
        specs = T.leaves(PM.pspecs(meta, rules, shape))
        blocks = spawn[0]["blocks"][(name, mesh_name)]
        for i, (p, spec) in enumerate(zip(T.leaves(meta), specs)):
            x = torch.arange(int(np.prod(p.shape))).reshape(p.shape)
            for r, mesh in enumerate(views):
                got = PM.shard(x, spec, mesh)
                want = x[tuple(slice(a, b) for a, b in blocks[i][r])]
                assert torch.equal(got, want), (name, i, spec, r)
    M = shape["model"]
    for mesh in views:
        dg = mesh.data
        for s, j in enumerate(dg.order or range(dg.size)):
            assert views[j * M + mesh.model_index].data.index == s
    if "pod" in shape:
        assert views[0].data.order == (0, 2, 1, 3)


def test_materialize_shards_is_shard_of_materialize():
    """``materialize_shards`` draws each whole leaf in leaf order from the
    one generator and keeps this rank's block: every rank's shards are
    ``shard(materialize(...))``'s, bit for bit (the (2, 2, 2) mesh,
    mistral-large-123b's smoke config in its bfloat16, float32 norms)."""
    from repro_torch.configs import reduce_for_smoke
    cfg = reduce_for_smoke(get_config(R.JAX_MODEL))
    meta = TM.abstract_params(cfg)
    shape = _MESHES["test_multi_pod"]
    specs = PM.pspecs(meta, shd.param_rules("fsdp", True), shape)
    whole = PM.materialize(meta, 3, cfg.dtype)
    for mesh in _views(shape):
        got = PM.materialize_shards(meta, specs, mesh, 3, cfg.dtype)
        for a, b in zip(T.leaves(got), T.leaves(PM.shard(whole, specs,
                                                         mesh))):
            assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The spawn: 4 gloo ranks beside one JAX subprocess
# ---------------------------------------------------------------------------

_JAX_SUB = textwrap.dedent("""
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding
    from repro import compat
    from repro import sharding as shd
    from repro.configs import get_config, reduce_for_smoke
    from repro.core import fed_init
    from repro.launch import steps as ST
    from repro.launch.mesh import make_test_mesh
    from repro.models import model as JM
    from repro.models import params as JP
    sys.path.insert(0, sys.argv[1])
    import _torch_fsdp_ranks as R

    leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    with open(sys.argv[2], "rb") as f:
        params_np = pickle.load(f)
    out = {"blocks": {}}
    for mesh_name, multi_pod in (("test", False), ("test_multi_pod", True)):
        mesh = make_test_mesh(multi_pod=multi_pod)
        devs = list(np.asarray(mesh.devices).reshape(-1))
        rules = shd.param_rules("fsdp", multi_pod)
        for name in R.FSDP_MODELS:
            meta = JM.abstract_params(reduce_for_smoke(get_config(name)))
            specs = jax.tree.leaves(JP.pspecs(meta, rules, mesh),
                                    is_leaf=is_spec)
            shapes = [p.shape for p in jax.tree.leaves(
                meta, is_leaf=JP.is_meta)]
            recs = []
            for spec, shape in zip(specs, shapes):
                idx = NamedSharding(mesh, spec).devices_indices_map(shape)
                recs.append([[sl.indices(n)[:2] for sl, n in
                              zip(idx[d], shape)] for d in devs])
            out["blocks"][(name, mesh_name)] = recs
    mesh = make_test_mesh()
    cfg = dataclasses.replace(reduce_for_smoke(get_config(R.JAX_MODEL)),
                              dtype="float32")
    shape = dataclasses.replace(ST.SHAPES["train_4k"], seq_len=R.SEQ,
                                global_batch=R.BATCH)
    bundle = ST.build_train_step(
        cfg, mesh, shape, local_epochs=R.LOCAL_EPOCHS, alpha=R.ALPHA,
        error_feedback=True,
        plan=shd.DeployPlan(clients="virtual", train_params="fsdp",
                            n_virtual=R.N_VIRTUAL))
    state = fed_init(bundle.static["fed"],
                     jax.tree.map(jnp.asarray, params_np))
    batch = {"tokens": jnp.asarray(R.batch_tokens(cfg))}
    rounds = []
    with compat.set_mesh(mesh):
        jfn = compat.jit(bundle.fn, in_shardings=bundle.in_shardings,
                         out_shardings=bundle.out_shardings)
        for _ in range(R.ROUNDS):
            state, mets = jfn(state, batch)
            # host arrays between rounds: a second round fed the first
            # round's sharded output fails at the embedding gather on
            # this jax (ROADMAP §3)
            state = jax.tree.map(
                lambda a: jnp.asarray(jax.device_get(a)), state)
            rounds.append(dict(
                W=leaves(state.W), M=leaves(state.M), V=leaves(state.V),
                err=leaves(state.client_state["comp"]["err"]),
                loss=np.asarray(mets["loss"]),
                uplink_bits=float(mets["uplink_bits"]),
                diag={k: np.asarray(v) for k, v in mets.items()
                      if k not in ("loss", "uplink_bits")}))
    out["steps"] = rounds
    with open(sys.argv[3], "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """``(jax, ranks)``: JAX's device blocks and jitted virtual rounds (a
    subprocess with 8 host devices, one compile) and every rank's records
    of the port's cases, run at the same time.  mistral's rounds start
    from one numpy draw, handed to both."""
    tmp = tmp_path_factory.mktemp("fsdp")
    params_np = draw_params(TM.abstract_params(R.smoke_cfg(R.JAX_MODEL)), 0)
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(params_np, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=8", PYTHONPATH=str(_REPO / "src"), JAX_PLATFORMS="cpu")
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


@pytest.mark.parametrize("name", R.FSDP_MODELS)
def test_shard_unshard_round_trip(spawn, name):
    """``unshard(shard(params))`` over the model and data groups is the
    params bit for bit on every rank, and each rank's shard is its block
    (the whole leaf's shape cut along the dims its spec names)."""
    meta = TM.abstract_params(R.smoke_cfg(name))
    specs = T.leaves(PM.pspecs(meta, shd.param_rules("fsdp", False),
                               R.MESH))
    for r, rk in enumerate(spawn[1]):
        rec = rk["roundtrip"][name]
        assert rec["bitwise"], (name, r)
        for p, spec, got in zip(T.leaves(meta), specs, rec["shapes"]):
            want = tuple(n // R.MESH[e] if e else n
                         for n, e in zip(p.shape, spec))
            assert got == want, (name, spec)


# (ii) -----------------------------------------------------------------------


@pytest.mark.parametrize("leaf", sorted(R.SELECT_LEAVES))
def test_select_tau_on_fsdp_shards_bitwise_whole(spawn, leaf):
    """``select_tau`` on this rank's shard (the absmax and count passes
    reduced over the leaf's group: the data group for a leaf split over
    the data axes alone, whose model ranks hold replicas, the leaf group
    of every rank for one split over both; the tile padding counted once,
    on the rank at 0 along every axis that splits the leaf), its mask and
    the bisection reference: tau and count bitwise the whole leaf's at
    alpha 0.05, 0.01 and 1.0, on every rank."""
    want = "data" if leaf.startswith("data") else "both"
    for r, rk in enumerate(spawn[1]):
        for alpha in R.SELECT_ALPHAS:
            rec = rk["select"][(leaf, alpha)]
            assert rec["kind"] == want
            assert rec["tau_bitwise"] and rec["count_bitwise"], \
                (leaf, alpha, r, rec)
            assert rec["mask_bitwise"] and rec["bisection_bitwise"], \
                (leaf, alpha, r, rec)


# (iii) ----------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(R.layer_defs()))
def test_fsdp_layer_matches_whole(spawn, name):
    """The layer on its FSDP+tp shards (each leaf gathered over the data
    group first) and this rank's quarter of the batch, against the whole
    layer on the whole batch, float32: the output slice, the input
    gradient and every parameter gradient (unsharded) within
    ``LAYER_TOL`` of the whole form's largest element; the MoE
    load-balance loss is the whole batch's.  Some leaf is split over
    both axes and some over the data axes alone or both."""
    for r, rk in enumerate(spawn[1]):
        rec = rk["layers"][name]
        assert rec["out"] <= LAYER_TOL and rec["dx"] <= LAYER_TOL, \
            (name, r, rec)
        assert max(rec["params"]) <= LAYER_TOL, (name, r, rec["params"])
        assert "both" in rec["kinds"], rec["kinds"]


# (iv) -----------------------------------------------------------------------


def test_virtual_fsdp_step_matches_jax(spawn):
    """``build_train_step`` with the virtual/fsdp plan on the (data 2,
    model 2) group, two rounds with error feedback, against JAX's jitted
    virtual step on its (2, 2) mesh from the same params and batch: W, M,
    V within ``STEP_TOL`` and the residual within ``ERR_TOL`` of each
    leaf's largest element, supports differing at no more than
    ``SUPPORT_SHARE`` of the elements, the losses within 1e-5, the
    diagnostics within 1e-4, the bill exactly JAX's; every rank returns
    the same whole state."""
    ref = spawn[0]["steps"]
    port = spawn[1][0]["steps"][R.JAX_MODEL]["rounds"]
    for r in range(R.ROUNDS):
        a, b = port[r], ref[r]
        assert a["uplink_bits"] == b["uplink_bits"], r
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        for k in b["diag"]:
            np.testing.assert_allclose(a["diag"][k], b["diag"][k],
                                       rtol=1e-4, err_msg=k)
        for part, tol in (("W", STEP_TOL), ("M", STEP_TOL), ("V", STEP_TOL),
                          ("err", ERR_TOL)):
            errs = _leaf_errors(a[part], b[part])
            assert max(errs) <= tol, (r, part, errs)
        differ = sum(int(((np.asarray(x) == 0) != (np.asarray(y) == 0))
                         .sum()) for x, y in zip(a["err"], b["err"]))
        total = sum(np.asarray(y).size for y in b["err"])
        assert differ <= SUPPORT_SHARE * total, (r, differ)
    for rk in spawn[1][1:]:
        other = rk["steps"][R.JAX_MODEL]["rounds"]
        for r in range(R.ROUNDS):
            for part in ("W", "M", "V", "err"):
                for x, y in zip(other[r][part], port[r][part]):
                    np.testing.assert_array_equal(bits(x), bits(y))


def test_virtual_fsdp_step_holds_jax_layout(spawn):
    """Each rank's W (and so M, V) is its FSDP+tp shard, the virtual
    clients' residuals stacked ``(n_virtual, *shard)`` with the client
    axis unsharded; the bundle's batch is ``(n_virtual, global_batch /
    data, seq)`` and the rank holds exactly that slice."""
    rec = spawn[1][0]["steps"][R.JAX_MODEL]
    meta = TM.abstract_params(R.smoke_cfg(R.JAX_MODEL))
    specs = T.leaves(PM.pspecs(meta, shd.param_rules("fsdp", False),
                               R.MESH))
    expect = [tuple(n // 2 if e else n for n, e in zip(p.shape, spec))
              for p, spec in zip(T.leaves(meta), specs)]
    assert rec["shard_shapes"] == expect
    assert rec["cs_shapes"] == [(R.N_VIRTUAL,) + s for s in expect]
    want = (R.N_VIRTUAL, R.BATCH // 2, R.SEQ)
    assert rec["batch_shapes"] == {"tokens": want}
    assert rec["local_batch"] == want


# (v) ------------------------------------------------------------------------


def test_moe_split_round_vs_whole_leaf_scan_round(spawn):
    """kimi-k2-1t-a32b (MoE, its experts over "model", every ``embed`` dim
    over "data") on the (2, 2) group against the port's whole-leaf scan
    round on one rank, one round with error feedback from the same
    params and batch: the masks keep each whole leaf's threshold, so W,
    M, V agree within ``STEP_TOL`` and the residual within ``ERR_TOL`` of
    each leaf's largest element (the split products and the data group's
    gradient sums add in another order), supports differ at no more than
    ``SUPPORT_SHARE`` of the elements, the losses within 1e-6 and the
    bills exactly."""
    rec = spawn[1][0]["steps"][R.MOE_MODEL]
    a, b = rec["split"]["rounds"][0], rec["whole"]["rounds"][0]
    assert a["uplink_bits"] == b["uplink_bits"]
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
    for part, tol in (("W", STEP_TOL), ("M", STEP_TOL), ("V", STEP_TOL),
                      ("err", ERR_TOL)):
        errs = _leaf_errors(a[part], b[part])
        assert max(errs) <= tol, (part, errs)
    differ = sum(int(((np.asarray(x) == 0) != (np.asarray(y) == 0)).sum())
                 for x, y in zip(a["err"], b["err"]))
    assert differ <= SUPPORT_SHARE * sum(np.asarray(y).size
                                         for y in b["err"]), differ
    for rk in spawn[1][1:]:
        other = rk["steps"][R.MOE_MODEL]["split"]["rounds"][0]
        for part in ("W", "M", "V", "err"):
            for x, y in zip(other[part], a[part]):
                np.testing.assert_array_equal(bits(x), bits(y))


# ---------------------------------------------------------------------------
# run_ranks and a rank that dies
# ---------------------------------------------------------------------------


def test_run_ranks_fails_at_once_on_a_dead_rank(tmp_path):
    """A rank whose process ends without answering (``os._exit(3)``, as
    an out-of-memory kill or a native abort would) fails ``run_ranks`` at
    once, naming the rank and its exit code, not after ``timeout_s``;
    every process is ended."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3"):
        MM.run_ranks(R.exit_hard, 2, store=str(tmp_path / "store"),
                     timeout_s=120)
    assert time.perf_counter() - t0 < 45
