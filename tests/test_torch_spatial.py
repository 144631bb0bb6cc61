"""The port's multi-GPU spatial driver (``core/fed.py``'s spatial round,
``core/aggregate.py``'s per-shard bitmap transport, ``core/async_fed.py``'s
mesh cohort, ``launch/mesh.py``, ``launch/steps.py``) and ``remat``,
against the JAX package on the CPU.

* ``pack_bits_1d`` / ``unpack_bits_1d`` and the transport's pack, compaction
  and expansion: bitwise JAX's.
* The world-1 aggregate (a gloo group of this process alone): bitwise
  JAX's 1-device ``make_shardmap_sparse_aggregate``, overflow feedback
  included (tests/test_aggregate_and_quant.py's case).
* The spatial round at world 2 and 4 (gloo, one process per rank, over a
  ``file://`` store), 3 rounds of FedAdam-SSM and FedAdam-Top with error
  feedback, also at participation 0.5, against JAX's own
  ``round_shardmap`` with the injected aggregate (a subprocess with 4 host
  devices): bitwise the port's scan round and JAX's eager ``round_scan``
  in W, M, V and every client's state, and within ``JIT_TOL`` of JAX's
  jitted ``round_shardmap``.  JAX's eager shard_map compiles every
  operation anew (far too slow for the suite), so the bitwise leg runs
  through the scan round.  The toy model's gradient is elementwise, so
  eager JAX and the port compute the same bits.  The dense branch (1-bit
  Adam, Efficient-Adam; JAX's fails on this jax, ROADMAP §3) is within
  2e-6 of JAX's ``round_scan`` and bitwise the port's.
* The async driver's mesh cohort under churn at world 2: bitwise its scan
  cohort.
* ``remat`` "full" and "dots": losses and gradients bitwise "none"'s, and
  "full" against JAX's ``loss_fn(remat="full")`` within the zoo tests'
  float32 tolerance.
* ``build_train_step`` of the smoke deepseek-v2-lite at world 2.
"""
import dataclasses
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

import _torch_spatial_ranks as R
from _torch_parity import assert_bitwise, bits, np_model_params
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core import aggregate as jagg
from repro.core import wire as jwire
from repro_torch import tree as T
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import FedConfig, aggregate, make_fl_round, wire
from repro_torch.launch import mesh as MM
from repro_torch.models import model as TM

_TESTS = Path(__file__).resolve().parent
_REPO = _TESTS.parent
WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 240

# ---------------------------------------------------------------------------
# The bitmap codec and the transport's pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 4097])
def test_pack_bits_1d_bitwise_vs_jax(n):
    b = np.random.default_rng(n).random(n) < 0.4
    words = wire.pack_bits_1d(torch.from_numpy(b))
    jwords = jwire.pack_bits_1d(jnp.asarray(b))
    assert words.dtype == torch.uint32 and words.shape == (-(-n // 32),)
    assert_bitwise(words, jwords, "words")
    assert_bitwise(wire.unpack_bits_1d(words, n),
                   jwire.unpack_bits_1d(jwords, n), "bits")


@pytest.mark.parametrize("nnz", [5, 40, 200])
def test_local_pack_compact_expand_bitwise_vs_jax(nnz):
    """Under, at and past the capacity (n 257, alpha 0.1: k 26, kb 35)."""
    n, alpha = 257, 0.1
    rng = np.random.default_rng(nnz)
    x = np.zeros(n, np.float32)
    x[rng.choice(n, nnz, replace=False)] = rng.standard_normal(nnz)
    y = rng.standard_normal(n).astype(np.float32)
    words, pos, keep, kb = aggregate._local_pack(torch.from_numpy(x), alpha)
    jw, jpos, jkeep, jkb = jagg._local_pack(jnp.asarray(x), alpha)
    assert kb == jkb
    assert_bitwise(words, jw, "words")
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    vals = aggregate._compact_vals(torch.from_numpy(y), pos, keep, kb)
    jvals = jagg._compact_vals(jnp.asarray(y), jpos, jkeep, jkb)
    assert_bitwise(vals, jvals, "values")
    assert_bitwise(aggregate._expand_vals(words, vals, n),
                   jagg._expand_vals(jw, jvals, n), "expanded")


# ---------------------------------------------------------------------------
# The world-1 aggregate, in this process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def group1(tmp_path_factory):
    mesh = MM.make_test_group(1, 0, str(tmp_path_factory.mktemp("g1")
                                        / "store"))
    yield mesh
    mesh.close()


def _jax_agg(alpha, shared=True, value_dtype=None, leaves=("x", "y")):
    """JAX's transport on a 1-device mesh, jitted (eager shard_map
    compiles every operation anew).  The tests' FedAvg weights are powers
    of two, so that XLA's fused ``acc + w * x`` rounds as the port's."""
    from jax.sharding import PartitionSpec as P
    return jax.jit(jagg.make_shardmap_sparse_aggregate(
        jax.make_mesh((1,), ("data",)), {k: P() for k in leaves},
        ("data",), alpha, shared=shared, value_dtype=value_dtype))


def _carriers(seed, alpha):
    """(1, n) masked carriers of two leaves, a residual, FedAvg weight."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in (("x", (1, 300)), ("y", (1, 7, 9))):
        w = rng.standard_normal(shape).astype(np.float32)
        keep = rng.random(shape) < alpha
        out[name] = tuple((t * keep).astype(np.float32) for t in (
            w, rng.standard_normal(shape), np.abs(rng.standard_normal(
                shape))))
    err = {k: rng.standard_normal(v[0].shape).astype(np.float32)
           for k, v in out.items()}
    return out, err, np.array([0.5], np.float32)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("value_dtype", [None, "bfloat16"])
def test_world1_aggregate_bitwise_vs_jax(group1, shared, value_dtype):
    alpha = 0.2
    car, err, w = _carriers(int(shared) + 2 * (value_dtype is None), alpha)
    tree = lambda i, f: {k: f(v[i]) for k, v in car.items()}
    tt = lambda x: torch.from_numpy(x)
    agg = aggregate.make_shardmap_sparse_aggregate(
        group1, None, ("data",), alpha, shared=shared,
        value_dtype=value_dtype)
    (aw, am, av), new_err = agg(tree(0, tt), tree(1, tt), tree(2, tt),
                                tt(w), {k: tt(v) for k, v in err.items()})
    jagg_fn = _jax_agg(alpha, shared, value_dtype)
    (jw, jm, jv), jerr = jagg_fn(tree(0, jnp.asarray), tree(1, jnp.asarray),
                                 tree(2, jnp.asarray), jnp.asarray(w),
                                 {k: jnp.asarray(v) for k, v in err.items()})
    for got, ref, what in ((aw, jw, "W"), (am, jm, "M"), (av, jv, "V"),
                           (new_err, jerr, "err")):
        for k in got:
            assert_bitwise(got[k], ref[k], f"{what}[{k}]")
    # without error feedback: the sums alone, the same bits
    sums = agg(tree(0, tt), tree(1, tt), tree(2, tt), tt(w))
    for got, ref in zip(sums, (aw, am, av)):
        for k in got:
            assert torch.equal(got[k], ref[k])


def test_world1_aggregate_overflow_feeds_the_residual(group1):
    """tests/test_aggregate_and_quant.py's case: more nonzeros than the
    capacity; the residual gains exactly the drop (bitwise JAX's), and
    without overflow it comes back bit for bit."""
    from repro_torch.core import sparsify as S
    from repro_torch.kernels.topk_mask.ref import overselect_bound
    n, alpha = 64, 0.25
    k = S.k_for(n, alpha)
    kb = min(n, k + overselect_bound(k))
    wf = np.zeros(n, np.float32)
    wf[:2 * kb] = np.arange(1.0, 2 * kb + 1)
    err0 = np.random.default_rng(9).standard_normal((1, n)).astype(
        np.float32)
    one = np.ones(1, np.float32)
    agg = aggregate.make_shardmap_sparse_aggregate(group1, None, ("data",),
                                                 alpha)
    x = {"x": torch.from_numpy(wf[None])}
    (aw, _, _), err1 = agg(x, x, x, torch.from_numpy(one),
                           {"x": torch.from_numpy(err0)})
    kept = np.where(np.arange(n) < kb, wf, 0.0).astype(np.float32)
    np.testing.assert_array_equal(aw["x"].numpy(), kept)
    np.testing.assert_array_equal(err1["x"].numpy(),
                                  (err0 + (wf - kept)[None]))
    jfn = _jax_agg(alpha, leaves=("x",))
    jx = {"x": jnp.asarray(wf[None])}
    (jw, _, _), jerr = jfn(jx, jx, jx, jnp.asarray(one),
                           {"x": jnp.asarray(err0)})
    assert_bitwise(aw["x"], jw["x"], "W")
    assert_bitwise(err1["x"], jerr["x"], "err")
    few = np.zeros((1, n), np.float32)
    few[0, :k // 2] = 1.0
    f = {"x": torch.from_numpy(few)}
    _, err2 = agg(f, f, f, torch.from_numpy(one),
                  {"x": torch.from_numpy(err0)})
    assert_bitwise(err2["x"], err0, "residual without overflow")


def test_aggregate_rejects_another_mesh(group1):
    with pytest.raises(ValueError, match="client axes"):
        aggregate.make_shardmap_sparse_aggregate(group1, None,
                                                 ("pod", "data"), 0.1)
    with pytest.raises(ValueError, match="one spatial client per rank"):
        x = {"x": torch.ones(2, 4)}
        aggregate.make_shardmap_sparse_aggregate(group1, None, ("data",),
                                                 0.5)(
            x, x, x, torch.ones(2))


# ---------------------------------------------------------------------------
# The spatial round at world 2 and 4 against JAX's round_shardmap
# ---------------------------------------------------------------------------

_JAX_SUB = textwrap.dedent("""
    import contextlib, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.core import FedConfig, fed_init, make_fl_round
    from repro.core.aggregate import make_shardmap_sparse_aggregate
    from repro.core.compressors import transport_of
    from repro.optim import AdamHyper
    sys.path.insert(0, sys.argv[1])
    import _torch_spatial_ranks as R

    def loss(p, b):
        return jnp.mean((p["w"] - b["w"]) ** 2) \\
            + jnp.mean((p["b"] - b["b"]) ** 2)

    leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]

    def run(fed, params, batches, mesh=None, agg=None, jit=True):
        rf = make_fl_round(fed, loss, sparse_aggregate_fn=agg)
        st, rounds = fed_init(fed, params), []
        # only round_shardmap runs under the mesh: the scan rounds stay on
        # one device
        with compat.set_mesh(mesh) if mesh else contextlib.nullcontext():
            for _ in range(R.ROUNDS):
                if jit:
                    st, m = jax.jit(rf)(st, batches)
                else:
                    with jax.disable_jit():
                        st, m = rf(st, batches)
                rounds.append(dict(
                    W=leaves(st.W), M=leaves(st.M), V=leaves(st.V),
                    cs=leaves(st.client_state), loss=np.asarray(m["loss"]),
                    uplink_bits=float(m["uplink_bits"])))
        return rounds

    out = {}
    for world in (2, 4):
        params, batches = (jax.tree.map(jnp.asarray, t)
                           for t in R.toy(world))
        mesh = jax.make_mesh((world,), ("data",))
        for case, kw in R.ROUND_CASES.items():
            kw = dict(kw, local_epochs=R.LOCAL_EPOCHS, n_clients=world,
                      adam=AdamHyper(lr=R.LR))
            scan = FedConfig(**dict(kw, aggregate="dense"))
            rec = {"scan_eager": run(scan, params, batches, jit=False)}
            if kw["aggregate"] == "sparse_gather":
                # round_shardmap with the injected transport (its dense
                # branch fails on this jax)
                agg = make_shardmap_sparse_aggregate(
                    mesh, {"b": P(), "w": P()}, ("data",), kw["alpha"],
                    shared=transport_of(kw["algorithm"]) == "shared_sparse")
                rec["shardmap_jit"] = run(
                    FedConfig(**dict(kw, client_mode="vmap",
                                     client_axes=("data",))),
                    params, batches, mesh, agg)
            out[(world, case)] = rec
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    """``(jax, port)``.  JAX's rounds of every case at world 2 and 4, in a
    subprocess with 4 host devices (this process keeps its one): eager
    ``round_scan`` (``disable_jit``) and, for the sparse cases, jitted
    ``round_shardmap``.  Meanwhile the port's spatial
    rounds of every case on gloo groups of 2 and 4 CPU processes (and at
    2 the async cohorts and the train step): every rank's records."""
    tmp = tmp_path_factory.mktemp("rounds")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=4", PYTHONPATH=str(_REPO / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", _JAX_SUB, str(_TESTS),
                            str(tmp / "jax.pkl")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        # world 2 also runs the async cohorts and the train step
        port = {world: MM.run_ranks(R.on_group, world,
                                    store=str(tmp / f"store{world}"),
                                    args=(tuple(R.ROUND_CASES), world == 2),
                                    timeout_s=SPAWN_TIMEOUT_S)
                for world in WORLDS}
        _, err = ref.communicate(timeout=SPAWN_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    with open(tmp / "jax.pkl", "rb") as f:
        return pickle.load(f), port


def _assert_rounds(port, ref, what, atol=0.0, rtol=0.0):
    """Every round's W, M, V and client state: bitwise (``atol`` 0) or
    within ``atol`` + ``rtol`` of the reference's largest element; the
    bill exactly; the losses within 1e-6."""
    assert len(port["rounds"]) == len(ref) == R.ROUNDS
    for r, (a, b) in enumerate(zip(port["rounds"], ref)):
        for part in ("W", "M", "V", "cs"):
            assert len(a[part]) == len(b[part]), (what, r, part)
            for i, (x, y) in enumerate(zip(a[part], b[part])):
                tag = f"{what} round {r} {part}[{i}]"
                if atol == 0.0 and rtol == 0.0:
                    np.testing.assert_array_equal(bits(x), bits(y), tag)
                else:
                    np.testing.assert_allclose(
                        x, y, rtol=0, err_msg=tag,
                        atol=atol + rtol * float(np.abs(y).max()))
        assert port["uplink_bits"][r] == b["uplink_bits"], (what, r)
        np.testing.assert_allclose(port["loss"][r], b["loss"], rtol=1e-6,
                                   err_msg=f"{what} round {r} loss")


#: The port's rounds against jitted JAX: under jit XLA fuses Adam's
#: ``b1*m + (1-b1)*g`` into an FMA and rewrites ``m / sqrt(v + eps)``
#: (ROADMAP §3), so the elements agree within this share of a leaf's
#: largest; eager JAX computes the port's bits.
JIT_TOL = 1e-5


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["fedadam_ssm", "fedadam_top",
                                  "fedadam_ssm_participation"])
def test_spatial_round_matches_jax_shardmap(rounds, world, case):
    """3 rounds of the sparse transport with error feedback.  The port's
    spatial round is bitwise its own scan round and JAX's eager
    ``round_scan`` (W, M, V, every client's residual), and within
    ``JIT_TOL`` of JAX's jitted ``round_shardmap`` with the injected
    aggregate (which is bitwise JAX's jitted ``round_scan``, the
    reference's own claim); the bill ``n_active * wire bits`` is JAX's
    exactly."""
    port = rounds[1][world][0]["rounds"][case]
    ref = rounds[0][(world, case)]
    assert port["scan_bitwise"], f"{case}@{world}: not the port's scan"
    _assert_rounds(port, ref["scan_eager"], f"{case}@{world} eager scan")
    _assert_rounds(port, ref["shardmap_jit"], f"{case}@{world} shardmap",
                   rtol=JIT_TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["onebit_adam", "efficient_adam"])
def test_spatial_dense_branch_vs_round_scan(rounds, world, case):
    """The gathered dense carriers folded in client order: within 2e-6 of
    JAX's eager ``round_scan`` (tests/test_fed_equivalence.py's bound;
    1-bit Adam's block means sum in another order), and bitwise the
    port's scan round."""
    port = rounds[1][world][0]["rounds"][case]
    assert port["scan_bitwise"], f"{case}@{world}: not the port's scan"
    _assert_rounds(port, rounds[0][(world, case)]["scan_eager"],
                   f"{case}@{world}", atol=2e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_ranks_hold_one_state(rounds, world):
    """Every rank ends each round with the same W, M, V bits, and returns
    the same gathered records."""
    ranks = [rk["rounds"] for rk in rounds[1][world]]
    for case in R.ROUND_CASES:
        assert all(rk[case]["ranks_agree"] for rk in ranks), case
        for rk in ranks[1:]:
            for a, b in zip(rk[case]["rounds"], ranks[0][case]["rounds"]):
                for part in ("W", "cs"):
                    for x, y in zip(a[part], b[part]):
                        np.testing.assert_array_equal(bits(x), bits(y))


def test_async_mesh_cohort_bitwise_scan_cohort(rounds):
    """The buffered-async driver under churn with the group's cohort
    (world 2, padded lanes) and with the scan cohort: the same event log,
    bills and state bits (JAX's tests/test_async_fed.py equivalence)."""
    for r in (rk["async"] for rk in rounds[1][2]):
        assert r["steps"] == (R.ASYNC_STEPS, R.ASYNC_STEPS), r
        assert r["landed"][0] == r["landed"][1] > 0, r
        assert r["events_equal"] and r["state_bitwise"] \
            and r["bits_equal"], r


def test_build_train_step_runs_a_spatial_round(rounds):
    """``build_train_step`` of the smoke deepseek-v2-lite at world 2: the
    plan's configuration (2 clients, the bitmap transport, threshold
    masks), one round on each rank, a finite loss per client, the bill
    of 2 clients, and one W on both ranks."""
    from repro_torch.core.compressors import make_compressor
    res = [rk["train_step"] for rk in rounds[1][2]]
    fed = res[0]["fed"]
    assert (fed["n_clients"], fed["client_mode"], fed["aggregate"],
            fed["client_axes"], fed["exact_topk"]) == \
        (2, "vmap", "sparse_gather", ("data",), False)
    assert res[0]["batch_shapes"] == {"tokens": (1, 2, 32)}
    for r in res:
        assert r["loss"].shape == (2,) and np.isfinite(r["loss"]).all()
        assert r["ranks_agree"]
        np.testing.assert_array_equal(r["loss"], res[0]["loss"])
        assert all(s[0] == 1 for s in r["cs_shapes"])
    cfg = reduce_for_smoke(get_config("deepseek-v2-lite-16b"))
    sizes = tuple(int(np.prod(p.shape)) for p in
                  T.leaves(TM.abstract_params(cfg)))
    comp = make_compressor(FedConfig(exact_topk=False, error_feedback=True))
    assert res[0]["uplink_bits"] == 2 * comp.wire_bits_per_client(sizes)


def test_spatial_round_needs_its_group():
    fed = FedConfig(client_mode="vmap", client_axes=("data",), n_clients=2)
    with pytest.raises(ValueError, match="client group"):
        make_fl_round(fed, R.toy_loss)
    mesh = MM.ClientMesh(shape={"data": 4}, client_axes=("data",), rank=0,
                         device=torch.device("cpu"))
    with pytest.raises(ValueError, match="one client per rank"):
        make_fl_round(fed, R.toy_loss, mesh=mesh)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


def _smoke(name):
    cfg = dataclasses.replace(reduce_for_smoke(get_config(name)),
                              dtype="float32")
    jcfg = dataclasses.replace(jreduce(jget_config(name)), dtype="float32")
    return jcfg, cfg


def _port_loss_grads(cfg, params, toks, remat):
    leaves, td = T.flatten(params)
    req = [x.detach().clone().requires_grad_(True) for x in leaves]
    loss = TM.loss_fn(cfg, td.unflatten(req), torch.from_numpy(toks),
                      remat=remat)
    return loss.detach(), torch.autograd.grad(loss, req)


_REMAT_MODELS = ["starcoder2-3b", "deepseek-v2-lite-16b"]


@pytest.mark.parametrize("name", _REMAT_MODELS)
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_bitwise_none(name, remat):
    """Recomputing a repeat's activations in the backward changes no bit
    of the loss or of any gradient (a dense GQA model; MLA + MoE)."""
    cfg = reduce_for_smoke(get_config(name))
    params = TM.init_params(cfg, seed=0, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 48)) \
        .astype(np.int32)
    l0, g0 = _port_loss_grads(cfg, params, toks, "none")
    l1, g1 = _port_loss_grads(cfg, params, toks, remat)
    assert_bitwise(l1, l0, "loss")
    for i, (a, b) in enumerate(zip(g1, g0)):
        assert_bitwise(a, b, f"gradient {i}")


@pytest.mark.parametrize("name", _REMAT_MODELS)
def test_remat_full_vs_jax(name):
    """``loss_fn``'s default remat ("full", as JAX's) against jitted JAX's
    ``loss_fn(remat="full")`` in float32, within the zoo tests' tolerance
    (rtol 1e-5, atol 1e-5 of a leaf's largest gradient)."""
    jcfg, cfg = _smoke(name)
    jp, tp = np_model_params(jcfg, cfg)
    toks = np.random.default_rng(1).integers(0, 512, (2, 32)) \
        .astype(np.int32)
    from repro.models import model as JM
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, t: JM.loss_fn(jcfg, p, t, remat="full")))(
            jp, jnp.asarray(toks))
    loss, grads = _port_loss_grads(cfg, tp, toks, "full")
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for a, b in zip(grads, jax.tree_util.tree_leaves(jg)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()))


def test_remat_rejects_an_unknown_mode():
    cfg = reduce_for_smoke(get_config("starcoder2-3b"))
    params = TM.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        TM.loss_fn(cfg, params, torch.zeros((1, 8), dtype=torch.int32),
                   remat="offload")
