"""The port's dry run (``launch/dryrun.py``), its stand-in collectives and
counters (``launch/mesh.py``) and the kernel wrappers' fake branch, on the
CPU.

* One process of its own joins a fake (data 2, model 2) world
  (``mesh.init(backend="fake")``) and, for a smoke train step
  (starcoder2-3b, spatial/tp) and a smoke decode step (kimi-k2, its
  fsdp plan's 2-D serving), predicts rank 0's step on fake tensors, then
  runs the same rank's real CPU step in stand-in mode under the same
  counters: the FLOPs, the tracked peak and the collectives are equal.
  Beside it a real 4-rank gloo group runs the same steps: rank 0's
  counted collectives (bytes and calls per kind and group) equal the
  prediction's (``tests/_torch_dryrun_ranks.py``).
* The command line on one production combo writes JAX's record keys and
  the port's, and a skipped combo carries JAX's reason.
* The stand-in collectives return what every rank holding this rank's
  tensors would give (or, with bounded sums, this rank's part), and
  count as the real ones do.
* A fake tensor never reaches the kernel library: with its launcher and
  its calls made to raise, every wrapper's fake branch allocates its
  kernel's outputs and counts a predicted launch; a real CPU tensor still
  takes the plain version.
"""
import json
import math
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

import _torch_dryrun_ranks as R
import _torch_parity  # noqa: F401  (one torch thread)
from repro_torch import kernels as K
from repro_torch.kernels import _lib
from repro_torch.kernels._check import card_mode, on_cpu
from repro_torch.kernels.fused_adam import ops as FA
from repro_torch.kernels.packed_topk import ops as PT
from repro_torch.kernels.ssm_apply import ops as SA
from repro_torch.kernels.topk_mask import ops as TM
from repro_torch.kernels.wirepack import ops as WP
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MM
from repro_torch.launch import steps as ST

REPO = Path(__file__).resolve().parents[1]
CLI_COMBO = ("mamba2-1-3b", "decode_32k")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The fake world's predictions and real CPU steps, the gloo group's
    steps and the command line's record, spawned side by side."""
    out, errors = {}, []
    out_dir = tmp_path_factory.mktemp("dryrun")

    def spawn(key, fn, world, cases=tuple(R.CASES)):
        try:
            out[key] = MM.run_ranks(
                fn, world, store=str(tmp_path_factory.mktemp(key) / "store"),
                args=(list(cases),), timeout_s=300)[0]
        except BaseException as e:      # re-raised below
            errors.append(e)

    def cli():
        arch, shape = CLI_COMBO
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
        out["cli"] = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "pod1", "--out",
             str(out_dir)], env=env, capture_output=True, text=True,
            timeout=300)
        out["cli_record"] = out_dir / f"{arch}__{shape}__pod1.json"

    threads = [threading.Thread(target=spawn,
                                args=("fake", R.fake_vs_real, 1)),
               threading.Thread(target=spawn, args=("gloo", R.gloo_rank,
                                                    R.WORLD)),
               threading.Thread(target=spawn, args=(
                   "algorithms", R.algorithms, 1, R.ALG_CASES)),
               threading.Thread(target=cli)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("name", sorted(R.CASES))
def test_fake_step_predicts_the_real_cpu_step(runs, name):
    got = runs["fake"][name]
    pred, real = got["predicted"], got["real"]
    assert pred["status"] == "ok", pred
    assert pred["trace_device"] == "cpu" and not pred["as_card"]
    assert pred["flops"] > 0 and pred["flops"] == real["flops"]
    assert pred["memory"]["peak_per_device_bytes"] == real["peak_bytes"]
    assert sum(pred["memory"]["argument_bytes"].values()) == \
        real["arg_bytes"]
    assert pred["bytes_accessed"] == real["bytes_accessed"]
    assert pred["collectives"] == real["collectives"]
    assert pred["collectives"]["total"] > 0
    # the CPU step runs the plain versions: nothing launched or predicted
    assert pred["launches_predicted"] == {} == real["launches"]
    assert got["finite"]


@pytest.mark.parametrize("name", sorted(R.CASES))
def test_predicted_collectives_equal_a_real_gloo_rank(runs, name):
    pred = runs["fake"][name]["predicted"]["collectives"]
    gloo = runs["gloo"][name]
    assert pred == gloo["collectives"]
    assert runs["fake"][name]["real"]["flops"] == gloo["flops"]
    assert runs["fake"][name]["real"]["peak_bytes"] == gloo["peak_bytes"]
    groups = set(pred["by_group"])
    assert groups == ({"data", "model"})
    assert pred["groups"]["model"] == [0, 1] and \
        pred["groups"]["data"] == [0, 2]


def _leaf_blocks(arch):
    """Per split kind of the smoke config's leaves on the (2, 2) mesh
    under its plan's train rules: the leaves, and the 4-byte words of
    their whole leaves' 1024-element quantizer blocks."""
    from repro_torch import sharding as shd
    from repro_torch import tree as T
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import model as M
    from repro_torch.models import params as PM
    meta = M.abstract_params(reduce_for_smoke(get_config(arch)))
    specs = PM.pspecs(meta, shd.param_rules(
        shd.plan_for(arch).train_params, False), R.MESH)
    out = {}
    for p, kind in zip(T.leaves(meta), PM.split_kinds(specs, R.MESH)):
        n, words = out.get(kind, (0, 0))
        out[kind] = (n + 1, words + -(-math.prod(p.shape) // 1024))
    return out


def _group(rec, name):
    return rec["collectives"]["by_group"].get(name, {"bytes": 0, "calls": 0})


@pytest.mark.parametrize("case", [f"{a}:{b}" for a, b in R.ALG_CASES])
def test_dry_run_predicts_every_algorithm(runs, case):
    """Every compressor's train step on split leaves gives a dry-run
    record (the smoke configs on the fake (2, 2) world, tracing fake
    tensors that stand for the card's), whose collectives are the
    analytic count beside FedAdam's on the same plan:

    * the tp plan's dense fold all-gathers C x 3 carriers of this rank's
      shards over the client group, and the 7 metrics;
    * Efficient-Adam and 1-bit Adam add, per client and split leaf, one
      all-reduce of the whole leaf's (nb,) float32 block partials over
      the leaf's group; FedSGD adds nothing (one local epoch: the same
      loss);
    * ``fairness_top`` adds one all-reduce of every model-split leaf's
      three float64 sums of squares, and per such leaf ``select_tau``'s
      absmax (float32) and two 32-candidate float64 counts; its kernels
      launch once per leaf and pass (absmax, two counts, ssm_apply_ef)."""
    arch, alg = case.split(":")
    rec = runs["algorithms"][(arch, alg)]
    assert rec["status"] == "ok", rec.get("traceback", rec)
    assert rec["memory"]["peak_per_device_bytes"] > 0
    base = runs["algorithms"][(arch, "fedadam")]
    kinds = _leaf_blocks(arch)
    if arch == "starcoder2-3b":
        n_model, words = kinds["model"]
        L = sum(n for n, _ in kinds.values())
        if alg != "fairness_top":
            shard = rec["memory"]["argument_bytes"]["params"]
            C = R.MESH["data"]
            assert _group(rec, "data") == {
                "bytes": C * 3 * shard + 7 * C * 4, "calls": 3 * L + 7}
        extra = {"fedadam": (0, 0), "fedsgd": (0, 0),
                 "efficient_adam": (4 * words, n_model),
                 "onebit_adam": (4 * words, n_model),
                 "fairness_top": (24 * n_model + 516 * n_model,
                                  1 + 3 * n_model)}[alg]
        got, ref = _group(rec, "model"), _group(base, "model")
        assert (got["bytes"] - ref["bytes"], got["calls"] - ref["calls"]) \
            == extra
        if alg == "fairness_top":
            # a bfloat16 tree: its float32 scores take the selection
            # passes, and the fused apply reads them beside the bfloat16
            # streams, on every shard
            assert rec["launches_predicted"] == {
                "absmax": L, "count_ge": 2 * L, "ssm_apply_ef": L}
        return
    from repro_torch import sharding as shd
    n_virtual = shd.plan_for(arch).n_virtual
    for kind, group in (("data", "data"), ("both", "data+model"),
                        ("model", "model")):
        n, words = kinds.get(kind, (0, 0))
        extra = (0, 0) if alg == "fedadam" else \
            (4 * words * n_virtual, n * n_virtual)
        got, ref = _group(rec, group), _group(base, group)
        assert (got["bytes"] - ref["bytes"], got["calls"] - ref["calls"]) \
            == extra, (kind, got, ref)


def test_cli_record_on_the_production_mesh(runs):
    res = runs["cli"]
    assert res.returncode == 0, res.stderr[-3000:]
    arch, shape = CLI_COMBO
    assert res.stdout.startswith(f"[dryrun] {arch}__{shape}__pod1: ok ")
    rec = json.loads(runs["cli_record"].read_text())
    for key in ("arch", "shape", "mesh", "status", "chips", "model_flops",
                "n_params", "n_active", "plan", "t_build_s", "t_run_s",
                "memory", "flops", "bytes_accessed", "collectives",
                "launches_predicted", "roofline"):
        assert key in rec, key
    assert rec["chips"] == 256 and rec["status"] == "ok"
    assert rec["memory"]["peak_per_device_bytes"] >= \
        sum(rec["memory"]["argument_bytes"].values()) > 0
    assert set(rec["memory"]["argument_bytes"]) == \
        {"params", "caches", "batch"}
    roof = rec["roofline"]
    for key in ("t_compute", "t_memory", "t_collective", "bottleneck"):
        assert key in roof
    assert roof["flops"] == rec["flops"] > 0
    assert roof["coll_links"] == {"model": "infiniband"}
    assert rec["collectives"]["groups"]["model"] == list(range(16))


def test_skipped_combo_carries_the_jax_reason():
    from repro.configs import get_config as jget_config
    from repro.launch import steps as JST
    rec = D.run_one("whisper-base", "long_500k", "pod1")
    assert rec["status"] == "skip"
    assert rec["reason"] == JST.skip_reason(jget_config("whisper-base"),
                                            JST.SHAPES["long_500k"])
    assert set(D.MESHES) == {"pod1", "pod2", "test"}
    assert set(ST.SHAPES) == set(JST.SHAPES)


def test_stand_in_collectives_and_counters():
    """Every rank holding this rank's tensors: a sum is size * x, a max x,
    a gather size copies, a reduce-scatter size times this rank's chunk;
    each counted by kind and group in the bytes the backend moves."""
    mesh = MM.ClientMesh(shape={"data": 2, "model": 4},
                         client_axes=("data",), rank=5,
                         device=torch.device("cpu"))
    g = mesh.model
    assert (g.name, g.ranks, g.size, g.index) == ("model", (4, 5, 6, 7),
                                                  4, 1)
    x = torch.arange(8, dtype=torch.bfloat16).reshape(2, 4)
    MM.reset_collectives()
    with MM.stand_in():
        assert torch.equal(g.all_reduce(x), x * 4)
        assert torch.equal(g.all_reduce(x, "max"), x)
        assert torch.equal(g.all_gather(x, 1), torch.cat([x] * 4, 1))
        assert torch.equal(g.reduce_scatter(x, 1), 4 * x[:, 1:2])
        assert torch.equal(mesh.all_gather(x), torch.stack([x] * 2))
    summary = MM.collective_summary()
    assert summary["by_kind"] == {
        "all_reduce": {"bytes": 2 * 8 * 4, "calls": 2},
        "all_gather": {"bytes": 4 * 16 + 2 * 16, "calls": 2},
        "reduce_scatter": {"bytes": 8 * 4, "calls": 1}}
    assert summary["groups"] == {"model": [4, 5, 6, 7], "data": [1, 5]}
    assert summary["total"] == 64 + 96 + 32
    MM.reset_collectives()
    assert MM.collective_summary()["total"] == 0


def test_stand_in_bounded_sums():
    """With bounded sums a sum gives this rank's part and a reduce-scatter
    its chunk (a max and a gather as before), and the counters count what
    the unbounded stand-in counts."""
    mesh = MM.ClientMesh(shape={"data": 2, "model": 4},
                         client_axes=("data",), rank=5,
                         device=torch.device("cpu"))
    g = mesh.model
    x = torch.arange(8, dtype=torch.bfloat16).reshape(2, 4)
    summaries = []
    for bounded in (False, True):
        MM.reset_collectives()
        with MM.stand_in(bounded=bounded):
            k = 1 if bounded else 4
            assert torch.equal(g.all_reduce(x), x * k)
            assert torch.equal(g.all_reduce(x, "max"), x)
            assert torch.equal(g.all_gather(x, 1), torch.cat([x] * 4, 1))
            assert torch.equal(g.reduce_scatter(x, 1), k * x[:, 1:2])
            assert torch.equal(mesh.all_gather(x), torch.stack([x] * 2))
        summaries.append(MM.collective_summary())
    assert summaries[0] == summaries[1]
    assert summaries[0]["total"] == 64 + 96 + 32
    MM.reset_collectives()


def _wrapper_calls(dev):
    """(name, call, expected outputs as (shape, dtype)) of every kernel
    wrapper on tensors made on ``dev``."""
    f32, bf16 = torch.float32, torch.bfloat16
    x = torch.empty(3000, dtype=bf16, device=dev)
    taus = torch.empty(32, dtype=f32, device=dev)
    tau = torch.empty((), dtype=f32, device=dev)
    xp = torch.empty(16, 128, dtype=f32, device=dev)
    seg = torch.zeros(2, dtype=torch.int32, device=dev)
    edges = torch.empty(1, 32, dtype=f32, device=dev)
    ks = torch.ones(1, dtype=f32, device=dev)
    codes = torch.zeros(32, 128, dtype=torch.int32, device=dev)
    words = torch.zeros(1, 128, dtype=torch.int32, device=dev).view(
        torch.uint32)
    sc = torch.empty(4, dtype=f32, device=dev)
    return [
        ("absmax", lambda: TM.absmax(x), [((), f32)]),
        ("count_ge", lambda: TM.count_ge(taus, x), [((32,), f32)]),
        ("apply_mask", lambda: TM.apply_mask(tau, x),
         [((3000,), torch.bool)]),
        ("ssm_apply_ef", lambda: SA.ssm_apply_ef(tau, x, x, x),
         [((3000,), bf16)] * 4),
        ("ssm_apply", lambda: SA.ssm_apply(tau, x, x, x),
         [((3000,), bf16)] * 3),
        ("fused_adam", lambda: FA.fused_adam_apply(sc, x, x, x, x),
         [((3000,), bf16)] * 3),
        ("packed_hist", lambda: PT.packed_hist(xp, seg, edges),
         [((1, 32), f32)]),
        ("packed_apply", lambda: PT.packed_apply(edges, seg, ks, ks, (xp,)),
         [((16, 128), f32)] * 2 + [((1, 1), f32)] * 2),
        ("pack_words", lambda: WP.pack_words(codes, 1),
         [((1, 128), torch.uint32)]),
        ("unpack_words", lambda: WP.unpack_words(words, 1),
         [((32, 128), torch.int32)]),
    ]


def _refuse(*args):
    raise AssertionError("the kernel library was reached")


@pytest.mark.parametrize("device", ["cuda", "cpu_as_card"])
def test_fake_tensors_never_reach_the_library(monkeypatch, device):
    monkeypatch.setattr(_lib, "launch", _refuse)
    monkeypatch.setattr(_lib, "call", _refuse)
    dev = "cuda" if device == "cuda" else "cpu"
    mode = card_mode(FakeTensorMode()) if device == "cpu_as_card" \
        else FakeTensorMode()
    K.reset_launches()
    with mode:
        calls = _wrapper_calls(dev)
        for name, call, expected in calls:
            out = call()
            outs = out if isinstance(out, tuple) else (out,)
            assert [(tuple(o.shape), o.dtype) for o in outs] == expected, \
                name
            assert all(isinstance(o, FakeTensor) and o.device.type == dev
                       for o in outs), name
            assert K.PREDICTED[name] == 1, name
    # packed_apply's count is packed_hist's kernel, as on the card
    assert K.PREDICTED["packed_hist"] == 2
    assert sum(K.LAUNCHES.values()) == 0
    assert K.PREDICTED_BYTES["absmax"] == 3000 * 2 + 4
    assert K.PREDICTED_BYTES["pack_words"] == 32 * 128 * 4 + 128 * 4


def test_real_cpu_tensors_take_the_plain_versions(monkeypatch):
    monkeypatch.setattr(_lib, "launch", _refuse)
    monkeypatch.setattr(_lib, "call", _refuse)
    K.reset_launches()
    # a fake CPU tensor of a card mode takes the card branch; a real CPU
    # tensor beside it still takes the plain version
    with card_mode(FakeTensorMode()):
        assert not on_cpu(torch.empty(3000, dtype=torch.bfloat16))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3000, generator=g).to(torch.bfloat16)
    assert on_cpu(x)
    assert torch.equal(TM.absmax(x), TM.absmax_plain(x))
    taus = torch.linspace(1.0, 0.0, 32)
    assert torch.equal(TM.count_ge(taus, x), TM.count_ge_plain(taus, x))
    tau = torch.tensor(0.5)
    for a, b in zip(SA.ssm_apply_ef(tau, x, x, x),
                    SA.ssm_apply_ef_plain(tau, x, x, x)):
        assert torch.equal(a, b)
    assert sum(K.PREDICTED.values()) == 0 == sum(K.LAUNCHES.values())
