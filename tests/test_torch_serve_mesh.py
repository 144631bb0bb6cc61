"""The port's sharded serving (``launch/steps.build_prefill_step``,
``build_serve_step``, ``build_step``; the split decode layers, the
split-KV decode and the 2-D serving of the ``fsdp`` plans) against the
JAX package on the CPU.

* As data: ``skip_reason``, ``_loop_trips`` and the cache specs under
  ``cache_rules`` equal JAX's for every config and shape on the (2, 2)
  and (2, 2, 2) meshes.
* One spawn of 4 gloo ranks, a (data 2, model 2) serving mesh with no
  client axes (``tests/_torch_serve_ranks.py``), runs every case of
  :data:`R.CASES` at smoke size in float32: the prefill step and 3
  teacher-forced decode steps (or, for the long shape's split-KV cache
  and ``cache_seq_shard="model"``, 3 decode steps from seeded caches).
  Each rank's logits rows and cache shards, assembled, are held against
  JAX's whole ``prefill`` and ``decode_step``, jitted in this process
  from the same weights, tokens and caches, and against the port's own
  whole steps.
* Beside it, ONE subprocess with 8 host devices runs JAX's own sharded
  ``build_step`` bundles on its (2, 2) test mesh; where they run, the
  port is held against them too, and where they fail on this jax the
  failure is the one ROADMAP §3 records.
"""
import functools
import math
import os
import pickle
import subprocess
import sys
import textwrap
import threading
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serve_ranks as R
from _torch_parity import ThreadGroup
from _torch_tensor_ranks import draw_params
from repro.configs import available_archs as javailable
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.launch import steps as JST
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import params as JP
from repro import sharding as jshd
from repro_torch import sharding as shd
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.launch import mesh as MM
from repro_torch.launch import steps as ST
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params as PM
from test_torch_tensor import _Shape

_TESTS = Path(__file__).resolve().parent
_REPO = _TESTS.parent
SPAWN_TIMEOUT_S = 400

#: float32 tolerance of the assembled logits and cache shards, of the
#: reference's largest element: against JAX's whole steps and against the
#: port's own (measured at most 3.3e-6, the long shape's caches against
#: the port's whole step, when this was written).
TOL = 2e-5

_MESHES = {"test": MM.make_test_mesh(),
           "test_multi_pod": MM.make_test_mesh(multi_pod=True)}
PREFILL_CASES = tuple(c for c in R.CASES if R.CASES[c]["kind"] == "prefill")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# The step builder's bookkeeping and the cache specs, as data
# ---------------------------------------------------------------------------


def test_skip_reason_and_loop_trips_equal_jax():
    """``skip_reason`` for every config and shape, and ``_loop_trips`` for
    every config and step kind (the train kind with virtual clients and
    local epochs too), are JAX's."""
    for name in javailable():
        jcfg, tcfg = jget_config(name), get_config(name)
        for sname in JST.SHAPES:
            assert ST.skip_reason(tcfg, ST.SHAPES[sname]) == \
                JST.skip_reason(jcfg, JST.SHAPES[sname]), (name, sname)
        for kind, kw in (("train", dict(local_epochs=2, n_virtual=2,
                                        kv_len=4096)),
                         ("train", dict(kv_len=512)),
                         ("prefill", dict(kv_len=32768)),
                         ("decode", {}), ("long", {})):
            assert ST._loop_trips(tcfg, kind, **kw) == \
                JST._loop_trips(jcfg, kind, **kw), (name, kind, kw)


def _stub_init(shape, rank):
    """``(mesh, groups)``: ``launch/mesh.init``'s mesh for ``rank`` of a
    serving mesh of ``shape`` (no client axes), made with no process:
    every ``new_group`` returns its ranks as a tuple, listed in
    ``groups`` in the order they were asked for."""
    made = []
    with mock.patch.object(MM.dist, "init_process_group"), \
            mock.patch.object(MM.dist, "new_group",
                              lambda ranks, **kw: made.append(tuple(ranks))
                              or tuple(ranks)):
        mesh = MM.init(math.prod(shape.values()), rank, store="unused",
                       device="cpu", client_axes=(), shape=shape)
    return mesh, made


@pytest.mark.parametrize("mesh_name", sorted(_MESHES))
@pytest.mark.parametrize("seq_shard", [None, "data", "model"])
def test_cache_specs_equal_jax(mesh_name, seq_shard):
    """``pspecs`` of every config's decode caches (``cache_meta`` at each
    decode and long shape) under ``cache_rules`` are JAX's, leaf for leaf,
    on the (2, 2) and (2, 2, 2) meshes with and without
    ``cache_seq_shard``, and so are the serve bundle's own
    ``static["cspecs"]``, built on rank 0 of each mesh
    (:func:`_stub_init`)."""
    shape = _MESHES[mesh_name]
    multi_pod = "pod" in shape
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    view, _ = _stub_init(shape, 0)
    for name in javailable():
        jcfg, tcfg = jget_config(name), get_config(name)
        for sname in ("decode_32k", "long_500k"):
            sp = ST.SHAPES[sname]
            if ST.skip_reason(tcfg, sp):
                continue
            long_mode = sp.kind == "long"
            kind = "long" if long_mode else "decode"
            jspec = JP.pspecs(
                JM.cache_meta(jcfg, sp.global_batch, sp.seq_len, long_mode),
                jshd.cache_rules(kind, multi_pod, cache_seq_shard=seq_shard),
                _Shape(shape))
            tspec = PM.pspecs(
                TM.cache_meta(tcfg, sp.global_batch, sp.seq_len, long_mode),
                shd.cache_rules(kind, multi_pod, cache_seq_shard=seq_shard),
                shape)
            want = [tuple(s) for s in jax.tree_util.tree_leaves(
                jspec, is_leaf=is_spec)]
            assert [tuple(s) for s in T.leaves(tspec)] == want, (name, sname)
            bundle = ST.build_step(tcfg, view, sname,
                                   cache_seq_shard=seq_shard)
            assert [tuple(s) for s in T.leaves(bundle.static["cspecs"])] \
                == want, (name, sname)


def test_build_step_takes_a_cut_shape():
    """``build_step`` picks the builder by the shape's kind and takes a
    cut ``ShapeSpec`` without touching ``SHAPES``; the serve bundle's
    token is this rank's rows (the long shape's whole batch), its zeroed
    caches this rank's blocks."""
    cfg = R.port_cfg("starcoder2-3b")
    view = MM.ClientMesh(shape=R.MESH, client_axes=(), rank=3,
                         device=torch.device("cpu"))
    before = dict(ST.SHAPES)
    pre = ST.build_step(cfg, view, "prefill_32k",
                        shape=ST.ShapeSpec("prefill_32k", 40, 4, "prefill"))
    assert pre.static["kind"] == "prefill" and \
        pre.batch_shapes == {"tokens": (2, 40)}
    dec = ST.build_step(cfg, view, "decode_32k",
                        shape=ST.ShapeSpec("decode_32k", 48, 4, "decode"))
    assert dec.batch_shapes == {"token": (2,)}
    caches = dec.new_caches("cpu")
    for x, p, s in zip(T.leaves(caches),
                       T.leaves(TM.cache_meta(cfg, 4, 48)),
                       T.leaves(dec.static["cspecs"])):
        assert tuple(x.shape) == PM.shard_shape(s, p.shape, R.MESH)
        assert not x.any()
    lng = ST.build_step(cfg, view, "long_500k",
                        shape=ST.ShapeSpec("long_500k", 64, 1, "long"))
    assert lng.static["kind"] == "long" and lng.batch_shapes == \
        {"token": (1,)} and lng.static["kv"].group.size == 2
    assert ST.SHAPES == before


@pytest.mark.parametrize("mesh_name", sorted(_MESHES))
def test_axis_groups_are_jax_device_order(spawn, mesh_name):
    """On the (2, 2) and (2, 2, 2) serving meshes, every rank's
    ``axis_group`` over the batch's ``("pod", "data")``, the FSDP dims'
    ``("data", "pod")``, and "data", "pod" and "model" alone: its
    ``index`` is the shard JAX places on the rank's device
    (``devices_indices_map``), its members are the ranks JAX places
    along those axes with this rank, ``order`` lists them in shard order,
    and its process group holds exactly them (``None``: every rank).
    Every rank asks ``init`` for the same groups in the same order."""
    shape = _MESHES[mesh_name]
    world = math.prod(shape.values())
    want = spawn["axis_groups"][mesh_name]
    asked = []
    for r in range(world):
        mesh, made = _stub_init(shape, r)
        asked.append(made)
        for e, idx in want.items():
            axes = (e,) if isinstance(e, str) else e
            members = [q for q in range(world) if all(
                want[a][q] == want[a][r] for a in shape if a not in axes)]
            g = mesh.axis_group(e)
            assert g.size == len(members), (e, r)
            assert g.index == idx[r], (e, r)
            in_order = [members[j] for j in (g.order or range(g.size))]
            assert [idx[q] for q in in_order] == list(range(g.size)), (e, r)
            if g.group is None:
                assert len(members) == world, (e, r)
            else:
                assert sorted(g.group) == members, (e, r)
    assert all(a == asked[0] for a in asked)
    if "pod" in shape:
        with pytest.raises(NotImplementedError, match="a group over"):
            mesh.axis_group(("data", "model"))


# ---------------------------------------------------------------------------
# The split-KV combine, ranks as threads of this process
# ---------------------------------------------------------------------------

#: decode_attention's masks: (cache slots S, window, ring, pos)
KV_MASKS = {"full": (16, None, False, 9), "window": (16, 4, False, 11),
            "ring": (8, None, True, 5), "ring_wrapped": (8, None, True, 21)}
#: the combine against JAX's whole softmax, float32, of its largest
#: element (measured at most 2.4e-7)
KV_TOL = 1e-6


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mask", sorted(KV_MASKS))
def test_split_kv_combine_matches_jax(mask, n):
    """``decode_attention`` split over ranks: each of ``n`` ranks attends over its
    contiguous slice of the slots (masked by the global slot index, the
    ring's too), the partial softmaxes combined by the all-reduced max,
    sums and contexts; the result on every rank within ``KV_TOL`` of
    JAX's whole ``decode_attention``, including a rank whose slots are
    all masked."""
    S, window, ring, pos = KV_MASKS[mask]
    rng = np.random.default_rng(3)
    q = (rng.standard_normal((2, 2, 3, 16)) * 2).astype(np.float32)
    k = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    want = np.asarray(JL.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos=jnp.int32(pos),
        window=window, ring=ring))
    held = S // n

    def rank(g):
        lo = g.index * held
        return TL.decode_attention(
            torch.from_numpy(q), torch.from_numpy(k[:, lo:lo + held]),
            torch.from_numpy(v[:, lo:lo + held]), pos=pos, S=S, lo=lo,
            group=g, window=window, ring=ring)

    for got in ThreadGroup(n).run(rank):
        assert _rel(got.numpy(), want) <= KV_TOL


# ---------------------------------------------------------------------------
# The spawn: 4 gloo ranks beside one JAX subprocess; JAX's whole steps here
# ---------------------------------------------------------------------------


def _inputs(case):
    """The case's numpy inputs from one seed: the params (the JAX
    package's init rules), the tokens, a stub frontend's embeds and, for
    a seeded case, the whole caches (N(0, 0.25))."""
    cfg = R.port_cfg(case)
    c = R.CASES[case]
    _, dec, _ = R.shapes(case, cfg)
    rng = np.random.default_rng(1)
    n = c["text"] + R.STEPS if c["kind"] == "prefill" else \
        len(c["positions"])
    toks = rng.integers(0, cfg.vocab_size, (dec.global_batch, n)) \
        .astype(np.int32)
    embeds = caches = None
    nf = R.n_front(cfg)
    if nf and c["kind"] == "prefill":
        embeds = (rng.standard_normal((dec.global_batch, nf, cfg.d_model))
                  * 0.02).astype(np.float32)
    if c["kind"] != "prefill":
        meta = TM.cache_meta(cfg, dec.global_batch, dec.seq_len,
                             c["kind"] == "long")
        caches = [(rng.standard_normal(p.shape) * 0.5).astype(np.float32)
                  for p in T.leaves(meta)]
    return dict(params=draw_params(TM.abstract_params(cfg), 0),
                tokens=toks, embeds=embeds, caches=caches)


def _seat(zeros, pre):
    """``models/model.seat_caches`` on numpy leaves."""
    out = []
    for z, p in zip(zeros, pre):
        z = np.array(z)
        if z.shape == p.shape:
            z[...] = p
        else:
            n, S = p.shape[3], z.shape[3]
            t = np.arange(max(0, n - S), n)
            z[:, :, :, t % S] = p[:, :, :, t]
        out.append(z)
    return out


def _jax_whole(case, inp):
    """JAX's whole prefill (jitted) and decode steps (jitted) of the case
    from its inputs: numpy logits and cache leaves."""
    jcfg = R.case_cfg(case, jget_config, jreduce)
    c = R.CASES[case]
    _, dec, _ = R.shapes(case, R.port_cfg(case))
    jp = jax.tree.map(jnp.asarray, inp["params"])
    toks = inp["tokens"]
    long_mode = c["kind"] == "long"
    meta = JM.cache_meta(jcfg, dec.global_batch, dec.seq_len, long_mode)
    zeros = [np.zeros(p.shape, np.float32) for p in
             jax.tree_util.tree_leaves(meta, is_leaf=JP.is_meta)]
    td = jax.tree_util.tree_structure(meta, is_leaf=JP.is_meta)
    out = {}
    if c["kind"] == "prefill":
        kw = {} if inp["embeds"] is None else {
            "frontend_embeds": jnp.asarray(inp["embeds"])}
        lg, pre = jax.jit(lambda p, t: JM.prefill(jcfg, p, t, **kw))(
            jp, jnp.asarray(toks[:, :c["text"]]))
        pre = [np.asarray(x) for x in jax.tree_util.tree_leaves(pre)]
        out["prefill_logits"], out["prefill_caches"] = np.asarray(lg), pre
        leaves = _seat(zeros, pre)
        lead = R.n_front(jcfg) if jcfg.encoder is None else 0
        steps = [(lead + c["text"] + i, toks[:, c["text"] + i])
                 for i in range(R.STEPS)]
    else:
        leaves = inp["caches"]
        steps = [(p, toks[:, i]) for i, p in enumerate(c["positions"])]
    caches = td.unflatten([jnp.asarray(x) for x in leaves])
    step = jax.jit(functools.partial(JM.decode_step, jcfg,
                                     seq_len=dec.seq_len,
                                     long_mode=long_mode))
    out["step_logits"] = []
    for pos, tok in steps:
        lg, caches = step(jp, caches, jnp.int32(pos), jnp.asarray(tok))
        out["step_logits"].append(np.asarray(lg))
    out["caches"] = [np.asarray(x) for x in jax.tree_util.tree_leaves(caches)]
    return out


@torch.inference_mode()
def _port_whole(case, inp):
    """The port's whole prefill and decode steps of the case, as
    :func:`_jax_whole`."""
    cfg = R.port_cfg(case)
    c = R.CASES[case]
    _, dec, _ = R.shapes(case, cfg)
    params = T.tree_map(lambda a: torch.from_numpy(np.array(a)),
                        inp["params"])
    toks = torch.from_numpy(inp["tokens"])
    long_mode = c["kind"] == "long"
    meta = TM.cache_meta(cfg, dec.global_batch, dec.seq_len, long_mode)
    out = {}
    if c["kind"] == "prefill":
        kw = {} if inp["embeds"] is None else {
            "frontend_embeds": torch.from_numpy(inp["embeds"])}
        lg, pre = TM.prefill(cfg, params, toks[:, :c["text"]], **kw)
        out["prefill_logits"] = lg.numpy()
        out["prefill_caches"] = [x.numpy() for x in T.leaves(pre)]
        caches = TM.seat_caches(PM.materialize(meta, 0, "float32"), pre)
        lead = R.n_front(cfg) if cfg.encoder is None else 0
        steps = [(lead + c["text"] + i, toks[:, c["text"] + i])
                 for i in range(R.STEPS)]
    else:
        caches = T.flatten(meta)[1].unflatten(
            [torch.from_numpy(x.copy()) for x in inp["caches"]])
        steps = [(p, toks[:, i]) for i, p in enumerate(c["positions"])]
    out["step_logits"] = [TM.decode_step(cfg, params, caches, pos, tok,
                                         seq_len=dec.seq_len,
                                         long_mode=long_mode)[0].numpy()
                          for pos, tok in steps]
    out["caches"] = [x.numpy() for x in T.leaves(caches)]
    return out


_JAX_SUB = textwrap.dedent("""
    import functools, pickle, sys, traceback
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro import sharding as shd
    from repro.configs import get_config, reduce_for_smoke
    from repro.launch import steps as ST
    from repro.launch.mesh import make_test_mesh
    from repro.models import model as JM
    from repro.models import params as JP
    sys.path.insert(0, sys.argv[1])
    import _torch_serve_ranks as R

    def where(e):
        tb = [f for f in traceback.extract_tb(e.__traceback__)
              if "/src/repro/" in f.filename]
        f = tb[-1] if tb else None
        at = (f.filename.split("/src/")[-1] + ":" + str(f.lineno)) if f \\
            else ""
        return {"error": type(e).__name__, "at": at,
                "message": str(e).splitlines()[0][:300] if str(e) else ""}

    def seat(zeros, pre):
        out = []
        for z, p in zip(zeros, pre):
            z = np.array(z)
            if z.shape == p.shape:
                z[...] = p
            else:
                n, S = p.shape[3], z.shape[3]
                t = np.arange(max(0, n - S), n)
                z[:, :, :, t % S] = p[:, :, :, t]
            out.append(z)
        return out

    with open(sys.argv[2], "rb") as f:
        inputs = pickle.load(f)
    mesh = make_test_mesh()
    out = {}
    for case, inp in inputs.items():
        c = R.CASES[case]
        cfg = R.case_cfg(case, get_config, reduce_for_smoke)
        pre_shape, dec_shape, seq_shard = R.shapes(case, cfg)
        pre_shape = pre_shape and ST.ShapeSpec(*[getattr(pre_shape, k) for
                                                 k in ("name", "seq_len",
                                                       "global_batch",
                                                       "kind")])
        dec_shape = ST.ShapeSpec(*[getattr(dec_shape, k) for k in
                                   ("name", "seq_len", "global_batch",
                                    "kind")])
        rec = {}
        params = jax.tree.map(jnp.asarray, inp["params"])
        toks = inp["tokens"]
        long_mode = c["kind"] == "long"
        meta = JM.cache_meta(cfg, dec_shape.global_batch,
                             dec_shape.seq_len, long_mode)
        td = jax.tree_util.tree_structure(meta, is_leaf=JP.is_meta)
        zeros = [np.zeros(p.shape, np.float32) for p in
                 jax.tree_util.tree_leaves(meta, is_leaf=JP.is_meta)]
        leaves = inp["caches"]
        if c["kind"] == "prefill":
            batch = {"tokens": jnp.asarray(toks[:, :c["text"]])}
            if inp["embeds"] is not None:
                batch["embeds"] = jnp.asarray(inp["embeds"])
            pre = None
            try:
                with compat.set_mesh(mesh):
                    b = ST.build_prefill_step(
                        cfg, mesh, pre_shape, plan=shd.plan_for(c["model"]))
                    jfn = compat.jit(b.fn, in_shardings=b.in_shardings,
                                     out_shardings=b.out_shardings)
                    lg, pre = jfn(params, batch)
                    pre = [np.asarray(x) for x in
                           jax.tree_util.tree_leaves(pre)]
                rec["prefill"] = {"logits": np.asarray(lg)}
            except Exception as e:
                rec["prefill"] = where(e)
            if pre is None:
                # the decode from the whole prefill's caches
                kw = {} if inp["embeds"] is None else {
                    "frontend_embeds": batch["embeds"]}
                _, pre = jax.jit(lambda p, t: JM.prefill(
                    cfg, p, t, **kw))(params, batch["tokens"])
                pre = [np.asarray(x) for x in
                       jax.tree_util.tree_leaves(pre)]
            leaves = seat(zeros, pre)
            lead = R.n_front(cfg) if cfg.encoder is None else 0
            steps = [(lead + c["text"] + i, toks[:, c["text"] + i])
                     for i in range(R.STEPS)]
        else:
            steps = [(p, toks[:, i]) for i, p in enumerate(c["positions"])]
        caches = td.unflatten([jnp.asarray(x) for x in leaves])
        with compat.set_mesh(mesh):
            try:
                b = ST.build_serve_step(cfg, mesh, dec_shape,
                                        plan=shd.plan_for(c["model"]),
                                        cache_seq_shard=seq_shard)
                jfn = compat.jit(b.fn, in_shardings=b.in_shardings,
                                 out_shardings=b.out_shardings)
                logits = []
                for pos, tok in steps:
                    lg, caches = jfn(params, caches, jnp.int32(pos),
                                     jnp.asarray(tok))
                    # host arrays between steps (ROADMAP §3: a sharded
                    # output fed back fails elsewhere on this jax)
                    caches = jax.tree.map(
                        lambda a: jnp.asarray(jax.device_get(a)), caches)
                    logits.append(np.asarray(lg))
                rec["decode"] = {"step_logits": logits}
            except Exception as e:
                rec["decode"] = where(e)
        out[case] = rec
    # the shard of a dim split over each entry, at every device position
    # (rank) of the two test meshes
    from jax.sharding import NamedSharding, PartitionSpec
    groups = {}
    for name, multi_pod in (("test", False), ("test_multi_pod", True)):
        m = make_test_mesh(multi_pod=multi_pod)
        devs = list(np.asarray(m.devices).reshape(-1))
        rec = {}
        for e in (("pod", "data"), ("data", "pod"), "data", "pod", "model"):
            axes = (e,) if isinstance(e, str) else e
            if not all(a in m.shape for a in axes):
                continue
            n = int(np.prod([m.shape[a] for a in axes]))
            idx = NamedSharding(m, PartitionSpec(e)).devices_indices_map(
                (n,))
            rec[e] = [idx[d][0].start or 0 for d in devs]
        groups[name] = rec
    with open(sys.argv[3], "wb") as f:
        pickle.dump({"cases": out, "axis_groups": groups}, f)
""")


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """``{"inputs", "ranks", "jax", "port", "jax_sharded",
    "axis_groups"}``: every case's inputs; the 4 ranks' records; JAX's
    whole steps and the port's, computed here while the ranks and the JAX
    subprocess (JAX's sharded bundles, 8 host devices) run; and from that
    subprocess, each test mesh's shard index of every rank under a
    ``PartitionSpec`` entry of its axes."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    inputs = {case: _inputs(case) for case in R.CASES}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=8", PYTHONPATH=str(_REPO / "src"), JAX_PLATFORMS="cpu")
    sub = subprocess.Popen([sys.executable, "-c", _JAX_SUB, str(_TESTS),
                            str(tmp / "inputs.pkl"), str(tmp / "jax.pkl")],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    got = {}

    def ranks():
        try:
            got["ranks"] = MM.run_ranks(
                R.on_group, R.WORLD, store=str(tmp / "store"),
                args=(inputs,), timeout_s=SPAWN_TIMEOUT_S)
        except BaseException as e:          # re-raised below
            got["error"] = e

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        jax_whole = {case: _jax_whole(case, inp)
                     for case, inp in inputs.items()}
        port = {case: _port_whole(case, inp) for case, inp in inputs.items()}
        thread.join(SPAWN_TIMEOUT_S)
        _, err = sub.communicate(timeout=SPAWN_TIMEOUT_S)
    finally:
        thread.join(SPAWN_TIMEOUT_S)
        if sub.poll() is None:
            sub.kill()
            sub.communicate()
    if "error" in got:
        raise got["error"]
    ranks = got["ranks"]
    assert sub.returncode == 0, err[-4000:]
    with open(tmp / "jax.pkl", "rb") as f:
        sharded = pickle.load(f)
    return dict(inputs=inputs, ranks=ranks, jax=jax_whole, port=port,
                jax_sharded=sharded["cases"],
                axis_groups=sharded["axis_groups"])


def _rows(spawn, case, key, i=None):
    """Every row's ``key`` (a step's with ``i``), assembled from the ranks
    in row order (the ranks of one row agree bit for bit)."""
    parts = {}
    for rk in spawn["ranks"]:
        rec = rk["cases"][case]
        x = rec[key] if i is None else rec[key][i]
        r0 = rec["rows"][0]
        if r0 in parts:
            np.testing.assert_array_equal(parts[r0], x)
        parts[r0] = x
    return np.concatenate([parts[r] for r in sorted(parts)])


def _assembled(spawn, case, key, meta, specs):
    """The whole cache leaves from every rank's shards (``key``), each
    placed at its block (``models/params.shard_block``); replicas agree
    bit for bit."""
    out = []
    leaves = T.leaves(meta)
    for j, (p, spec) in enumerate(zip(leaves, T.leaves(specs))):
        whole = np.full(p.shape, np.nan, np.float32)
        for rk in spawn["ranks"]:
            view = MM.ClientMesh(shape=R.MESH, client_axes=(),
                                 rank=rk["rank"], device=torch.device("cpu"))
            blk = PM.shard_block(spec, p.shape, view)
            x = rk["cases"][case][key][j]
            seen = whole[blk]
            if not np.isnan(seen).all():
                np.testing.assert_array_equal(seen, x)
            whole[blk] = x
        assert not np.isnan(whole).any()
        out.append(whole)
    return out


def _specs(case, prefill: bool):
    cfg = R.port_cfg(case)
    pre, dec, seq_shard = R.shapes(case, cfg)
    if prefill:
        n = pre.seq_len if cfg.encoder is None else R.CASES[case]["text"]
        meta = TM.prefill_cache_meta(cfg, pre.global_batch, n)
        return meta, PM.pspecs(meta, shd.cache_rules("decode", False),
                               R.MESH)
    long_mode = dec.kind == "long"
    meta = TM.cache_meta(cfg, dec.global_batch, dec.seq_len, long_mode)
    return meta, PM.pspecs(meta, shd.cache_rules(
        "long" if long_mode else "decode", False,
        cache_seq_shard=seq_shard), R.MESH)


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_sharded_prefill_matches_whole(spawn, case):
    """The prefill step on the 4 ranks: the last logits (this rank's rows
    over the whole vocabulary) and every cache leaf (k and v of this
    rank's kv heads, or every kv head where the model axis does not
    divide them; MLA's latent; the SSD state's heads and conv tail's
    channels; the cross keys and values), assembled, within ``TOL`` of
    JAX's whole ``prefill`` and of the port's."""
    for ref in ("jax", "port"):
        want = spawn[ref][case]
        assert _rel(_rows(spawn, case, "prefill_logits"),
                    want["prefill_logits"]) <= TOL, (ref, case)
        meta, specs = _specs(case, True)
        got = _assembled(spawn, case, "prefill_caches", meta, specs)
        for j, (a, b) in enumerate(zip(got, want["prefill_caches"])):
            assert _rel(a, b) <= TOL, (ref, case, j)


@pytest.mark.parametrize("case", sorted(R.CASES))
def test_sharded_decode_matches_whole(spawn, case):
    """The serve step on the 4 ranks, three steps: each step's logits,
    assembled from the rows, within ``TOL`` of JAX's whole
    ``decode_step`` and of the port's; the greedy token equal wherever
    the reference's top two logits lie more than ``TOL`` of its largest
    apart; the caches after the last step (each token's k and v written
    on the rank that holds its slot), assembled, within ``TOL``."""
    for ref in ("jax", "port"):
        want = spawn[ref][case]
        for i, wl in enumerate(want["step_logits"]):
            got = _rows(spawn, case, "step_logits", i)
            assert _rel(got, wl) <= TOL, (ref, case, i)
            top2 = np.sort(wl, axis=-1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > TOL * np.abs(wl).max()
            assert np.array_equal(got.argmax(-1)[clear],
                                  wl.argmax(-1)[clear]), (ref, case, i)
        meta, specs = _specs(case, False)
        got = _assembled(spawn, case, "caches", meta, specs)
        for j, (a, b) in enumerate(zip(got, want["caches"])):
            assert _rel(a, b) <= TOL, (ref, case, j)


def test_fsdp_plan_serves_2d(spawn):
    """kimi-k2-1t-a32b's and jamba-1.5's ``fsdp`` serve plans run the 2-D
    form (their leaves' ``embed`` dims split over "data", multiplied as
    ``Split2D``); every other case's ``tp`` plan does not."""
    for case in R.CASES:
        want = R.CASES[case]["model"] in ("kimi-k2-1t-a32b",
                                          "jamba-1-5-large-398b")
        assert all(rk["cases"][case]["two_d"] == want
                   for rk in spawn["ranks"]), case


def test_shards_are_the_cache_specs_blocks(spawn):
    """Each rank's cache leaves have the shapes of its blocks under the
    cache specs: the batch over "data" (the long shape's whole), kv heads
    over "model" (every one for the kv-1 case), the long shape's and the
    ``cache_seq_shard`` case's slots split."""
    for case in R.CASES:
        meta, specs = _specs(case, False)
        for rk in spawn["ranks"]:
            got = [x.shape for x in rk["cases"][case]["caches"]]
            assert got == [PM.shard_shape(s, p.shape, R.MESH) for p, s in
                           zip(T.leaves(meta), T.leaves(specs))], case
    long_specs = T.leaves(_specs("gemma3-27b-long", False)[1])
    assert all(s[3] == "data" for s in long_specs)
    seq_specs = T.leaves(_specs("starcoder2-3b-seq-model", False)[1])
    assert all(s[3] == "model" and s[4] is None for s in seq_specs)


#: JAX's sharded bundles that fail on this jax (0.9.0): case -> step ->
#: (error, where).  ROADMAP §3 records them: the decode's cache write
#: (``dynamic_update_slice`` of a cache sharded otherwise than the new
#: token's k and v; GQA, MLA), and the MoE's ``jnp.repeat`` (jamba's
#: decode meets it first); mamba2's sharded steps run, and every prefill
#: without an MoE.
_GQA_WRITE = ("ShardingTypeError", "repro/models/layers.py:226")
_MOE_REPEAT = ("ValueError", "repro/models/layers.py:418")
JAX_SHARDED_FAILS = {
    case: {"decode": _GQA_WRITE} for case in (
        "starcoder2-3b", "starcoder2-3b-kv1", "whisper-base",
        "llava-next-mistral-7b", "gemma3-27b", "gemma3-27b-long",
        "starcoder2-3b-seq-model")} | {
    "deepseek-v2-lite-16b": {
        "prefill": _MOE_REPEAT,
        "decode": ("ShardingTypeError", "repro/models/layers.py:305")},
    "kimi-k2-1t-a32b": {"prefill": _MOE_REPEAT, "decode": _GQA_WRITE},
    "jamba-1-5-large-398b": {"prefill": _MOE_REPEAT,
                             "decode": _MOE_REPEAT}}


@pytest.mark.parametrize("case", sorted(R.CASES))
def test_port_matches_jax_sharded_steps(spawn, case):
    """JAX's own sharded ``build_step`` bundles on its (2, 2) test mesh:
    where they run, the port's assembled logits lie within ``TOL`` of
    theirs (the decode from caches seated from JAX's prefill, sharded
    where that ran); where they fail, the failure is the one
    ``JAX_SHARDED_FAILS`` records."""
    rec = spawn["jax_sharded"][case]
    fails = {step: (r["error"], r["at"]) for step, r in rec.items()
             if "error" in r}
    assert fails == JAX_SHARDED_FAILS.get(case, {}), (case, rec)
    if "prefill" in rec and "logits" in rec["prefill"]:
        assert _rel(_rows(spawn, case, "prefill_logits"),
                    rec["prefill"]["logits"]) <= TOL
    if "step_logits" in rec["decode"]:
        for i, wl in enumerate(rec["decode"]["step_logits"]):
            assert _rel(_rows(spawn, case, "step_logits", i), wl) <= TOL, i
