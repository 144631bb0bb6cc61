"""Dry run of every (arch x shape x mesh) step: what one rank of the
production mesh holds, computes and moves, predicted on fake tensors.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch mamba2-1-3b --shape decode_32k --mesh pod1 \\
        --out experiments/dryrun/

or ``--all`` for every arch and shape on the mesh.  Counterpart of
``repro/launch/dryrun.py``, which lowers and compiles each step with
``ShapeDtypeStruct`` arguments over 512 host devices and reads XLA's
analyses.  Here the fake world is PyTorch's: the process joins the fake
process group as rank 0 of the mesh's 256 or 512 ranks
(``launch/mesh.init(backend="fake")``, every group made as in a real
world), builds the step with ``launch/steps.build_step``, makes rank 0's
arguments as fake tensors (``models/params.abstract_shards``,
``StepBundle.args``: nothing is allocated) and runs the step once under
``FakeTensorMode`` with every collective in ``mesh.stand_in()`` (it
returns what it would if every rank held this rank's tensors).  The
fake world is global, so the process runs one mesh; ``--all`` joins it
once.

Each combo's record (``<arch>__<shape>__<mesh>.json`` under ``--out``):

* ``status``: ``ok``, ``skip`` with ``steps.skip_reason``'s text, or
  ``error`` with its traceback;
* ``t_build_s``, ``t_run_s``: building the step and its arguments, and
  the fake step (the JAX record's lower and compile);
* ``memory``: this rank's argument bytes (params, the train state beyond
  them, batch, caches) and ``peak_per_device_bytes``, the peak of the
  live storages on the step's device over the step, arguments included
  (:class:`StepCounter`);
* ``flops``: ``FlopCounterMode``'s total for the rank.  It counts matrix
  products, convolutions and attention only; XLA's ``cost_analysis``
  counts every operation;
* ``bytes_accessed``: for every device operation the bytes it reads plus
  the bytes it writes (each tensor argument read once, each output
  written once; views, aliases, ``empty`` and queries such as
  ``.device`` move nothing), and each
  kernel launch's (``kernels.PREDICTED_BYTES``).  Eager PyTorch fuses
  nothing, so this is what the step moves;
* ``collectives``: bytes and calls per kind and per group, each group's
  ranks, and ``total`` (``launch/mesh.COLLECTIVES``; the JAX record's
  trimmed HLO);
* ``launches_predicted``: the kernel launches the fake calls stood for;
* ``roofline``: ``roofline.Roofline(...).row()``, its three terms and
  the bottleneck; ``model_flops``, ``n_params``, ``n_active``, ``plan``
  as the JAX record has them.

The step is traced on fake CUDA tensors where PyTorch has CUDA.  A build
without it (autograd takes no fake CUDA tensor there) traces fake CPU
tensors that stand for the card's: the kernel wrappers take their card
branch (the ``FakeTensorMode`` is marked by ``kernels/_check.card_mode``)
and the train step the kernel sparsify backend, as on the card.
:func:`run_one` with ``device="cpu"`` predicts a CPU run instead (the
plain versions; the tests hold it to a real one).  :func:`count_step`
runs a real step under the same counters.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import kernels as K
from repro_torch import roofline as RL
from repro_torch import sharding as shd
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._check import card_mode
from repro_torch.launch import mesh as MM
from repro_torch.launch import steps as ST
from repro_torch.models import model as M
from repro_torch.models import params as PM

#: Mesh name -> shape: JAX's production meshes, and its test mesh.
MESHES = {"pod1": MM.make_production_mesh(),
          "pod2": MM.make_production_mesh(multi_pod=True),
          "test": MM.make_test_mesh()}

_aten = torch.ops.aten
#: Operations that move no bytes: they allocate, or alias their input
#: without their schema saying so.
_NO_MOVE = {_aten.empty.memory_format, _aten.empty_strided.default,
            _aten.empty_like.default, _aten.new_empty.default,
            _aten.new_empty_strided.default, _aten._unsafe_view.default,
            _aten.lift_fresh.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _flat_tensors(values) -> list:
    """The tensors of an operation's arguments or outputs: tensors, and
    lists or tuples of them (an operator's arguments nest no deeper)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(x for x in v if isinstance(x, torch.Tensor))
    return out


def _moves(func) -> bool:
    """Whether an operation moves bytes: not an allocation, a view or an
    alias its schema declares (an in-place or ``out=`` operation writes)."""
    schema = func._schema
    alias = any(r.alias_info is not None for r in schema.returns)
    return not (func in _NO_MOVE or func.is_view
                or (alias and not schema.is_mutable))


class StepCounter(TorchDispatchMode):
    """While entered: ``bytes_accessed``, each device operation's bytes
    read and written (the module docstring), and the live bytes of the
    storages on ``device_type``, with their ``peak``.  A storage counts
    from the operation that made it (or :meth:`hold`) until it is
    freed."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._refs = {}
        self._moves = {}

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (the step's arguments)
        as live; returns the bytes that were new."""
        before = self.live
        for t in _tensors(tree):
            self._track(t)
        return self.live - before

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n):
            self._refs.pop(key, None)
            self.live -= n

        self._refs[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _flat_tensors(out if isinstance(out, (list, tuple))
                             else (out,))
        for t in outs:
            self._track(t)
        moves = self._moves.get(func)
        if moves is None:
            moves = self._moves[func] = _moves(func)
        if outs and moves:
            dev = self.device_type
            self.bytes_accessed += sum(
                _nbytes(t) for t in (*_flat_tensors(args),
                                     *_flat_tensors(kwargs.values()), *outs)
                if t.device.type == dev)
        return out


def count_step(fn, args, *, device_type: str, mode=None) -> dict:
    """``fn(*args)`` once under the counters (``mode``: the
    ``FakeTensorMode`` the arguments were made under, entered around the
    step; real tensors without one): ``flops`` (``FlopCounterMode``),
    ``bytes_accessed`` (:class:`StepCounter` plus the predicted kernel
    launches'), ``peak_bytes`` (arguments included), ``arg_bytes``, the
    collectives (``mesh.collective_summary``), the kernel ``launches``
    and ``launches_predicted``, ``t_run_s``; and the step's ``out``."""
    K.reset_launches()
    MM.reset_collectives()
    counter = StepCounter(device_type)
    arg_bytes = counter.hold(args)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with (mode or contextlib.nullcontext()), flops, counter:
        out = fn(*args)
    return {
        "out": out, "t_run_s": time.perf_counter() - t0,
        "flops": flops.get_total_flops(),
        "bytes_accessed": counter.bytes_accessed
        + sum(K.PREDICTED_BYTES.values()),
        "peak_bytes": counter.peak, "arg_bytes": arg_bytes,
        "collectives": MM.collective_summary(),
        "launches": {k: v for k, v in K.LAUNCHES.items() if v},
        "launches_predicted": {k: v for k, v in K.PREDICTED.items() if v}}


_WORLD: dict = {}


def world(mesh_name: str, device) -> MM.ClientMesh:
    """Rank 0 of the fake world of ``MESHES[mesh_name]`` on ``device``,
    with no client axes (every group of ``mesh.init``, the serving
    meshes' per-axis groups included); joined once per process and mesh
    (another mesh leaves the first)."""
    key = (mesh_name, str(device))
    if key not in _WORLD:
        if dist.is_initialized():
            dist.destroy_process_group()
            _WORLD.clear()
        shape = MESHES[mesh_name]
        _WORLD[key] = MM.init(math.prod(shape.values()), 0, backend="fake",
                              device=device, shape=shape, client_axes=())
    return _WORLD[key]


def target(device=None):
    """``(trace device, as_card)``: the card's steps (``device`` None) on
    fake CUDA tensors where PyTorch has CUDA, else on fake CPU tensors
    that stand for the card's; ``"cpu"``: a CPU run's."""
    if device is not None:
        return torch.device(device), False
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device()), False
    return torch.device("cpu"), True


def build(cfg: ArchConfig, shape: ST.ShapeSpec, mesh: MM.ClientMesh,
          as_card: bool = False, **build_kw) -> ST.StepBundle:
    """The step of ``cfg`` at ``shape`` on the fake world ``mesh``: the
    spatial plans' train step on its client axes, every other on no
    client axes (``as_card``: the kernel sparsify backend, the card's
    ``auto``)."""
    plan = build_kw.get("plan") or shd.plan_for(cfg.name)
    if shape.kind == "train" and plan.clients == "spatial":
        mesh = dataclasses.replace(
            mesh, client_axes=shd.client_axes("pod" in mesh.shape))
    if as_card and shape.kind == "train":
        build_kw.setdefault("sparsify_backend", "kernel")
    return ST.build_step(cfg, mesh, shape.name, shape=shape, **build_kw)


def _arg_bytes(kind: str, args) -> dict:
    """The step's arguments' bytes by part."""
    size = lambda tree: sum(_nbytes(t) for t in _tensors(tree))
    if kind == "train":
        state, batch = args
        params = size(state.W)
        return {"params": params, "state": size(state) - params,
                "batch": size(batch)}
    if kind == "prefill":
        return {"params": size(args[0]), "batch": size(args[1])}
    return {"params": size(args[0]), "caches": size(args[1]),
            "batch": size(args[3])}


def run_one(arch: str, shape_name: str, mesh_name: str,
            out_dir: Optional[Path] = None, *,
            cfg: Optional[ArchConfig] = None,
            shape: Optional[ST.ShapeSpec] = None, device=None,
            **build_kw) -> dict:
    """The record of one combo (the module docstring).  ``cfg`` and
    ``shape`` override ``arch``'s config and ``SHAPES[shape_name]`` (a
    cut); ``device``: None predicts the card's step, ``"cpu"`` a CPU
    run's.  ``out_dir`` is not written (``main`` writes the record)."""
    cfg = cfg or get_config(arch)
    shape = shape or ST.SHAPES[shape_name]
    rec: dict = dict(arch=arch, shape=shape_name, mesh=mesh_name,
                     status="ok")
    reason = ST.skip_reason(cfg, shape)
    if reason:
        rec.update(status="skip", reason=reason)
        return rec
    dev, as_card = target(device)
    mesh = world(mesh_name, dev)
    rec.update(chips=mesh.world_size, trace_device=dev.type,
               as_card=as_card)
    t0 = time.perf_counter()
    bundle = build(cfg, shape, mesh, as_card, **build_kw)
    mode = card_mode(FakeTensorMode()) if as_card else FakeTensorMode()
    with mode:
        args = bundle.args(PM.abstract_shards(
            M.abstract_params(cfg), bundle.static["pspecs"], mesh,
            cfg.dtype, mode=mode, device=dev), dev)
    t_build = time.perf_counter() - t0
    with MM.stand_in():
        res = count_step(bundle.fn, args, device_type=dev.type, mode=mode)
    kind = bundle.static["kind"]
    fed = bundle.static.get("fed")
    model_flops = RL.analytic_model_flops(
        cfg, "decode" if kind == "long" else kind, shape.seq_len,
        shape.global_batch, local_epochs=(fed.local_epochs if fed else 1),
        n_virtual_clients=(bundle.static.get("n_clients", 1)
                           if fed and fed.client_mode == "scan" else 1))
    coll = res["collectives"]
    roof = RL.Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name,
        chips=mesh.world_size, flops=res["flops"],
        mem_bytes=res["bytes_accessed"],
        coll_groups={g: (v["bytes"], tuple(coll["groups"][g]))
                     for g, v in coll["by_group"].items()},
        model_flops=model_flops, dtype=cfg.dtype)
    rec.update(
        t_build_s=round(t_build, 1), t_run_s=round(res["t_run_s"], 1),
        memory=dict(argument_bytes=_arg_bytes(kind, args),
                    peak_per_device_bytes=res["peak_bytes"]),
        flops=res["flops"], bytes_accessed=res["bytes_accessed"],
        collectives=coll, launches_predicted=res["launches_predicted"],
        model_flops=model_flops, n_params=cfg.param_count(),
        n_active=cfg.active_param_count(),
        plan=str(bundle.static.get("plan") or ""),
        roofline=roof.row())
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(ST.SHAPES))
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--algorithm", default="fedadam_ssm")
    ap.add_argument("--aggregate", default=None)
    ap.add_argument("--local-epochs", type=int, default=2)
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--serve-params", default=None,
                    choices=[None, "tp", "fsdp"],
                    help="override the deploy plan's serving param rules")
    ap.add_argument("--cache-seq-shard", default=None,
                    help="mesh axis (or comma tuple) to shard decode cache "
                         "sequence dim — split-KV decode optimization")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    if args.all:
        combos = [(a, s) for a in ASSIGNED_ARCHS for s in ST.SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        combos = [(args.arch, args.shape)]
    rc = 0
    for arch, shape in combos:
        kw: dict = {}
        if ST.SHAPES[shape].kind == "train":
            kw.update(algorithm=args.algorithm, alpha=args.alpha,
                      local_epochs=args.local_epochs, remat=args.remat)
            if args.aggregate:
                kw["aggregate"] = args.aggregate
        else:
            if args.cache_seq_shard and ST.SHAPES[shape].kind != "prefill":
                css = tuple(args.cache_seq_shard.split(","))
                kw["cache_seq_shard"] = css if len(css) > 1 else css[0]
            if args.serve_params:
                kw["plan"] = dataclasses.replace(
                    shd.plan_for(arch), serve_params=args.serve_params)
        name = f"{arch}__{shape}__{args.mesh}{args.tag}"
        try:
            rec = run_one(arch, shape, args.mesh, out_dir, **kw)
        except Exception as e:  # noqa: BLE001 — record the failure
            rec = dict(arch=arch, shape=shape, mesh=args.mesh,
                       status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
            rc = 1
        out_dir.mkdir(parents=True, exist_ok=True)
        # whole or absent: a reader may be waiting for the file
        tmp = out_dir / f".{name}.json.tmp"
        tmp.write_text(json.dumps(rec, indent=1))
        os.replace(tmp, out_dir / f"{name}.json")
        status = rec["status"]
        extra = ""
        if status == "ok":
            peak = rec["memory"]["peak_per_device_bytes"]
            extra = (f"run={rec['t_run_s']}s "
                     f"flops={rec['flops'] / 1e12:.2f}T "
                     f"coll={rec['collectives']['total'] / 1e9:.2f}GB "
                     f"mem/dev={peak / 1e9:.2f}GB "
                     f"bound={rec['roofline']['bottleneck']}")
        elif status == "error":
            extra = rec["error"][:200]
        print(f"[dryrun] {name}: {status} {extra}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    sys.exit(main())
