"""What the spawned processes of tests/test_torch_dryrun.py run: the
port's dry run (``launch/dryrun.py``) of a smoke step on a (data 2, model
2) fake world, the same rank's real CPU step under the same counters,
and the same step on a real 4-rank gloo group.  It imports no jax, so
that a spawned process starts quickly.

Each case (:data:`CASES`) is a smoke config at a cut shape, with the
full model's deployment plan (smoke configs have none).
"""
from __future__ import annotations

import dataclasses

import torch

MESH = {"data": 2, "model": 2}
WORLD = 4
SEED = 3

#: (arch, algorithm) of the dry run per algorithm: every compressor on
#: the tp plan's split leaves, two on the fsdp plan's, at the smoke
#: configs and a cut train shape (ALG_SEQ, ALG_BATCH), one local epoch,
#: error feedback.
ALG_CASES = tuple(("starcoder2-3b", a) for a in (
    "fedadam", "fedsgd", "efficient_adam", "onebit_adam", "fairness_top")) \
    + (("mistral-large-123b", "fedadam"),
       ("mistral-large-123b", "efficient_adam"))
ALG_SEQ, ALG_BATCH = 32, 4

#: name -> (arch, shape name, seq_len, global_batch)
CASES = {
    "train": ("starcoder2-3b", "train_4k", 32, 4),
    "decode": ("kimi-k2-1t-a32b", "decode_32k", 48, 4),
}


def case(name):
    """(arch, cfg, shape, build keywords) of a case."""
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch import steps as ST
    arch, shape_name, seq, batch = CASES[name]
    shape = dataclasses.replace(ST.SHAPES[shape_name], seq_len=seq,
                                global_batch=batch)
    kw = dict(plan=shd.plan_for(arch))
    if shape.kind == "train":
        kw.update(local_epochs=1, error_feedback=True)
    return arch, reduce_for_smoke(get_config(arch)), shape, kw


def _real_args(cfg, bundle, mesh):
    """This rank's real arguments: its shards of the seeded params, and
    tokens from the seeded global generator."""
    from repro_torch.models import model as M
    from repro_torch.models import params as PM
    params = PM.materialize_shards(M.abstract_params(cfg),
                                   bundle.static["pspecs"], mesh, SEED,
                                   cfg.dtype)
    torch.manual_seed(SEED)
    return bundle.args(params, torch.device("cpu"))


def _counted(res) -> dict:
    return {k: res[k] for k in ("flops", "peak_bytes", "bytes_accessed",
                                "arg_bytes", "collectives",
                                "launches_predicted", "launches")}


def fake_vs_real(rank, world, store, names):
    """In a process of its own: rank 0 of the fake (2, 2) world; per case
    the dry run's record of the CPU step (``device="cpu"``), then the same
    rank's real CPU step in stand-in mode under ``count_step``."""
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as MM
    out = {}
    for name in names:
        arch, cfg, shape, kw = case(name)
        rec = D.run_one(arch, shape.name, "test", cfg=cfg, shape=shape,
                        device="cpu", **kw)
        mesh = D.world("test", torch.device("cpu"))
        bundle = D.build(cfg, shape, mesh, **kw)
        args = _real_args(cfg, bundle, mesh)
        with MM.stand_in():
            res = D.count_step(bundle.fn, args, device_type="cpu")
        finite = all(bool(torch.isfinite(t.float()).all()) for t in
                     D._tensors(res["out"]) if t.is_floating_point())
        out[name] = {"predicted": rec, "real": _counted(res),
                     "finite": finite}
    return out


def gloo_rank(rank, world, store, names):
    """On rank ``rank`` of a real (2, 2) gloo group: each case's step from
    this rank's shards, under ``count_step``; rank 0's counters."""
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as MM
    mesh = MM.make_test_group(WORLD, rank, store, shape=MESH,
                              client_axes=())
    out = {}
    for name in names:
        _, cfg, shape, kw = case(name)
        bundle = D.build(cfg, shape, mesh, **kw)
        args = _real_args(cfg, bundle, mesh)
        res = D.count_step(bundle.fn, args, device_type="cpu")
        out[name] = _counted(res)
    MM.dist.barrier()
    return out


def algorithms(rank, world, store, cases):
    """In a process of its own: rank 0 of the fake (2, 2) world; per
    (arch, algorithm) of ``cases`` the dry run's record of the smoke
    config's train step on fake tensors standing for the card's (the
    kernels' fake branch: predicted launches)."""
    torch.set_num_threads(1)
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as ST
    shape = dataclasses.replace(ST.SHAPES["train_4k"], seq_len=ALG_SEQ,
                                global_batch=ALG_BATCH)
    out = {}
    for arch, alg in cases:
        out[(arch, alg)] = D.run_one(
            arch, shape.name, "test", cfg=reduce_for_smoke(get_config(arch)),
            shape=shape, plan=shd.plan_for(arch), algorithm=alg,
            local_epochs=1, error_feedback=True)
    return out
