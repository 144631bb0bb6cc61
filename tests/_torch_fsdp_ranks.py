"""What each rank runs in tests/test_torch_fsdp.py: the port's virtual
clients and FSDP leaves on a (data 2, model 2) gloo group of CPU
processes with no client axes (``launch.mesh.run_ranks``).  It imports no
jax, so that a spawned rank starts quickly; it returns numpy arrays and
numbers.

Cases, all in one spawn (:func:`on_group`):

* ``roundtrip``: ``unshard(shard(params))`` under the ``fsdp`` rules;
* ``select``: the threshold selection of a leaf split over the data axes
  alone, over both, and with tile padding, against the whole leaf's;
* ``layers``: one layer of each kind (GQA, MLP, MLA + MoE, SSD) on its
  FSDP+tp shards and this rank's batch slice against the whole layer;
* ``steps``: ``build_train_step`` with the virtual/fsdp plan, two rounds
  with error feedback of mistral-large-123b's smoke config (held against
  JAX's jitted step), and one of kimi-k2-1t-a32b's against the port's
  whole-leaf scan round.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from _torch_tensor_ranks import _np, _rel_err, _torch, draw_params

MESH = {"data": 2, "model": 2}
WORLD = 4
ROUNDS = 2
SEQ, BATCH = 64, 4
ALPHA = 0.05
LOCAL_EPOCHS = 2
N_VIRTUAL = 2
#: The model held against JAX's jitted virtual/fsdp step, and the MoE
#: model held against the port's whole-leaf scan round (JAX's fails in
#: ``moe_fwd`` under FSDP on this jax).
JAX_MODEL = "mistral-large-123b"
MOE_MODEL = "kimi-k2-1t-a32b"
FSDP_MODELS = ("kimi-k2-1t-a32b", "jamba-1-5-large-398b",
               "mistral-large-123b", "gemma3-27b")


def smoke_cfg(name):
    from repro_torch.configs import get_config, reduce_for_smoke
    return dataclasses.replace(reduce_for_smoke(get_config(name)),
                               dtype="float32")


def plan():
    from repro_torch.sharding import DeployPlan
    return DeployPlan(clients="virtual", train_params="fsdp",
                      n_virtual=N_VIRTUAL)


def batch_tokens(cfg, seed: int = 1):
    """(n_virtual, global batch, SEQ) int32 tokens: JAX's layout."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (N_VIRTUAL, BATCH, SEQ)) \
        .astype(np.int32)


def fsdp_specs(meta, mesh):
    from repro_torch import sharding as shd
    from repro_torch.models import params as PM
    return PM.pspecs(meta, shd.param_rules("fsdp", "pod" in MESH), mesh)


def on_group(rank, world, store, params_np):
    """One rank's every case.  ``params_np``: the JAX-compared model's
    numpy param tree."""
    from repro_torch.launch import mesh as MM
    torch.set_num_threads(1)
    mesh = MM.make_test_group(world, rank, store, shape=MESH,
                              client_axes=())
    try:
        return {"roundtrip": roundtrip(mesh),
                "select": select(mesh),
                "layers": layers(mesh),
                "steps": steps(mesh, params_np)}
    finally:
        mesh.close()


def exit_hard(rank, world, store):
    """Rank 1 ends its process at once, without an answer; rank 0 would
    answer only after a minute."""
    if rank == 1:
        os._exit(3)
    time.sleep(60)
    return rank


# ---------------------------------------------------------------------------
# shard / unshard
# ---------------------------------------------------------------------------


def roundtrip(mesh):
    """Per FSDP model: whether ``unshard(shard(params))`` is the params bit
    for bit, this rank's shard shapes, and the first elements of each."""
    from repro_torch import tree as T
    from repro_torch.models import model as TM
    from repro_torch.models import params as PM
    out = {}
    for i, name in enumerate(FSDP_MODELS):
        meta = TM.abstract_params(smoke_cfg(name))
        p = _torch(draw_params(meta, 600 + i))
        specs = fsdp_specs(meta, mesh)
        sh = PM.shard(p, specs, mesh)
        back = PM.unshard(sh, specs, mesh)
        out[name] = {"bitwise": all(torch.equal(a, b) for a, b in zip(
            T.leaves(back), T.leaves(p))),
            "shapes": [tuple(x.shape) for x in T.leaves(sh)],
            "first": [x.reshape(-1)[:4].numpy() for x in T.leaves(sh)]}
    return out


# ---------------------------------------------------------------------------
# the threshold selection of an FSDP leaf
# ---------------------------------------------------------------------------

#: name -> (shape, spec, kind).  A norm scale is split over the data
#: axes alone (its model ranks hold replicas); a projection over both;
#: 24,578 and 24,584 elements are no whole number of 8192-element tiles.
SELECT_LEAVES = {
    "data_only": ((24578,), ("data",), "normal"),
    "both": ((64, 600), ("data", "model"), "normal"),
    "both_padded": ((4, 6146), ("data", "model"), "ties"),
    "data_only_zeros": ((16384,), ("data",), "zeros"),
}
SELECT_ALPHAS = (0.05, 0.01, 1.0)


def select_leaf(name):
    shape, _, kind = SELECT_LEAVES[name]
    rng = np.random.default_rng(len(name))
    if kind == "zeros":
        x = np.zeros(shape, np.float32)
    elif kind == "ties":
        x = rng.integers(-8, 9, shape).astype(np.float32) / 4
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x)


def select(mesh):
    """Per leaf and alpha: the shard's tau and count (the kernels' plain
    passes over the leaf's group: the data group for a data-only leaf,
    the leaf group for one split over both), its mask, and the bisection
    reference, against the whole leaf's on this rank."""
    from repro_torch.core import sparsify as S
    from repro_torch.kernels.topk_mask.ops import select_tau, topk_mask
    from repro_torch.models import params as PM
    out = {}
    for name, (shape, spec, _) in SELECT_LEAVES.items():
        x = select_leaf(name)
        sp = PM.Spec(spec)
        kind = PM.split_kinds(sp, mesh)[0]
        group = {"data": mesh.data, "both": mesh.leaf}[kind]
        xs = PM.shard(x, sp, mesh)
        n = x.numel()
        for alpha in SELECT_ALPHAS:
            k = S.k_for(n, alpha)
            tau, cnt = select_tau(xs, k, model=group, n=n)
            tau0, cnt0 = select_tau(x, k)
            mask = topk_mask(xs, k, model=group, n=n)[0]
            bis = S.topk_mask_threshold(xs, k, model=group)
            out[(name, alpha)] = {
                "kind": kind,
                "tau_bitwise": torch.equal(tau.view(torch.int32),
                                           tau0.view(torch.int32)),
                "count_bitwise": torch.equal(cnt, cnt0),
                "mask_bitwise": torch.equal(
                    PM.unshard(mask, sp, mesh), topk_mask(x, k)[0]),
                "bisection_bitwise": torch.equal(
                    PM.unshard(bis, sp, mesh),
                    S.topk_mask_threshold(x, k))}
    return out


# ---------------------------------------------------------------------------
# one layer of each kind under FSDP + tp
# ---------------------------------------------------------------------------


def layer_defs():
    """name -> (param meta, whole fn(p, x) -> (y, aux), split fn(p, x,
    group, fsdp) -> (y, aux)); aux the MoE load-balance loss (or 0)."""
    from repro_torch.configs.base import AttentionSpec
    from repro_torch.models import layers as L
    D = 32
    sc = smoke_cfg("deepseek-v2-lite-16b")
    mla, moe = sc.layer_pattern[0].attention, sc.layer_pattern[0].moe
    mla = dataclasses.replace(mla, num_heads=4, head_dim=8, kv_lora_rank=16)
    moe = dataclasses.replace(moe, d_ff=16, shared_d_ff=16)
    ssm = smoke_cfg("mamba2-1-3b").layer_pattern[0].ssm
    gqa = AttentionSpec(num_heads=4, num_kv_heads=2, head_dim=8)
    pos = lambda x: torch.arange(x.shape[1]).expand(x.shape[:2])
    zero = lambda y: (y, torch.zeros(()))
    mla_moe = {"mla": L.mla_params(D, mla), "moe": L.moe_params(D, moe)}

    def mla_moe_whole(p, x):
        h = x + L.mla_fwd(p["mla"], mla, x, positions=None)[0]
        y, aux = L.moe_fwd(p["moe"], moe, h)
        return h + y, aux

    def mla_moe_split(p, x, g, f):
        h = x + L.mla_fwd_tp(p["mla"], mla, x, group=g, positions=None)[0]
        y, aux = L.moe_fwd_tp(p["moe"], moe, h, group=g, fsdp=f)
        return h + y, aux

    return {
        "gqa": (L.attention_params(D, gqa),
                lambda p, x: zero(L.attention_fwd(p, gqa, x,
                                                  positions=pos(x))[0]),
                lambda p, x, g, f: zero(L.attention_fwd_tp(
                    p, gqa, x, group=g, positions=pos(x))[0])),
        "mlp": (L.mlp_params(D, 48, True),
                lambda p, x: zero(L.mlp_fwd(p, x)),
                lambda p, x, g, f: zero(L.mlp_fwd_tp(p, x, group=g,
                                                     d_ff=48))),
        "mla_moe": (mla_moe, mla_moe_whole, mla_moe_split),
        "ssd": (L.ssm_params(D, ssm),
                lambda p, x: zero(L.ssm_fwd(p, ssm, x)[0]),
                lambda p, x, g, f: zero(L.ssm_fwd_tp(p, ssm, x,
                                                     group=g)[0])),
    }


def layers(mesh):
    """Per layer: the largest error of the split form's output (this
    rank's batch slice), its input gradient and every parameter gradient
    (unsharded), relative to the whole form's largest element, and the
    split kinds of its leaves.  The scalar is ``sum(y * cot) + aux *
    sum(cot)`` over the whole batch, the same on every rank (the split
    form sums its slice's part over the data group)."""
    from repro_torch import tree as T
    from repro_torch.models import params as PM
    from repro_torch.models import tensor as TPX
    tp, dg = mesh.model, mesh.data
    rows = mesh.world_size // mesh.model_size
    out = {}
    for i, (name, (meta, whole, split)) in enumerate(layer_defs().items()):
        rng = np.random.default_rng(700 + i)
        p = _torch(draw_params(meta, 800 + i))
        x = torch.from_numpy(rng.standard_normal((4, 12, 32))
                             .astype(np.float32))
        cot = torch.from_numpy(rng.standard_normal((4, 12, 32))
                               .astype(np.float32))
        c = cot.sum()
        specs = fsdp_specs(meta, mesh)
        fsdp = TPX.FSDP(dg, specs, mesh.fsdp_axes)
        n = x.shape[0] // rows
        lo, hi = mesh.client_index * n, (mesh.client_index + 1) * n

        def whole_scalar(q, xx):
            y, aux = whole(q, xx)
            return y, (y * cot).sum() + aux * c

        def split_scalar(q, xx):
            y, aux = split(fsdp.tree(q, specs), xx, tp, fsdp)
            return y, TPX.reduce((y * cot[lo:hi]).sum(), dg) + aux * c

        y0, gp0, gx0 = _scalar_grads(whole_scalar, p, x)
        y1, gp1, gx1 = _scalar_grads(split_scalar, PM.shard(p, specs, mesh),
                                     x[lo:hi])
        gp1 = PM.unshard(gp1, specs, mesh)
        out[name] = {"out": _rel_err(y1, y0[lo:hi]),
                     "dx": _rel_err(gx1, gx0[lo:hi]),
                     "params": [_rel_err(a, b) for a, b in
                                zip(_np(gp1), _np(gp0))],
                     "kinds": PM.split_kinds(specs, mesh)}
    return out


def _scalar_grads(fn, params, x):
    """(y, d params (tree), d x) of the scalar ``fn(params, x)[1]``."""
    from repro_torch import tree as T
    leaves, td = T.flatten(params)
    req = [t.detach().clone().requires_grad_(True) for t in leaves]
    xr = x.detach().clone().requires_grad_(True)
    y, s = fn(td.unflatten(req), xr)
    g = torch.autograd.grad(s, req + [xr])
    return y.detach(), td.unflatten(list(g[:-1])), g[-1]


# ---------------------------------------------------------------------------
# build_train_step rounds
# ---------------------------------------------------------------------------


def _whole_state(state, specs, mesh):
    """W, M, V whole, and the virtual clients' residuals whole (C, ...)."""
    from repro_torch import tree as T
    from repro_torch.models import params as PM
    cs_specs = T.tree_map(lambda sp: PM.Spec((None,) + tuple(sp)), specs)
    rec = {k: _np(PM.unshard(getattr(state, k), specs, mesh))
           for k in ("W", "M", "V")}
    rec["err"] = _np(PM.unshard(state.client_state["comp"]["err"], cs_specs,
                                mesh))
    return rec


def run_step(mesh, cfg, params, tokens, algorithm="fedadam_ssm",
             rounds=ROUNDS):
    """``rounds`` virtual/fsdp rounds of ``build_train_step`` with error
    feedback from the whole ``params`` and every client's ``tokens``
    (C, BATCH, SEQ): per round the whole state, the losses, the
    diagnostics and the bill; the shapes of this rank's leaves."""
    from repro_torch import tree as T
    from repro_torch.core.fed import local_batch
    from repro_torch.launch import steps
    shape = dataclasses.replace(steps.SHAPES["train_4k"], seq_len=SEQ,
                                global_batch=BATCH)
    bundle = steps.build_train_step(cfg, mesh, shape, algorithm=algorithm,
                                    local_epochs=LOCAL_EPOCHS, alpha=ALPHA,
                                    error_feedback=True, plan=plan())
    state = bundle.init(params)
    batch = local_batch({"tokens": torch.from_numpy(tokens)}, mesh)
    out = []
    for _ in range(rounds):
        state, mets = bundle.fn(state, batch)
        rec = _whole_state(state, bundle.static["pspecs"], mesh)
        rec.update(loss=mets["loss"].numpy(),
                   uplink_bits=float(mets["uplink_bits"]),
                   diag={k: v.numpy() for k, v in mets.items()
                         if k not in ("loss", "uplink_bits")})
        out.append(rec)
    return {"rounds": out, "batch_shapes": bundle.batch_shapes,
            "local_batch": tuple(batch["tokens"].shape),
            "shard_shapes": [tuple(x.shape) for x in T.leaves(state.W)],
            "cs_shapes": [tuple(x.shape) for x in
                          T.leaves(state.client_state)]}


def steps(mesh, params_np):
    """mistral's rounds for the JAX comparison; kimi's split round, and on
    rank 0 its whole-leaf scan round on a world-1 mesh (no collective)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as MM
    from repro_torch.models import model as TM
    cfg = smoke_cfg(JAX_MODEL)
    out = {JAX_MODEL: run_step(
        mesh, cfg, TM.params_from_jax(params_np, cfg, "cpu"),
        batch_tokens(cfg))}
    cfg = smoke_cfg(MOE_MODEL)
    params = TM.params_from_jax(draw_params(TM.abstract_params(cfg), 9),
                                cfg, "cpu")
    toks = batch_tokens(cfg, 2)
    rec = {"split": run_step(mesh, cfg, params, toks, rounds=1)}
    if mesh.rank == 0:
        whole = MM.ClientMesh(shape={"data": 1}, client_axes=(), rank=0,
                              device=mesh.device)
        rec["whole"] = run_step(whole, cfg, params, toks, rounds=1)
    dist.barrier()
    out[MOE_MODEL] = rec
    return out
