"""What each rank runs in tests/test_torch_tensor.py: the port's tensor
parallelism on a (data 2, model 2) gloo group of CPU processes
(``launch.mesh.run_ranks``).  It imports no jax, so that a spawned rank
starts quickly; it returns numpy arrays and numbers.

Cases, all in one spawn (:func:`on_group`):

* ``transport``: the per-shard bitmap transport on split carriers;
* ``layers``: each tensor-parallel layer (and the whole loss of five
  families) against the port's whole layer, forward and gradients;
* ``select``: the threshold selection of a split leaf against the whole
  leaf's;
* ``steps``: ``build_train_step`` rounds with error feedback, the
  starcoder2 and mamba2 ones for the JAX comparison, deepseek's against
  the whole-leaf spatial step on the client group;
* ``compress``: every compressor's compress on split leaves against the
  whole leaves' (:func:`compress_cases`, shared with
  ``tests/_torch_fsdp_ranks.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MESH = {"data": 2, "model": 2}
WORLD = 4
#: The transport's leaves: shape and the dim the model axis splits (None:
#: replicated), as ``P(None, "model")``-style specs.
TRANSPORT_LEAVES = {"x": ((8, 40), 1), "y": ((30,), 0), "z": ((6, 5), None)}
TRANSPORT_CASES = {
    "shared": dict(shared=True, value_dtype=None, alpha=0.2, overflow=False),
    "independent": dict(shared=False, value_dtype=None, alpha=0.2,
                        overflow=False),
    "shared_bf16": dict(shared=True, value_dtype="bfloat16", alpha=0.2,
                        overflow=False),
    "shared_overflow": dict(shared=True, value_dtype=None, alpha=0.1,
                            overflow=True),
}
#: (model, algorithm) of the rounds held against JAX's jitted step.
JAX_STEPS = (("starcoder2-3b", "fedadam_ssm"), ("starcoder2-3b",
                                                "fedadam_top"),
             ("mamba2-1-3b", "fedadam_ssm"))
ROUNDS = 2
SEQ, BATCH = 64, 4
ALPHA = 0.05
LOCAL_EPOCHS = 2
#: (model, algorithm, build keywords) of the rounds held against JAX's
#: whole-leaf scan round of the same clients and batches (JAX's jitted tp
#: step fails at its dense fold on this jax, ROADMAP §3), and the one held
#: against JAX's jitted tp step; one local epoch each.  The exact-mask and
#: global-scope rounds fold the dense carriers: the per-shard bitmap
#: transport's capacity (alpha of each shard) would drop what a shard
#: selects beyond it.
SCAN_STEPS = (("starcoder2-3b", "fedadam", {}),
              ("starcoder2-3b", "fedsgd", {}),
              ("starcoder2-3b", "efficient_adam", {}),
              ("starcoder2-3b", "onebit_adam", {}),
              ("starcoder2-3b", "fedadam_ssm",
               dict(exact_topk=True, aggregate="dense")),
              ("starcoder2-3b", "fedadam_top",
               dict(mask_scope="global", aggregate="dense")))
TP_STEPS = (("starcoder2-3b", "fairness_top", {}),)
NEW_EPOCHS = 1


def step_key(name, alg, kw) -> tuple:
    return (name, alg) + tuple(sorted(kw.items()))


#: The families whose whole loss runs split against whole.
LOSS_MODELS = ("starcoder2-3b", "mamba2-1-3b", "deepseek-v2-lite-16b",
               "whisper-base", "llava-next-mistral-7b")


def smoke_cfg(name):
    from repro_torch.configs import get_config, reduce_for_smoke
    return dataclasses.replace(reduce_for_smoke(get_config(name)),
                               dtype="float32")


def draw_params(meta, seed: int):
    """Numpy leaves for a tree of ``P`` by the JAX package's init rules
    from one numpy seed (``tests/_torch_parity.np_model_params``' draw, in
    float32), in flatten order."""
    from repro_torch import tree as T
    rng = np.random.default_rng(seed)

    def draw(p):
        if p.init in ("zeros", "ones"):
            return np.full(p.shape, float(p.init == "ones"), np.float32)
        fan_in = p.fan_in or (p.shape[-2] if len(p.shape) >= 2
                              else p.shape[-1])
        std = 1.0 / np.sqrt(max(1, fan_in)) if p.init == "scaled" else 0.02
        return (rng.standard_normal(p.shape) * std).astype(np.float32)

    return T.tree_map(draw, meta)


def batch_tokens(cfg, seed: int = 1):
    """(C, per_client, SEQ) int32 tokens."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (2, BATCH // 2, SEQ)) \
        .astype(np.int32)


def _torch(tree):
    from repro_torch import tree as T
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    from repro_torch import tree as T
    return [x.detach().cpu().numpy() for x in T.leaves(tree)]


def on_group(rank, world, store, params_np):
    """One rank's every case.  ``params_np``: {model: numpy param tree}
    of the JAX-compared steps."""
    from repro_torch.launch import mesh as MM
    torch.set_num_threads(1)
    mesh = MM.make_test_group(world, rank, store, shape=MESH)
    try:
        return {"transport": transport(mesh),
                "select": select(mesh),
                "compress": compress_cases(mesh, COMPRESS_LEAVES),
                "roundtrip": roundtrip(mesh),
                "layers": layers(mesh),
                "steps": steps(mesh, params_np)}
    finally:
        mesh.close()


# ---------------------------------------------------------------------------
# (i) the per-shard transport
# ---------------------------------------------------------------------------


def transport_inputs(case: str):
    """Numpy (C, *shape) masked carriers of every leaf, the residuals,
    the FedAvg weights (powers of two)."""
    kw = TRANSPORT_CASES[case]
    rng = np.random.default_rng(len(case))
    car, err = {}, {}
    for name, (shape, _) in TRANSPORT_LEAVES.items():
        full = (2,) + shape
        # the overflow case keeps many more than k + overselect_bound(k)
        keep = rng.random(full) < (0.6 if kw["overflow"] else kw["alpha"])
        car[name] = tuple((t * keep).astype(np.float32) for t in (
            rng.standard_normal(full), rng.standard_normal(full),
            np.abs(rng.standard_normal(full))))
        err[name] = rng.standard_normal(full).astype(np.float32)
    return car, err, np.array([0.5, 0.25], np.float32)


def transport_specs():
    from repro_torch.models.params import Spec
    return {k: Spec(tuple("model" if d == dim else None
                          for d in range(len(shape))))
            for k, (shape, dim) in TRANSPORT_LEAVES.items()}


def transport(mesh):
    """Every case's sums (whole, after an unshard) and the residuals of
    every client (whole), from this rank's shards."""
    from repro_torch.core import aggregate
    from repro_torch.models import params as PM
    specs = transport_specs()
    c = mesh.client_index
    out = {}
    for case, kw in TRANSPORT_CASES.items():
        car, err, w = transport_inputs(case)
        agg = aggregate.make_shardmap_sparse_aggregate(
            mesh, specs, ("data",), kw["alpha"], shared=kw["shared"],
            value_dtype=kw["value_dtype"])
        mine = lambda i: PM.shard({k: torch.from_numpy(v[i][c])
                                   for k, v in car.items()}, specs, mesh)
        lead = lambda t: {k: v[None] for k, v in t.items()}
        e = PM.shard({k: torch.from_numpy(v[c]) for k, v in err.items()},
                     specs, mesh)
        (aw, am, av), new_err = agg(lead(mine(0)), lead(mine(1)),
                                    lead(mine(2)), torch.from_numpy(w),
                                    lead(e))
        whole = lambda t: PM.unshard(t, specs, mesh)
        ne = whole({k: v[0] for k, v in new_err.items()})
        out[case] = {"sums": [_np(whole(t)) for t in (aw, am, av)],
                     "err": _np({k: mesh.all_gather(v)
                                 for k, v in ne.items()})}
    return out


# ---------------------------------------------------------------------------
# (iii) the threshold selection of a split leaf
# ---------------------------------------------------------------------------

#: name -> (shape, split dim, dtype, kind): 24,578 elements is no whole
#: number of 8192-element tiles; "zeros" an all-zero leaf.
SELECT_LEAVES = {
    "odd_tiles": ((24578,), 0, torch.float32, "normal"),
    "zeros": ((2, 8192), 1, torch.float32, "zeros"),
    "matrix_cols": ((64, 600), 1, torch.float32, "normal"),
    "bf16_ties": ((256, 96), 0, torch.bfloat16, "ties"),
}
SELECT_ALPHAS = (0.05, 0.01, 1.0)


def select_leaf(name):
    shape, _, dtype, kind = SELECT_LEAVES[name]
    rng = np.random.default_rng(len(name))
    if kind == "zeros":
        x = np.zeros(shape, np.float32)
    elif kind == "ties":
        x = rng.integers(-8, 9, shape).astype(np.float32) / 4
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def select(mesh):
    """Per leaf and alpha: the split leaf's tau and count (the kernels'
    plain passes) and its bisection mask, whole, beside the whole leaf's
    on this rank, and whether each is bitwise."""
    from repro_torch.core import sparsify as S
    from repro_torch.kernels.topk_mask.ops import select_tau, topk_mask
    tp = mesh.model
    out = {}
    for name, (shape, dim, _, _) in SELECT_LEAVES.items():
        x = select_leaf(name)
        lo, hi = tp.chunk(shape[dim])
        xs = x.narrow(dim, lo, hi - lo).contiguous()
        n = x.numel()
        for alpha in SELECT_ALPHAS:
            k = S.k_for(n, alpha)
            tau, cnt = select_tau(xs, k, model=tp, n=n)
            tau0, cnt0 = select_tau(x, k)
            mask = topk_mask(xs, k, model=tp, n=n)[0]
            bis = S.topk_mask_threshold(xs, k, model=tp)
            bis0 = S.topk_mask_threshold(x, k)
            out[(name, alpha)] = {
                "tau": (float(tau), float(tau0)),
                "count": (float(cnt), float(cnt0)),
                "tau_bitwise": torch.equal(tau.view(torch.int32),
                                           tau0.view(torch.int32)),
                "count_bitwise": torch.equal(cnt, cnt0),
                "mask_bitwise": torch.equal(
                    tp.all_gather(mask, dim),
                    topk_mask(x, k)[0]),
                "bisection_bitwise": torch.equal(
                    tp.all_gather(bis, dim), bis0)}
    return out


# ---------------------------------------------------------------------------
# (ii) the tensor-parallel layers against the whole ones
# ---------------------------------------------------------------------------


def _attn(heads, kv, window=None):
    from repro_torch.configs.base import AttentionSpec
    return AttentionSpec(num_heads=heads, num_kv_heads=kv, head_dim=8,
                         window=window)


def layer_defs():
    """name -> (param meta, whole fn(p, x), split fn(p, x, group))."""
    from repro_torch.models import layers as L
    D = 32
    sc = smoke_cfg("deepseek-v2-lite-16b")
    mla, moe = sc.layer_pattern[0].attention, sc.layer_pattern[0].moe
    mla = dataclasses.replace(mla, num_heads=4, head_dim=8, kv_lora_rank=16)
    moe = dataclasses.replace(moe, d_ff=16, shared_d_ff=16)
    ssm = smoke_cfg("mamba2-1-3b").layer_pattern[0].ssm
    pos = lambda x: torch.arange(x.shape[1]).expand(x.shape[:2])
    out = {}
    for name, a in (("gqa", _attn(4, 2)), ("gqa_kv_whole_group",
                                           _attn(4, 1)),
                    ("gqa_kv_cut_groups", _attn(6, 3)),
                    ("gqa_window", _attn(4, 2, window=5))):
        out[name] = (L.attention_params(D, a),
                     lambda p, x, a=a: L.attention_fwd(
                         p, a, x, positions=pos(x))[0],
                     lambda p, x, g, a=a: L.attention_fwd_tp(
                         p, a, x, group=g, positions=pos(x))[0])
    a = _attn(4, 2)
    src = lambda x: torch.flip(x, dims=(1,)) * 0.5
    out["cross"] = (L.attention_params(D, a),
                    lambda p, x: L.attention_fwd(p, a, x, positions=pos(x),
                                                 kv=src(x))[0],
                    lambda p, x, g: L.attention_fwd_tp(
                        p, a, x, group=g, positions=pos(x), kv=src(x))[0])
    out["mla"] = (L.mla_params(D, mla),
                  lambda p, x: L.mla_fwd(p, mla, x, positions=None)[0],
                  lambda p, x, g: L.mla_fwd_tp(p, mla, x, group=g,
                                               positions=None)[0])
    for name, gated in (("mlp_gated", True), ("mlp_gelu", False)):
        out[name] = (L.mlp_params(D, 48, gated), L.mlp_fwd,
                     lambda p, x, g: L.mlp_fwd_tp(p, x, group=g, d_ff=48))
    # the load-balance loss enters the scalar, so its gradient is held too
    out["moe"] = (L.moe_params(D, moe),
                  lambda p, x: _moe_out(L.moe_fwd(p, moe, x)),
                  lambda p, x, g: _moe_out(L.moe_fwd_tp(p, moe, x,
                                                        group=g)))
    out["ssd"] = (L.ssm_params(D, ssm),
                  lambda p, x: L.ssm_fwd(p, ssm, x)[0],
                  lambda p, x, g: L.ssm_fwd_tp(p, ssm, x, group=g)[0])
    return out


def _moe_out(res):
    y, aux = res
    return y + aux


def _grads(fn, params, x, cot):
    """(out, d params (tree), d x) of ``sum(fn(params, x) * cot)``."""
    from repro_torch import tree as T
    leaves, td = T.flatten(params)
    req = [t.detach().clone().requires_grad_(True) for t in leaves]
    xr = x.detach().clone().requires_grad_(True)
    out = fn(td.unflatten(req), xr)
    g = torch.autograd.grad((out * cot).sum(), req + [xr])
    return out.detach(), td.unflatten(list(g[:-1])), g[-1]


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def layers(mesh):
    """Per layer (and per family's whole loss): the largest error of the
    split form's output, input gradient and every parameter gradient,
    relative to the whole form's largest element."""
    from repro_torch import sharding as shd
    from repro_torch import tree as T
    from repro_torch.models import params as PM
    tp = mesh.model
    rules = shd.param_rules("tp", False)
    out = {}
    for i, (name, (meta, whole, split)) in enumerate(layer_defs().items()):
        rng = np.random.default_rng(100 + i)
        p = _torch(draw_params(meta, 200 + i))
        x = torch.from_numpy(rng.standard_normal((2, 12, 32))
                             .astype(np.float32))
        cot = torch.from_numpy(rng.standard_normal((2, 12, 32))
                               .astype(np.float32))
        specs = PM.pspecs(meta, rules, mesh)
        y0, gp0, gx0 = _grads(whole, p, x, cot)
        y1, gp1, gx1 = _grads(lambda q, xx: split(q, xx, tp),
                              PM.shard(p, specs, mesh), x, cot)
        gp1 = PM.unshard(gp1, specs, mesh)
        out[name] = {"out": _rel_err(y1, y0), "dx": _rel_err(gx1, gx0),
                     "params": [_rel_err(a, b) for a, b in
                                zip(_np(gp1), _np(gp0))],
                     "split": [any(e is not None for e in s)
                               for s in T.leaves(specs)]}
    out.update(model_losses(mesh))
    return out


def model_losses(mesh):
    """The whole loss (split forward, vocabulary-parallel cross-entropy)
    of every family in ``LOSS_MODELS`` against ``loss_fn`` on whole
    leaves: the loss and every gradient."""
    from repro_torch import sharding as shd
    from repro_torch.models import model as TM
    from repro_torch.models import params as PM
    tp = mesh.model
    out = {}
    for i, name in enumerate(LOSS_MODELS):
        cfg = smoke_cfg(name)
        meta = TM.abstract_params(cfg)
        p = _torch(draw_params(meta, 300 + i))
        specs = PM.pspecs(meta, shd.param_rules("tp", False), mesh)
        rng = np.random.default_rng(400 + i)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24))
                                .astype(np.int32))
        emb = None
        if cfg.encoder is not None or cfg.stub_frontend:
            n = cfg.encoder.src_len if cfg.encoder is not None else 8
            emb = torch.from_numpy(rng.standard_normal((2, n, cfg.d_model))
                                   .astype(np.float32))

        def lossg(params, tp_):
            from repro_torch import tree as T
            leaves, td = T.flatten(params)
            req = [t.detach().clone().requires_grad_(True) for t in leaves]
            loss = TM.loss_fn(cfg, td.unflatten(req), toks,
                              frontend_embeds=emb, tp=tp_)
            return loss.detach(), td.unflatten(list(
                torch.autograd.grad(loss, req)))

        l0, g0 = lossg(p, None)
        l1, g1 = lossg(PM.shard(p, specs, mesh), tp)
        g1 = PM.unshard(g1, specs, mesh)
        out[f"loss:{name}"] = {"out": _rel_err(l1, l0), "dx": 0.0,
                               "params": [_rel_err(a, b) for a, b in
                                          zip(_np(g1), _np(g0))],
                               "split": PM.model_split(specs)}
    return out


# ---------------------------------------------------------------------------
# (iv, v) build_train_step rounds
# ---------------------------------------------------------------------------


def _whole_state(state, specs, mesh):
    """W, M, V whole, and the client states whole and stacked (C, ...)."""
    from repro_torch import tree as T
    from repro_torch.models import params as PM
    whole = lambda t: PM.unshard(t, specs, mesh) if mesh.model is not None \
        else t
    rec = {k: _np(whole(getattr(state, k))) for k in ("W", "M", "V")}
    cs = state.client_state
    rec["err"] = [] if cs is None else [
        mesh.all_gather(x).numpy() for x in
        T.leaves(whole(T.tree_map(lambda t: t[0], cs["comp"]["err"])))]
    return rec


def run_step(mesh, cfg, params, tokens, algorithm, rounds=ROUNDS,
             local_epochs=LOCAL_EPOCHS, **kw):
    """``rounds`` rounds of ``build_train_step`` with error feedback from
    the whole ``params`` (``kw``: more of its keywords): per round the
    whole state, the losses, the diagnostics and the bill; the shapes of
    this rank's leaves."""
    from repro_torch.core.fed import local_clients
    from repro_torch.launch import steps
    shape = dataclasses.replace(steps.SHAPES["train_4k"], seq_len=SEQ,
                                global_batch=BATCH)
    bundle = steps.build_train_step(cfg, mesh, shape, algorithm=algorithm,
                                    local_epochs=local_epochs, alpha=ALPHA,
                                    error_feedback=True, **kw)
    state = bundle.init(params)
    batch = local_clients({"tokens": torch.from_numpy(tokens)}, mesh)
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
            "shard_shapes": [tuple(x.shape) for x in _leaves(state.W)],
            "cs_shapes": [tuple(x.shape) for x in
                          _leaves(state.client_state)]}


def _leaves(tree):
    from repro_torch import tree as T
    return T.leaves(tree)


def steps(mesh, params_np):
    """The JAX-compared rounds on the (2, 2) group, and deepseek's split
    round against the whole-leaf spatial round on this rank's client
    group (data 2, model 1)."""
    from repro_torch.launch import mesh as MM
    from repro_torch.models import model as TM
    out = {}
    for name, alg in JAX_STEPS:
        cfg = smoke_cfg(name)
        params = TM.params_from_jax(params_np[name], cfg, "cpu")
        out[(name, alg)] = run_step(mesh, cfg, params, batch_tokens(cfg),
                                    alg)
    for name, alg, kw in SCAN_STEPS + TP_STEPS:
        cfg = smoke_cfg(name)
        params = TM.params_from_jax(params_np[name], cfg, "cpu")
        out[step_key(name, alg, kw)] = run_step(
            mesh, cfg, params, batch_tokens(cfg), alg,
            local_epochs=NEW_EPOCHS, **kw)
    cfg = smoke_cfg("deepseek-v2-lite-16b")
    params = TM.params_from_jax(draw_params(TM.abstract_params(cfg), 7),
                                cfg, "cpu")
    toks = batch_tokens(cfg)
    whole_mesh = MM.ClientMesh(shape={"data": 2}, client_axes=("data",),
                               rank=mesh.client_index, device=mesh.device,
                               group=mesh.group)
    out["deepseek"] = {
        "split": run_step(mesh, cfg, params, toks, "fedadam_ssm", 1),
        "whole": run_step(whole_mesh, cfg, params, toks, "fedadam_ssm", 1)}
    return out


def roundtrip(mesh):
    """Whether ``unshard(shard(params))`` is every family's params bit for
    bit, and this rank's shard shapes under the ``tp`` rules."""
    from repro_torch import sharding as shd
    from repro_torch.models import model as TM
    from repro_torch.models import params as PM
    out = {}
    for i, name in enumerate(LOSS_MODELS):
        cfg = smoke_cfg(name)
        meta = TM.abstract_params(cfg)
        p = _torch(draw_params(meta, 500 + i))
        specs = PM.pspecs(meta, shd.param_rules("tp", False), mesh)
        sh = PM.shard(p, specs, mesh)
        back = PM.unshard(sh, specs, mesh)
        out[name] = {"bitwise": all(torch.equal(a, b) for a, b in zip(
            _leaves(back), _leaves(p))),
            "shapes": [tuple(x.shape) for x in _leaves(sh)],
            "first": [x.reshape(-1)[:4].numpy() for x in _leaves(sh)]}
    return out


# ---------------------------------------------------------------------------
# every compressor's compress on split leaves
# ---------------------------------------------------------------------------

#: name -> (shape, spec): a row of 1536 elements split in two is 768 a
#: rank, so every second 1024-block of the whole leaf straddles the model
#: ranks; rows of 2560 put a rank's runs at unevenly spaced places of the
#: blocks it touches; one leaf is whole.
COMPRESS_LEAVES = {
    "a_straddle": ((6, 1536), (None, "model")),
    "b_uneven": ((5, 2560), (None, "model")),
    "c_rows": ((3000,), ("model",)),
    "d_whole": ((7, 5), (None, None)),
}
#: case -> FedConfig keywords (threshold masks on the reference backend
#: unless ``exact_topk`` or ``sparsify_backend`` say otherwise).
COMPRESS_CASES = {
    "fedadam": dict(algorithm="fedadam"),
    "fedsgd": dict(algorithm="fedsgd"),
    "efficient_adam": dict(algorithm="efficient_adam"),
    "onebit_adam": dict(algorithm="onebit_adam"),
    "fairness_top": dict(algorithm="fairness_top"),
    "fairness_top_kernel": dict(algorithm="fairness_top",
                                sparsify_backend="kernel"),
    "exact_ssm": dict(algorithm="fedadam_ssm", exact_topk=True),
    "exact_top": dict(algorithm="fedadam_top", exact_topk=True),
    "global_ssm": dict(algorithm="fedadam_ssm", mask_scope="global"),
    "global_top": dict(algorithm="fedadam_top", mask_scope="global"),
    "global_ssm_kernel": dict(algorithm="fedadam_ssm", mask_scope="global",
                              sparsify_backend="kernel"),
    "global_top_kernel": dict(algorithm="fedadam_top", mask_scope="global",
                              sparsify_backend="kernel"),
    "global_exact_ssm": dict(algorithm="fedadam_ssm", mask_scope="global",
                             exact_topk=True),
}
#: The ulps 1-bit Adam's block scale may take on a split leaf (its L1 sum
#: adds a straddling block's parts in another order; ROADMAP §3's bound).
SIGN_ULPS = 8


def _ulps(a, b):
    """Per element |a - b| in units of b's float32 ulp."""
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return np.abs(a - b) / np.spacing(np.abs(b).astype(np.float32))


def compress_deltas(leaves, seed: int = 11):
    """Whole numpy (dW, dM, dV, err) trees of ``leaves`` (V >= 0)."""
    rng = np.random.default_rng(seed)
    draw = lambda f: {k: f(shape).astype(np.float32)
                      for k, (shape, _) in leaves.items()}
    dW = draw(lambda sh: rng.standard_normal(sh) * 1e-3)
    dM = draw(lambda sh: rng.standard_normal(sh) * 1e-2)
    dV = draw(lambda sh: np.abs(rng.standard_normal(sh)) * 1e-4)
    err = draw(lambda sh: rng.standard_normal(sh) * 1e-4)
    return dW, dM, dV, err


def compress_cases(mesh, leaves, fed_kw=None):
    """Per case of :data:`COMPRESS_CASES`: the compressor on this rank's
    shards of ``leaves`` (``split`` from ``core/fed._leaf_split`` on the
    leaves' specs) against the same compressor on the whole leaves, cut
    to this rank's block: whether the carriers and the EF residual are
    bitwise (1-bit Adam: their largest distance in ulps), the diagnostics'
    largest relative error; for the threshold cases the selection's tau
    (``select_tau``/``select_tau_leaves`` and the bisection) against the
    whole leaf's or the raveled model's; for Efficient-Adam the codes and
    scales."""
    import torch
    from repro_torch import tree as T
    from repro_torch.core import masks, quantize
    from repro_torch.core import sparsify as S
    from repro_torch.core.compressors import Deltas, make_compressor
    from repro_torch.core.fed import FedConfig, _leaf_split
    from repro_torch.kernels.topk_mask.ops import (select_tau,
                                                   select_tau_leaves)
    from repro_torch.launch import mesh as MM
    from repro_torch.models import params as PM
    specs = {k: PM.Spec(sp) for k, (_, sp) in leaves.items()}
    fed_kw = fed_kw or (dict(client_mode="vmap", client_axes=("data",),
                             n_clients=mesh.n_clients)
                        if mesh.client_axes else {})
    dW, dM, dV, err = (_torch(t) for t in compress_deltas(leaves))
    mine = lambda t: PM.shard(t, specs, mesh)
    same = lambda a, b: all(torch.equal(x.view(torch.int32) if
                                        x.dtype == torch.float32 else x,
                                        y.view(torch.int32) if
                                        y.dtype == torch.float32 else y)
                            for x, y in zip(T.leaves(a), T.leaves(b)))
    out = {}
    for case, kw in COMPRESS_CASES.items():
        fed = FedConfig(**{**dict(alpha=0.05, error_feedback=True,
                                  exact_topk=False), **fed_kw, **kw})
        split = _leaf_split(fed, mesh, specs)
        whole = make_compressor(fed)
        comp = dataclasses.replace(whole, split=split)
        st = lambda e: None if whole.init_state(e) is None else {"err": e}
        pw, sw, _ = whole.compress(Deltas(dW, dM, dV), st(err),
                                   emit_wire=False)
        MM.reset_collectives()
        ps, ss, _ = comp.compress(Deltas(mine(dW), mine(dM), mine(dV)),
                                  st(mine(err)), emit_wire=False)
        gathered = MM.collective_summary()["by_kind"].get(
            "all_gather", {"bytes": 0})["bytes"]
        want = [mine(t) for t in (pw.W, pw.M, pw.V)]
        rec = {"kinds": PM.split_kinds(T.leaves(specs), mesh),
               "gathered_bytes": gathered,
               "diag": max(abs(float(ps.diag[k]) - float(pw.diag[k]))
                           / max(abs(float(pw.diag[k])), 1e-30)
                           for k in pw.diag)}
        if kw["algorithm"] == "onebit_adam":
            q, q0 = (T.leaves(t) for t in (ps.M, want[1]))
            rec["carrier_ulps"] = max(float(_ulps(a, b).max())
                                      for a, b in zip(q, q0))
            rec["signs"] = all(torch.equal(a >= 0, b >= 0)
                               for a, b in zip(q, q0))
            rec["err_ulps"] = max(float((np.abs(a.numpy().astype(
                np.float64) - b.numpy()) / np.spacing(np.abs(
                    c.numpy()))).max()) for a, b, c in zip(
                T.leaves(ss["err"]), T.leaves(mine(sw["err"])), q0))
        else:
            rec["carriers"] = all(same(a, b) for a, b in
                                  zip((ps.W, ps.M, ps.V), want))
            rec["err"] = ss is None or same(ss["err"], mine(sw["err"]))
        if kw["algorithm"] == "efficient_adam":
            x = T.tree_map(lambda a, b: a + b, dW, err)
            xs = mine(x)
            enc0 = {k: quantize.uniform_encode(v, 8) for k, v in x.items()}
            codes0 = mine({k: c for k, (c, _) in enc0.items()})
            ok = True
            for i, k in enumerate(sorted(x)):
                c1, s1 = quantize.uniform_encode(
                    xs[k], 8, 1024, split.blocks(i, xs[k], 1024))
                ok &= torch.equal(c1, codes0[k]) and torch.equal(
                    s1.view(torch.int32), enc0[k][1].view(torch.int32))
            rec["codes_scales"] = ok
        if case.startswith("fairness_top"):
            sc0 = masks.shared_score_tree("fairness_top", dW, dM, dV)
            sc1 = masks.shared_score_tree("fairness_top", mine(dW),
                                          mine(dM), mine(dV), split)
            rec["scores"] = same(sc1, mine(sc0))
            taus = []
            for i, (k, s0) in enumerate(sorted(sc0.items())):
                n = s0.numel()
                kk = S.k_for(n, 0.05)
                t1 = select_tau(sc1[k], kk, model=split.model(i), n=n)[0]
                t0 = select_tau(s0, kk)[0]
                taus.append(torch.equal(t1.view(torch.int32),
                                        t0.view(torch.int32)))
            rec["tau"] = all(taus)
        if case.startswith("global") and not kw.get("exact_topk"):
            n = sum(x.numel() for x in T.leaves(dW))
            kk = S.k_for(n, 0.05)
            flat = torch.cat([x.reshape(-1) for x in T.leaves(dW)])
            t1 = select_tau_leaves(T.leaves(mine(dW)), kk, split.groups,
                                   n)[0]
            t0 = select_tau(flat, kk)[0]
            b1 = S.topk_mask_threshold_leaves(T.leaves(mine(dW)), kk,
                                              split.groups)
            b0 = S._unravel_bool(S.topk_mask_threshold(flat, kk), dW)
            rec["tau"] = torch.equal(t1.view(torch.int32),
                                     t0.view(torch.int32)) and all(
                torch.equal(a, b) for a, b in
                zip(b1, T.leaves(mine(b0))))
        out[case] = rec
    return out
