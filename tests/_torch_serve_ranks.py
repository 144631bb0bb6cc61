"""What each rank runs in tests/test_torch_serve_mesh.py: the port's
sharded serving (``launch/steps.build_prefill_step`` and
``build_serve_step``) on a (data 2, model 2) gloo group of CPU processes
with no client axes (``launch.mesh.run_ranks``).  It imports no jax, so
that a spawned rank starts quickly; it returns numpy arrays.

Each case (:data:`CASES`) is one smoke model in float32 from the whole
numpy params the test hands over:

* a prefill case: the prefill step over a prompt of ``text`` tokens (a
  VLM's prefix and whisper's frames as ``embeds``), its cache shards
  seated in the serve step's zeroed ones (``models/model.seat_caches``),
  then :data:`STEPS` teacher-forced decode steps;
* a seeded case: the serve step from whole caches the test draws
  (``caches_from_jax`` cuts this rank's shards), decoding at the
  case's positions: the long shape's split-KV cache (``kv_seq`` over
  "data") and ``cache_seq_shard="model"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MESH = {"data": 2, "model": 2}
WORLD = 4
BATCH = 4
STEPS = 3

#: name -> (model, config changes, kind, text tokens or seq_len, extra):
#: ``prefill`` cases give the prompt's text tokens (the decode cache
#: holds them, a prefix, and ``STEPS`` more, or ``seq`` where given);
#: ``seeded`` cases their shape's kind, seq_len, positions and
#: ``cache_seq_shard``.
CASES = {
    "starcoder2-3b": dict(model="starcoder2-3b", kind="prefill", text=32),
    "starcoder2-3b-kv1": dict(model="starcoder2-3b", kind="prefill",
                              text=32, kv_heads=1),
    "mamba2-1-3b": dict(model="mamba2-1-3b", kind="prefill", text=32),
    "deepseek-v2-lite-16b": dict(model="deepseek-v2-lite-16b",
                                 kind="prefill", text=32),
    "whisper-base": dict(model="whisper-base", kind="prefill", text=32),
    "llava-next-mistral-7b": dict(model="llava-next-mistral-7b",
                                  kind="prefill", text=32),
    # a prompt past the local layers' 64-slot window: the rings wrap
    "gemma3-27b": dict(model="gemma3-27b", kind="prefill", text=80),
    "kimi-k2-1t-a32b": dict(model="kimi-k2-1t-a32b", kind="prefill",
                            text=32),
    # the other fsdp serve plan: attention, SSD and MoE layers, 2-D
    "jamba-1-5-large-398b": dict(model="jamba-1-5-large-398b",
                                 kind="prefill", text=32),
    # the long shape: batch 1, kv_seq over "data" (the global layers'
    # 128 slots and the local rings' 64 halved), a position in each half
    "gemma3-27b-long": dict(model="gemma3-27b", kind="long", seq=128,
                            batch=1, positions=(61, 64, 126)),
    "starcoder2-3b-seq-model": dict(model="starcoder2-3b", kind="decode",
                                    seq=48, positions=(20, 31, 47),
                                    cache_seq_shard="model"),
}


def _no_drop(cfg):
    """The capacity factor raised to 8 (no MoE token drops), as the
    serving tests' reference has it."""
    return dataclasses.replace(cfg, layer_pattern=tuple(
        dataclasses.replace(sp, moe=dataclasses.replace(
            sp.moe, capacity_factor=8.0)) if sp.moe else sp
        for sp in cfg.layer_pattern))


def case_cfg(case: str, get_config, reduce_for_smoke):
    """The case's smoke config in float32 (no drops), from either
    package's ``get_config``/``reduce_for_smoke``."""
    c = CASES[case]
    cfg = dataclasses.replace(reduce_for_smoke(get_config(c["model"])),
                              dtype="float32")
    if "kv_heads" in c:
        cfg = dataclasses.replace(cfg, layer_pattern=tuple(
            dataclasses.replace(sp, attention=dataclasses.replace(
                sp.attention, num_kv_heads=c["kv_heads"]))
            for sp in cfg.layer_pattern))
    return _no_drop(cfg)


def port_cfg(case: str):
    from repro_torch.configs import get_config, reduce_for_smoke
    return case_cfg(case, get_config, reduce_for_smoke)


def n_front(cfg) -> int:
    """The stub frontend's tokens: whisper's frames, a VLM's 16 patches."""
    if cfg.encoder is not None:
        return cfg.encoder.src_len
    return min(cfg.stub_frontend_tokens, 16) if cfg.stub_frontend else 0


def shapes(case: str, cfg):
    """(prefill ShapeSpec or None, serve ShapeSpec, the serve plan's
    ``cache_seq_shard``), the cut shapes of the case."""
    from repro_torch.launch.steps import ShapeSpec
    c = CASES[case]
    if c["kind"] == "prefill":
        nf = n_front(cfg)
        lead = nf if cfg.encoder is None else 0
        pre = ShapeSpec("prefill_32k", c["text"] + lead, BATCH, "prefill")
        dec = ShapeSpec("decode_32k", c.get("seq", lead + c["text"] + STEPS),
                        BATCH, "decode")
        return pre, dec, None
    kind = c["kind"]
    return None, ShapeSpec("long_500k" if kind == "long" else "decode_32k",
                           c["seq"], c.get("batch", BATCH), kind), \
        c.get("cache_seq_shard")


def _torch(tree):
    from repro_torch import tree as T
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    from repro_torch import tree as T
    return [x.detach().cpu().numpy() for x in T.leaves(tree)]


def on_group(rank, world, store, inputs):
    """One rank's every case.  ``inputs``: {case: dict(params (numpy
    tree), tokens (B, n) int32, embeds or None, caches (numpy leaves of
    the whole seeded caches) or None)}."""
    from repro_torch.launch import mesh as MM
    torch.set_num_threads(1)
    mesh = MM.make_test_group(world, rank, store, shape=MESH,
                              client_axes=())
    try:
        return {"rank": rank, "cases": {
            case: run_case(mesh, case, inputs[case]) for case in inputs}}
    finally:
        mesh.close()


def run_case(mesh, case, inp):
    from repro_torch import tree as T
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as TM
    cfg = port_cfg(case)
    c = CASES[case]
    pre_shape, dec_shape, seq_shard = shapes(case, cfg)
    from repro_torch.sharding import plan_for
    params = _torch(inp["params"])
    # the model's own plan (its smoke config's name has none)
    plan = plan_for(c["model"])
    serve = ST.build_serve_step(cfg, mesh, dec_shape, plan=plan,
                                cache_seq_shard=seq_shard)
    p_loc = serve.init(params)
    b_loc = serve.batch_shapes["token"][0]
    r0 = 0 if b_loc == dec_shape.global_batch else \
        mesh.axis_group("data").index * b_loc
    toks = torch.from_numpy(inp["tokens"][r0:r0 + b_loc])
    out = {"rows": (r0, b_loc), "two_d": serve.static["fsdp"] is not None}
    if c["kind"] == "prefill":
        prefill = ST.build_prefill_step(cfg, mesh, pre_shape, plan=plan)
        text = prefill.static["text_len"]
        batch = {"tokens": toks[:, :text]}
        if inp["embeds"] is not None:
            batch["embeds"] = torch.from_numpy(
                inp["embeds"][r0:r0 + b_loc])
        logits, pre = prefill.fn(prefill.init(params), batch)
        out["prefill_logits"] = logits.numpy()
        out["prefill_caches"] = _np(pre)
        caches = TM.seat_caches(serve.new_caches(), pre)
        lead = prefill.static["n_front"] if cfg.encoder is None else 0
        steps = [(lead + text + i, toks[:, text + i]) for i in range(STEPS)]
    else:
        from repro_torch.models.model import cache_meta
        td = T.flatten(cache_meta(cfg, dec_shape.global_batch,
                                  dec_shape.seq_len, c["kind"] == "long"))[1]
        caches = TM.caches_from_jax(
            td.unflatten(inp["caches"]), cfg, dec_shape.global_batch,
            dec_shape.seq_len, long_mode=c["kind"] == "long", device="cpu",
            specs=serve.static["cspecs"], mesh=mesh)
        steps = [(p, toks[:, i]) for i, p in enumerate(c["positions"])]
    out["step_logits"] = [serve.fn(p_loc, caches, pos, tok)[0].numpy()
                          for pos, tok in steps]
    out["caches"] = _np(caches)
    return out
