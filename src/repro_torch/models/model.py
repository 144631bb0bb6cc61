"""Stack builder: ArchConfig -> parameters, the training forward and loss,
prefill and one-token decode.

Counterpart of ``repro/models/model.py``, for every model of the zoo:
attention (GQA, windowed or MLA) and Mamba-2 (SSD) mixers, dense or MoE
FFNs, Whisper's encoder with cross-attention, and the VLM's stub frontend
(precomputed embeddings prepended to the tokens').  The parameter tree is
the JAX package's, leaf for leaf:

    {"embed": (V, d), "blocks": (group, ...), "final_norm": {"scale"},
     "lm_head": (d, V), "encoder": {"blocks", "final_norm"}}

where ``blocks`` is a tuple with one dict per run of identical layer specs
(:func:`pattern_groups`), each leaf stacked ``(pattern_repeats, count,
...)``, and the encoder's blocks ``(num_layers, ...)``.  The per-leaf
compress, the packed wire layout and so the wire bytes follow this leaf
order and these shapes.  The JAX scans over repeats and over a group's
layers are loops here.  ``remat`` recomputes a pattern repeat's
activations in the backward as JAX's ``jax.checkpoint`` around the scan
body does: ``"full"`` (the default, as in JAX) keeps only each repeat's
input, ``"dots"`` also the matrix products' outputs, ``"none"`` keeps
everything; the losses and gradients are the same bits.

The decode caches (:func:`cache_meta`) are stacked the same way, one dict
per group; :func:`decode_step` writes them in place.

Sharded serving (``launch/steps.build_prefill_step``, ``build_serve_step``):
:func:`prefill` and :func:`decode_step` take ``tp`` (split leaves, this
rank's batch rows, its cache shards under ``sharding.cache_rules``, the
logits gathered over the vocabulary), ``fsdp`` (the 2-D serving's
``models.tensor.Serve2D``) and, at decode, ``kv`` (the split-KV cache's
``models.tensor.KVSplit``).

Tensor parallelism: with ``tp`` (a ``launch.mesh.ModelGroup``, which
``launch/steps.build_train_step`` closes over; no global state) the
training forward and loss take each leaf as this rank's shard
(``models/params.shard`` under ``sharding.param_rules("tp")``): the
layers' ``*_tp`` forms, a vocabulary-split embedding (each rank looks up
the tokens of its rows, zeros elsewhere, summed over the group), a
vocabulary-split head (the tied head reads the split embedding) and a
vocabulary-parallel cross-entropy (:func:`vocab_parallel_ce`).

FSDP: with ``fsdp`` (a ``models.tensor.FSDP``) the leaves are also split
along their ``embed`` dim over the data group, and this rank holds its
slice of the batch.  Each leaf is gathered at its use: a layer's inside
its pattern repeat's ``remat`` region (so the backward gathers it again
and never holds every layer's whole weights), the embedding, final norm
and head where they are read.  The loss is the whole batch's mean
(``FSDP.mean``), the MoE load-balance loss the whole batch's too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import tensor as TPX
from repro_torch.models.params import (DTYPES, P, abstract, leaf_dtype,
                                       materialize, shard, stack_tree)

# the matrix products whose outputs remat="dots" keeps (JAX's
# dots_with_no_batch_dims_saveable; einsum lowers to bmm)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)

_F32 = torch.float32
# Weight of the MoE load-balance loss in the training loss (the JAX
# package's ``loss_fn`` default, which no caller there changes).
MOE_AUX_WEIGHT = 0.01


def pattern_groups(cfg: ArchConfig) -> List[Tuple[LayerSpec, int]]:
    """Coalesce consecutive identical LayerSpecs into (spec, count) runs."""
    groups: List[Tuple[LayerSpec, int]] = []
    for spec in cfg.layer_pattern:
        if groups and groups[-1][0] == spec:
            groups[-1] = (spec, groups[-1][1] + 1)
        else:
            groups.append((spec, 1))
    return groups


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _block_params(cfg: ArchConfig, spec: LayerSpec) -> Dict[str, Any]:
    d = cfg.d_model
    p: Dict[str, Any] = {"norm_mixer": L.rmsnorm_params(d)}
    if spec.kind == "attn":
        p["mixer"] = L.attention_params(d, spec.attention)
        if cfg.encoder is not None:
            p["cross"] = L.attention_params(
                d, dataclasses.replace(spec.attention, window=None))
            p["norm_cross"] = L.rmsnorm_params(d)
    else:
        p["mixer"] = L.ssm_params(d, spec.ssm)
    if spec.d_ff:
        p["norm_ffn"] = L.rmsnorm_params(d)
        p["ffn"] = L.mlp_params(d, spec.d_ff, spec.gated_mlp)
    elif spec.moe:
        p["norm_ffn"] = L.rmsnorm_params(d)
        p["ffn"] = L.moe_params(d, spec.moe)
    return p


def abstract_params(cfg: ArchConfig):
    """The tree of :class:`P` records."""
    d = cfg.d_model
    tree: Dict[str, Any] = {
        "embed": P((cfg.padded_vocab, d), ("vocab", "embed")),
        "blocks": tuple(
            stack_tree(stack_tree(_block_params(cfg, spec), count),
                       cfg.pattern_repeats)
            for spec, count in pattern_groups(cfg)),
        "final_norm": L.rmsnorm_params(d),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = P((d, cfg.padded_vocab), ("embed", "vocab"),
                            init="scaled", fan_in=d)
    if cfg.encoder is not None:
        enc_attn = dataclasses.replace(
            cfg.layer_pattern[0].attention, window=None, causal=False)
        enc_block = {
            "norm_mixer": L.rmsnorm_params(d),
            "mixer": L.attention_params(d, enc_attn),
            "norm_ffn": L.rmsnorm_params(d),
            "ffn": L.mlp_params(d, 4 * d, gated=False),
        }
        tree["encoder"] = {
            "blocks": stack_tree(enc_block, cfg.encoder.num_layers),
            "final_norm": L.rmsnorm_params(d),
        }
    return tree


def abstract_params_sds(cfg: ArchConfig, *, mode=None, device="cuda"):
    """The params of ``cfg`` as fake tensors on ``device`` under the
    ``FakeTensorMode`` ``mode`` (``models/params.abstract``): JAX's
    ``ShapeDtypeStruct`` tree, nothing allocated."""
    return abstract(abstract_params(cfg), cfg.dtype, mode=mode,
                    device=device)


def init_params(cfg: ArchConfig, seed: int = 0, device: DeviceLike = None):
    """Random weights from a seed (drawn in float32, cast to each leaf's
    dtype: ``cfg.dtype``, float32 for the norm scales)."""
    return materialize(abstract_params(cfg), seed, cfg.dtype,
                       resolve_device(device))


def _from_jax(metas, np_tree, default_dtype: str, dev, what: str):
    """Numpy leaves of the JAX package on ``dev`` in the dtypes of the
    :class:`P` tree ``metas``, after checking structure and shapes.  A
    2-byte leaf (numpy ``bfloat16`` or its ``uint16`` bit view) is taken
    bit for bit."""
    metas, td = T.flatten(metas)
    arrays, td_np = T.flatten(np_tree)
    if td_np != td:
        raise ValueError(f"{what} tree differs from the expected one")
    out = []
    for p, a in zip(metas, arrays):
        a = np.asarray(a)
        if tuple(a.shape) != p.shape:
            raise ValueError(f"shape {a.shape} where {p.shape} is expected")
        dtype = leaf_dtype(p, default_dtype)
        if a.dtype.itemsize == 2:
            t = torch.from_numpy(a.view(np.int16).copy()).view(dtype)
        else:
            t = torch.from_numpy(np.array(a, np.float32)).to(dtype)
        out.append(t.to(dev))
    return td.unflatten(out)


def params_from_jax(np_params, cfg: ArchConfig, device: DeviceLike = None):
    """The JAX package's parameter tree (numpy leaves) on ``device``, same
    structure, shapes and dtypes (bfloat16 as its bits)."""
    return _from_jax(abstract_params(cfg), np_params, cfg.dtype,
                     resolve_device(device), f"{cfg.name}'s parameter")


def caches_from_jax(np_caches, cfg: ArchConfig, batch: int, seq_len: int, *,
                    long_mode: bool = False, device: DeviceLike = None,
                    specs=None, mesh=None):
    """The JAX package's decode caches (numpy leaves, ``cache_meta(cfg,
    batch, seq_len, long_mode)``'s tree and shapes) as the port's; with
    ``specs`` (``pspecs`` of the caches under ``sharding.cache_rules``)
    and ``mesh``, cut to this rank's shards (``models/params.shard``)."""
    dev = resolve_device(device)
    whole = _from_jax(cache_meta(cfg, batch, seq_len, long_mode), np_caches,
                      cfg.dtype, torch.device("cpu"), f"{cfg.name}'s cache")
    if specs is not None:
        whole = shard(whole, specs, mesh)
    return T.tree_map(lambda x: x.to(dev), whole)


# ---------------------------------------------------------------------------
# Forward and loss
# ---------------------------------------------------------------------------


def _block_fwd(cfg: ArchConfig, spec: LayerSpec, p, x, *, positions,
               enc_out=None, window_override=None, chunk=1024,
               collect_cache=False, tp=None, fsdp=None):
    """Returns (x, aux, cache_entry): aux the MoE load-balance loss (None
    without an MoE); with ``collect_cache``, the layer's decode cache over
    the sequence (k and v, MLA's ckv, or the SSD's state and conv tail;
    with an encoder, the cross keys and values), else {}.  ``tp``: the
    model group of split leaves (the cache entry then this rank's shard
    of it); ``fsdp``: the batch split over the data group (``p`` gathered
    already), for the MoE load-balance loss."""
    if tp is not None:
        return _block_fwd_tp(cfg, spec, p, x, positions=positions,
                             enc_out=enc_out,
                             window_override=window_override, chunk=chunk,
                             tp=tp, fsdp=fsdp, collect_cache=collect_cache)
    h = L.rmsnorm(p["norm_mixer"], x, cfg.norm_eps)
    entry = {}
    if spec.kind == "attn":
        out, kv = L.attention_fwd(p["mixer"], spec.attention, h,
                                  positions=positions,
                                  window_override=window_override,
                                  chunk=chunk)
        if collect_cache:
            if spec.attention.is_mla:
                entry["ckv"] = kv[0]
            else:
                entry["k"], entry["v"] = kv
        x = x + out
        if enc_out is not None and "cross" in p:
            hc = L.rmsnorm(p["norm_cross"], x, cfg.norm_eps)
            out, _ = L.attention_fwd(p["cross"], spec.attention, hc,
                                     positions=positions, kv=enc_out,
                                     chunk=chunk)
            x = x + out
        if collect_cache and cfg.encoder is not None:
            entry["cross_k"] = TPX.mm("bsd,dhk->bshk", enc_out,
                                            p["cross"]["wk"])
            entry["cross_v"] = TPX.mm("bsd,dhk->bshk", enc_out,
                                            p["cross"]["wv"])
    else:
        out, ssm_cache = L.ssm_fwd(p["mixer"], spec.ssm, h,
                                   norm_eps=cfg.norm_eps)
        if collect_cache:
            entry = ssm_cache
        x = x + out
    aux = None
    if spec.d_ff:
        h = L.rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
        x = x + L.mlp_fwd(p["ffn"], h)
    elif spec.moe:
        h = L.rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
        out, aux = L.moe_fwd(p["ffn"], spec.moe, h, fsdp)
        x = x + out
    return x, aux, entry


def _block_fwd_tp(cfg: ArchConfig, spec: LayerSpec, p, x, *, positions,
                  enc_out, window_override, chunk, tp, fsdp=None,
                  collect_cache=False):
    """:func:`_block_fwd` on split leaves (the layers' ``*_tp`` forms);
    with ``collect_cache``, the layer's cache entry in the cache specs'
    layout: its kv heads where the model axis splits them (else every
    one), the MLA latent whole, the SSD state's heads and the conv tail's
    channels where it splits them."""
    h = L.rmsnorm(p["norm_mixer"], x, cfg.norm_eps)
    entry = {}
    if spec.kind == "attn":
        out, kv = L.attention_fwd_tp(p["mixer"], spec.attention, h,
                                     group=tp, positions=positions,
                                     window_override=window_override,
                                     chunk=chunk)
        if collect_cache:
            if spec.attention.is_mla:
                entry["ckv"] = kv[0]
            else:
                entry["k"], entry["v"] = kv
        x = x + out
        if enc_out is not None and "cross" in p:
            hc = L.rmsnorm(p["norm_cross"], x, cfg.norm_eps)
            out, _ = L.attention_fwd_tp(p["cross"], spec.attention, hc,
                                        group=tp, positions=positions,
                                        kv=enc_out, chunk=chunk)
            x = x + out
        if collect_cache and cfg.encoder is not None:
            entry["cross_k"] = TPX.mm("bsd,dhk->bshk", enc_out,
                                      p["cross"]["wk"])
            entry["cross_v"] = TPX.mm("bsd,dhk->bshk", enc_out,
                                      p["cross"]["wv"])
    else:
        out, sc = L.ssm_fwd_tp(p["mixer"], spec.ssm, h, group=tp,
                               norm_eps=cfg.norm_eps)
        if collect_cache:
            entry = _ssm_entry_shard(sc, tp)
        x = x + out
    aux = None
    if spec.d_ff:
        h = L.rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
        x = x + L.mlp_fwd_tp(p["ffn"], h, group=tp, d_ff=spec.d_ff)
    elif spec.moe:
        h = L.rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
        out, aux = L.moe_fwd_tp(p["ffn"], spec.moe, h, group=tp, fsdp=fsdp)
        x = x + out
    return x, aux, entry


def _ssm_entry_shard(entry, tp):
    """The SSD's whole cache entry (every rank runs the scan whole) cut to
    this rank's share where the model axis divides it: the state's heads
    (dim 1), the conv tail's channels (dim 2)."""
    out = {}
    for k, dim in (("state", 1), ("conv", 2)):
        x = entry[k]
        if x.shape[dim] % tp.size == 0:
            lo, hi = tp.chunk(x.shape[dim])
            x = x.narrow(dim, lo, hi - lo)
        out[k] = x
    return out


def _encoder_fwd(cfg: ArchConfig, enc_params, frames, tp=None, fsdp=None):
    """frames: (b, src, d) precomputed frame embeddings (the stub
    frontend).  Non-causal self-attention with rotary, then the GELU MLP,
    per encoder layer; the final norm."""
    d = cfg.d_model
    b, src = frames.shape[:2]
    pos = torch.arange(src, device=frames.device).expand(b, src)
    a = cfg.layer_pattern[0].attention
    x = frames.to(DTYPES[cfg.dtype])
    g = a.num_heads // a.num_kv_heads
    for i in range(cfg.encoder.num_layers):
        p = T.tree_map(lambda t: t[i], enc_params["blocks"])
        if fsdp is not None:
            p = fsdp.tree(p, fsdp.specs["encoder"]["blocks"], 1)
        h = L.rmsnorm(p["norm_mixer"], x, cfg.norm_eps)
        if tp is not None:
            out, _ = L.gqa_tp(p["mixer"], a, h, group=tp, positions=pos,
                              causal=False, rotary=True, chunk=src)
            x = x + out
            hf = L.rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
            x = x + L.mlp_fwd_tp(p["ffn"], hf, group=tp, d_ff=4 * d)
            continue
        q = TPX.mm("bsd,dhk->bshk", h, p["mixer"]["wq"])
        k = TPX.mm("bsd,dhk->bshk", h, p["mixer"]["wk"])
        v = TPX.mm("bsd,dhk->bshk", h, p["mixer"]["wv"])
        q = L.rope(q, pos, a.rope_theta)
        k = L.rope(k, pos, a.rope_theta)
        qg = q.reshape(b, src, a.num_kv_heads, g, a.head_dim)
        out = L.chunked_attention(qg, k, v, causal=False, chunk=src)
        out = out.reshape(b, src, a.num_heads * a.head_dim)
        x = x + TPX.mm("bsk,kd->bsd", out,
                             p["mixer"]["wo"].reshape(-1, d))
        hf = L.rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
        x = x + L.mlp_fwd(p["ffn"], hf)
    return L.rmsnorm(_used(enc_params, "final_norm", fsdp,
                           None if fsdp is None else fsdp.specs["encoder"]),
                     x, cfg.norm_eps)


def _used(params, name: str, fsdp, specs=None):
    """``params[name]`` as its use takes it: gathered over the data group
    with ``fsdp`` (``specs`` the spec tree beside ``params``; the whole
    params' by default), else as it is."""
    if fsdp is None:
        return params[name]
    specs = fsdp.specs if specs is None else specs
    return fsdp.tree(params[name], specs[name])


def _vocab_split(cfg: ArchConfig, params, tp) -> bool:
    """Whether ``tp`` splits the vocabulary (the embedding's rows)."""
    return tp is not None and params["embed"].shape[0] != cfg.padded_vocab


def _embed_tokens(cfg: ArchConfig, params, tokens, tp=None, fsdp=None):
    """The token embeddings.  Vocabulary-split: each rank looks up the
    tokens of its rows (zeros for the others) and the group sums them, in
    float32, so the result is the whole lookup's bits."""
    emb = _used(params, "embed", fsdp)
    tok = tokens.long()
    if isinstance(emb, TPX.Split2D):
        return _embed_2d(cfg, emb, tok,
                         tp if _vocab_split(cfg, params, tp) else None)
    if not _vocab_split(cfg, params, tp):
        return emb[tok].to(DTYPES[cfg.dtype])
    v0 = emb.shape[0] * tp.index
    local = (tok >= v0) & (tok < v0 + emb.shape[0])
    rows = emb[(tok - v0).clamp(0, emb.shape[0] - 1)]
    rows = torch.where(local[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return TPX.reduce(rows, tp).to(DTYPES[cfg.dtype])


def _embed_2d(cfg: ArchConfig, emb, tok, tp):
    """The 2-D serving's lookup in an embedding split along ``embed`` over
    the data group (and on the vocabulary over ``tp``): the tokens of the
    data group's rows are looked up in this rank's block (zeros for rows
    of another rank's vocabulary, summed over ``tp`` in float32, the
    whole lookup's bits), gathered along ``embed``, and this rank's rows
    kept."""
    ctx, shard = emb.ctx, emb.shard
    ta = tok if ctx.rows is None else ctx.rows.all_gather(tok, 0)
    if tp is None:
        rows = shard[ta]
    else:
        v0 = shard.shape[0] * tp.index
        local = (ta >= v0) & (ta < v0 + shard.shape[0])
        rows = shard[(ta - v0).clamp(0, shard.shape[0] - 1)]
        rows = tp.all_reduce(torch.where(
            local[..., None], rows,
            torch.zeros((), dtype=rows.dtype, device=rows.device)))
    rows = ctx.group.all_gather(rows, rows.dim() - 1)
    if ctx.rows is not None:
        rows = rows.narrow(0, ctx.rows.index * tok.shape[0], tok.shape[0])
    return rows.to(DTYPES[cfg.dtype])


def _embed_inputs(cfg: ArchConfig, params, tokens, frontend_embeds,
                  tp=None, fsdp=None):
    """(x, enc_out): the token embeddings, after the VLM's stub prefix
    where there is one, and the encoder's output (or None)."""
    x = _embed_tokens(cfg, params, tokens, tp, fsdp)
    enc_out = None
    if cfg.encoder is not None:
        enc_out = _encoder_fwd(cfg, params["encoder"], frontend_embeds, tp,
                               fsdp)
    elif cfg.stub_frontend and frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    return x, enc_out


def _repeat_layers(cfg: ArchConfig, params, r: int, fsdp=None):
    """(group, index in the group, spec, that layer's parameters) of
    pattern repeat ``r``, in layer order; with ``fsdp`` each layer's
    parameters gathered over the data group as it comes."""
    for gi, ((spec, count), gp) in enumerate(zip(pattern_groups(cfg),
                                                 params["blocks"])):
        for i in range(count):
            p_one = T.tree_map(lambda a: a[r, i], gp)
            if fsdp is not None:
                p_one = fsdp.tree(p_one, fsdp.specs["blocks"][gi], 2)
            yield gi, i, spec, p_one


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, remat: str):
    """``body`` wrapped for ``remat``: ``"none"`` as is; ``"full"`` under
    ``torch.utils.checkpoint`` (only the inputs kept, the rest recomputed
    in the backward); ``"dots"`` a selective checkpoint that keeps the
    matrix products' outputs.  Without a graph being recorded (no grad)
    there is nothing to keep, and the body runs as is."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat={remat!r}: none | full | dots")
    if remat == "none" or not torch.is_grad_enabled():
        return body
    import functools
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: checkpoint(body, *args, use_reentrant=False, **kw)


def _lm_head(cfg: ArchConfig, params, x, tp=None, fsdp=None):
    """Logits; vocabulary-split under ``tp``: this rank's columns."""
    if _vocab_split(cfg, params, tp):
        x = TPX.copy(x, tp)
    if cfg.tie_embeddings:
        return TPX.mm("bsd,vd->bsv", x, _used(params, "embed", fsdp))
    return TPX.mm("bsd,dv->bsv", x, _used(params, "lm_head", fsdp))


def _window_override(cfg: ArchConfig, spec: LayerSpec, long_mode: bool):
    """The window the long shapes impose on a full-attention layer of a
    ``window_all`` model (None elsewhere)."""
    if long_mode and spec.kind == "attn" and spec.attention.window is None \
            and cfg.long_strategy == "window_all" and cfg.long_context_window:
        return cfg.long_context_window
    return None


def forward(cfg: ArchConfig, params, tokens, *, frontend_embeds=None,
            remat: str = "full", chunk: int = 1024,
            long_mode: bool = False, tp=None, fsdp=None):
    """tokens: (b, s) integers.  frontend_embeds: (b, s_front, d) for a
    stub frontend (the VLM's prefix, prepended; the audio encoder's
    input).  Returns (logits (b, s_front + s or s, V), aux): aux the
    float32 sum of the MoE layers' load-balance losses, in layer order (0
    without an MoE layer).  ``remat``: what each pattern repeat keeps for
    the backward (``"full"``, ``"dots"`` or ``"none"``; the module
    docstring).  ``long_mode``: the long shapes' window on a
    ``window_all`` model's full-attention layers (:func:`_window_override`).
    ``tp``: split leaves (the module docstring); the logits are then this
    rank's vocabulary columns where the vocabulary is split.  ``fsdp``:
    leaves split over the data group too, and this rank's batch slice."""
    x, enc_out = _embed_inputs(cfg, params, tokens, frontend_embeds, tp,
                               fsdp)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    wov = [_window_override(cfg, spec, long_mode)
           for spec, _ in pattern_groups(cfg)]

    def repeat(x, aux, r):
        for gi, _, spec, p_one in _repeat_layers(cfg, params, r, fsdp):
            x, a, _ = _block_fwd(cfg, spec, p_one, x, positions=positions,
                                 enc_out=enc_out, window_override=wov[gi],
                                 chunk=chunk, tp=tp, fsdp=fsdp)
            if a is not None:
                aux = aux + a
        return x, aux

    body = _remat(repeat, remat)
    aux = torch.zeros((), dtype=_F32, device=x.device)
    for r in range(cfg.pattern_repeats):
        x, aux = body(x, aux, r)
    x = L.rmsnorm(_used(params, "final_norm", fsdp), x, cfg.norm_eps)
    return _lm_head(cfg, params, x, tp, fsdp), aux


def vocab_parallel_ce(lg, tgt, tp):
    """Per position ``logsumexp(lg) - lg[tgt]`` (float32) of logits split
    over the vocabulary: ``lg`` (..., V / M) this rank's columns, ``tgt``
    (...) global ids.  The max is all-reduced (MAX; a constant to the
    gradient), then the sum of exponentials and the target's logit, each
    the owner's alone (zeros elsewhere), are all-reduced (g); the
    gradient of ``lg`` is this rank's columns of the whole softmax's."""
    V_l = lg.shape[-1]
    v0 = V_l * tp.index
    m = tp.all_reduce(lg.detach().amax(dim=-1), "max")
    se = TPX.reduce(torch.exp(lg - m[..., None]).sum(dim=-1), tp)
    lse = m + torch.log(se)
    local = (tgt >= v0) & (tgt < v0 + V_l)
    picked = lg.gather(-1, (tgt - v0).clamp(0, V_l - 1)[..., None])[..., 0]
    picked = TPX.reduce(torch.where(local, picked, 0.0), tp)
    return lse - picked


def loss_fn(cfg: ArchConfig, params, tokens, *, frontend_embeds=None,
            remat: str = "full", chunk: int = 1024, tp=None, fsdp=None):
    """Next-token cross-entropy over the tokens (a VLM's prefix positions
    sliced off) plus ``MOE_AUX_WEIGHT`` times the MoE load-balance loss
    (0 for a model without MoE layers).  ``tp``: split leaves, with the
    vocabulary-parallel cross-entropy where the vocabulary is split (the
    same loss on every rank).  ``fsdp``: this rank's batch slice, and the
    loss the whole batch's mean over the data group."""
    logits, aux = forward(cfg, params, tokens,
                          frontend_embeds=frontend_embeds, remat=remat,
                          chunk=chunk, tp=tp, fsdp=fsdp)
    n_front = 0
    if cfg.stub_frontend and frontend_embeds is not None \
            and cfg.encoder is None:
        n_front = frontend_embeds.shape[1]
    lg = logits[:, n_front:-1].to(_F32)
    tgt = tokens[:, 1:].long()
    if _vocab_split(cfg, params, tp):
        ce = vocab_parallel_ce(lg, tgt, tp).mean()
    else:
        lse = torch.logsumexp(lg, dim=-1)
        ce = (lse - lg.gather(-1, tgt[..., None])[..., 0]).mean()
    if fsdp is not None:
        ce = fsdp.mean(ce)
    return ce + MOE_AUX_WEIGHT * aux


# ---------------------------------------------------------------------------
# Serving: prefill and decode
# ---------------------------------------------------------------------------


def _stack_caches(cfg: ArchConfig, entries):
    """Per group, the layers' cache entries (a list in layer order)
    stacked ``(pattern_repeats, count, ...)``."""
    out = []
    for (_, count), group in zip(pattern_groups(cfg), entries):
        out.append({k: torch.stack([
            torch.stack([group[r * count + c][k] for c in range(count)])
            for r in range(cfg.pattern_repeats)]) for k in group[0]})
    return tuple(out)


def _whole_vocab(cfg: ArchConfig, params, logits, tp):
    """Logits of this rank's vocabulary columns gathered over ``tp`` where
    the vocabulary is split (the serving steps return the whole
    vocabulary's)."""
    if _vocab_split(cfg, params, tp):
        return tp.all_gather(logits, logits.dim() - 1)
    return logits


def prefill(cfg: ArchConfig, params, tokens, *, frontend_embeds=None,
            chunk: int = 1024, tp=None, fsdp=None):
    """The forward over the prompt (a VLM's prefix first): (the last
    position's logits (b, V), the caches), each cache leaf stacked
    ``(repeats, count, b, ...)`` as :func:`cache_meta` lays it out, over
    the prompt's length (k, v, ckv) or whole (the SSD's state and conv
    tail, the cross keys and values).

    ``tp``: split leaves (:func:`forward`) and this rank's rows of the
    batch; each cache leaf is then this rank's shard under
    ``sharding.cache_rules("decode")`` and the logits the whole
    vocabulary's.  ``fsdp``: the 2-D serving of the ``fsdp`` plans
    (``models.tensor.Serve2D``): leaves split along ``embed`` over the
    data group too, multiplied without being gathered."""
    x, enc_out = _embed_inputs(cfg, params, tokens, frontend_embeds, tp,
                               fsdp)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    entries = [[] for _ in pattern_groups(cfg)]
    for r in range(cfg.pattern_repeats):
        for gi, _, spec, p_one in _repeat_layers(cfg, params, r, fsdp):
            x, _, entry = _block_fwd(cfg, spec, p_one, x,
                                     positions=positions, enc_out=enc_out,
                                     chunk=chunk, collect_cache=True, tp=tp)
            entries[gi].append(entry)
    x = L.rmsnorm(_used(params, "final_norm", fsdp), x[:, -1:],
                  cfg.norm_eps)
    logits = _lm_head(cfg, params, x, tp, fsdp)[:, 0]
    return _whole_vocab(cfg, params, logits, tp), _stack_caches(cfg, entries)


def seat_caches(caches, pre):
    """Write prefill caches ``pre`` (over a prompt of n positions) into
    decode caches of the same tree: a leaf of the same shape whole, else
    along its kv_seq dim (3 of (repeat, count, b, S, ...)): position t
    into slot t, or, where S < n (a ring), the last S positions into
    slots t % S.  Returns ``caches``."""
    for z, p in zip(T.leaves(caches), T.leaves(pre)):
        if z.shape == p.shape:
            z.copy_(p)
            continue
        n, S = p.shape[3], z.shape[3]
        if n <= S:
            z[:, :, :, :n] = p
        else:
            t = torch.arange(n - S, n, device=z.device)
            z[:, :, :, t % S] = p[:, :, :, t]
    return caches


def decode_layout(cfg: ArchConfig, seq_len: int, long_mode: bool):
    """Static per-GROUP cache layout: (kind, ring, window_eff, cache_len)."""
    out = []
    for spec, _ in pattern_groups(cfg):
        if spec.kind == "ssm":
            out.append(("ssm", False, None, 0))
            continue
        window = _window_override(cfg, spec, long_mode) \
            or spec.attention.window
        ring = window is not None and window < seq_len
        cache_len = window if ring else seq_len
        out.append(("attn", ring, window, cache_len))
    return tuple(out)


def _layer_cache_meta(cfg: ArchConfig, spec: LayerSpec, batch: int,
                      cache_len: int):
    if spec.kind == "ssm":
        return L.ssm_cache(spec.ssm, cfg.d_model, batch, cfg.dtype)
    a = spec.attention
    meta = L.attention_cache(a, batch, cache_len, cfg.dtype)
    if cfg.encoder is not None:
        shape = (batch, cfg.encoder.src_len, a.num_kv_heads, a.head_dim)
        axes = ("batch", "enc_seq", "kv_heads", "head_dim")
        meta["cross_k"] = P(shape, axes, init="zeros", dtype=cfg.dtype)
        meta["cross_v"] = P(shape, axes, init="zeros", dtype=cfg.dtype)
    return meta


def cache_meta(cfg: ArchConfig, batch: int, seq_len: int,
               long_mode: bool = False):
    """The decode cache as a tree of :class:`P` (zeros; ``materialize``
    allocates it): a tuple with one dict per group, leaves stacked
    ``(pattern_repeats, count, ...)``."""
    layout = decode_layout(cfg, seq_len, long_mode)
    return tuple(
        stack_tree(stack_tree(_layer_cache_meta(cfg, spec, batch, lay[3]),
                              count), cfg.pattern_repeats)
        for (spec, count), lay in zip(pattern_groups(cfg), layout))


def prefill_cache_meta(cfg: ArchConfig, batch: int, prompt: int):
    """The tree of :class:`P` of :func:`prefill`'s caches over a prompt of
    ``prompt`` positions (a VLM's prefix included): :func:`cache_meta`'s,
    with every attention layer's over the whole prompt (no ring)."""
    return tuple(
        stack_tree(stack_tree(_layer_cache_meta(cfg, spec, batch, prompt),
                              count), cfg.pattern_repeats)
        for spec, count in pattern_groups(cfg))


def _block_decode(cfg: ArchConfig, spec: LayerSpec, p, x, c, *, pos: int,
                  ring: bool, window_eff, cache_len: Optional[int] = None,
                  tp=None, kv=None):
    """One layer's decode step: x (b, 1, d) against its cache c (written
    in place).  Returns the new x.  ``tp``, ``kv``: split leaves and
    sharded caches (the layers' decode forms take them; the MLP and MoE
    their ``*_fwd_tp`` forms at one token); ``cache_len``: the whole
    cache's slots (by default the slots ``c`` holds)."""
    h = L.rmsnorm(p["norm_mixer"], x, cfg.norm_eps)
    if spec.kind == "attn":
        a = spec.attention
        self_c = {k: v for k, v in c.items() if k in ("k", "v", "ckv")}
        out, _ = L.attention_decode(p["mixer"], a, h, self_c, pos=pos,
                                    window_override=window_eff, ring=ring,
                                    group=tp, cache_len=cache_len, kv=kv)
        x = x + out
        if "cross_k" in c:
            hc = L.rmsnorm(p["norm_cross"], x, cfg.norm_eps)
            x = x + L.cross_decode(p["cross"], a, hc, c, group=tp)
    else:
        out, _ = L.ssm_decode(p["mixer"], spec.ssm, h, c, group=tp,
                              norm_eps=cfg.norm_eps)
        x = x + out
    if spec.d_ff:
        hf = L.rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
        x = x + L.mlp_fwd_tp(p["ffn"], hf, group=tp, d_ff=spec.d_ff)
    elif spec.moe:
        hf = L.rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
        x = x + L.moe_fwd_tp(p["ffn"], spec.moe, hf, group=tp)[0]
    return x


def decode_step(cfg: ArchConfig, params, caches, pos: int, token, *,
                seq_len: int, long_mode: bool = False, tp=None, fsdp=None,
                kv=None):
    """One decoding step.  caches per :func:`cache_meta`, written in place;
    pos: the index of the current token (a Python int); token: (b,)
    integers on the caches' device.  Returns (logits (b, V), caches).

    Sharded (``launch/steps.build_serve_step``): ``tp`` the model group
    of split leaves, ``fsdp`` the 2-D serving's ``Serve2D`` (as
    :func:`prefill`), ``kv`` the split-KV decode's ``KVSplit`` (the
    caches' sequence split over its group); ``params``, ``caches`` and
    ``token`` this rank's shards and rows (``sharding.param_rules``,
    ``cache_rules``), the logits the whole vocabulary's."""
    layout = decode_layout(cfg, seq_len, long_mode)
    x = _embed_tokens(cfg, params, token[:, None], tp, fsdp)
    for r in range(cfg.pattern_repeats):
        for gi, i, spec, p_one in _repeat_layers(cfg, params, r, fsdp):
            _, ring, window_eff, cache_len = layout[gi]
            c_one = {k: v[r, i] for k, v in caches[gi].items()}
            x = _block_decode(cfg, spec, p_one, x, c_one, pos=pos,
                              ring=ring, window_eff=window_eff,
                              cache_len=cache_len, tp=tp, kv=kv)
    x = L.rmsnorm(_used(params, "final_norm", fsdp), x, cfg.norm_eps)
    logits = _lm_head(cfg, params, x, tp, fsdp)[:, 0]
    return _whole_vocab(cfg, params, logits, tp), caches
