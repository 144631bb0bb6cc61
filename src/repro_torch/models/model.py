"""Stack builder: ArchConfig -> parameters + the training forward and loss.

Counterpart of ``repro/models/model.py``'s training path, for every
decoder of the zoo: attention (GQA, windowed or MLA) and Mamba-2 (SSD)
mixers, dense or MoE FFNs.  The parameter tree is the JAX package's, leaf
for leaf:

    {"embed": (V, d), "blocks": (group, ...), "final_norm": {"scale"},
     "lm_head": (d, V)}

where ``blocks`` is a tuple with one dict per run of identical layer specs
(:func:`pattern_groups`), each leaf stacked ``(pattern_repeats, count,
...)``.  The per-leaf compress, the packed wire layout and so the wire
bytes follow this leaf order and these shapes.  The JAX scans over repeats
and over a group's layers are loops here.  Only ``remat="none"`` (what the
trainer uses) is offered; recomputation is ROADMAP §1.14, as are prefill
and decode.  Encoders and stub frontends raise (ROADMAP §1.13).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.params import (DTYPES, P, leaf_dtype, materialize,
                                       stack_tree)

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


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.encoder is not None or cfg.stub_frontend:
        raise NotImplementedError(
            f"{cfg.name}: encoders and stub frontends are not ported yet: "
            "ROADMAP §1.13")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _block_params(cfg: ArchConfig, spec: LayerSpec) -> Dict[str, Any]:
    d = cfg.d_model
    p: Dict[str, Any] = {"norm_mixer": L.rmsnorm_params(d)}
    if spec.kind == "attn":
        p["mixer"] = L.attention_params(d, spec.attention)
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
    _check_ported(cfg)
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
    return tree


def init_params(cfg: ArchConfig, seed: int = 0, device: DeviceLike = None):
    """Random weights from a seed (drawn in float32, cast to each leaf's
    dtype: ``cfg.dtype``, float32 for the norm scales)."""
    return materialize(abstract_params(cfg), seed, cfg.dtype,
                       resolve_device(device))


def params_from_jax(np_params, cfg: ArchConfig, device: DeviceLike = None):
    """The JAX package's parameter tree (numpy leaves) on ``device``, same
    structure, shapes and dtypes.  A 2-byte leaf (numpy ``bfloat16`` or
    its ``uint16`` bit view) is taken bit for bit as bfloat16."""
    dev = resolve_device(device)
    metas, td = T.flatten(abstract_params(cfg))
    arrays, td_np = T.flatten(np_params)
    if td_np != td:
        raise ValueError(f"parameter tree differs from {cfg.name}'s")
    out = []
    for p, a in zip(metas, arrays):
        a = np.asarray(a)
        if tuple(a.shape) != p.shape:
            raise ValueError(f"shape {a.shape} where {p.shape} is expected")
        dtype = leaf_dtype(p, cfg.dtype)
        if a.dtype.itemsize == 2:
            t = torch.from_numpy(a.view(np.int16).copy()).view(dtype)
        else:
            t = torch.from_numpy(np.array(a, np.float32)).to(dtype)
        out.append(t.to(dev))
    return td.unflatten(out)


# ---------------------------------------------------------------------------
# Forward and loss
# ---------------------------------------------------------------------------


def _block_fwd(cfg: ArchConfig, spec: LayerSpec, p, x, *, positions,
               chunk=1024):
    """Returns (x, aux): aux the MoE load-balance loss, None without an
    MoE."""
    h = L.rmsnorm(p["norm_mixer"], x, cfg.norm_eps)
    if spec.kind == "attn":
        out, _ = L.attention_fwd(p["mixer"], spec.attention, h,
                                 positions=positions, chunk=chunk)
    else:
        out, _ = L.ssm_fwd(p["mixer"], spec.ssm, h, norm_eps=cfg.norm_eps)
    x = x + out
    aux = None
    if spec.d_ff:
        h = L.rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
        x = x + L.mlp_fwd(p["ffn"], h)
    elif spec.moe:
        h = L.rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
        out, aux = L.moe_fwd(p["ffn"], spec.moe, h)
        x = x + out
    return x, aux


def forward(cfg: ArchConfig, params, tokens, *, remat: str = "none",
            chunk: int = 1024):
    """tokens: (b, s) integers.  Returns (logits (b, s, V), aux): aux the
    float32 sum of the MoE layers' load-balance losses, in layer order (0
    without an MoE layer)."""
    if remat != "none":
        raise NotImplementedError(
            f"remat={remat!r} is not ported yet: ROADMAP §1.14")
    x = params["embed"][tokens.long()].to(DTYPES[cfg.dtype])
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=_F32, device=x.device)
    groups = pattern_groups(cfg)
    for r in range(cfg.pattern_repeats):
        for (spec, count), gp in zip(groups, params["blocks"]):
            for c in range(count):
                p_one = T.tree_map(lambda a: a[r, c], gp)
                x, a = _block_fwd(cfg, spec, p_one, x, positions=positions,
                                  chunk=chunk)
                if a is not None:
                    aux = aux + a
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"]), aux
    return torch.einsum("bsd,dv->bsv", x, params["lm_head"]), aux


def loss_fn(cfg: ArchConfig, params, tokens, *, remat: str = "none",
            chunk: int = 1024):
    """Next-token cross-entropy plus ``MOE_AUX_WEIGHT`` times the MoE
    load-balance loss (0 for a model without MoE layers)."""
    logits, aux = forward(cfg, params, tokens, remat=remat, chunk=chunk)
    lg = logits[:, :-1].to(_F32)
    tgt = tokens[:, 1:].long()
    lse = torch.logsumexp(lg, dim=-1)
    picked = lg.gather(-1, tgt[..., None])[..., 0]
    return (lse - picked).mean() + MOE_AUX_WEIGHT * aux
