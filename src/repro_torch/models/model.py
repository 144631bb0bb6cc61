"""Stack builder: ArchConfig -> parameters + the training forward and loss.

Counterpart of ``repro/models/model.py`` for the dense GQA family.  The
parameter tree is the JAX package's, leaf for leaf:

    {"embed": (V, d), "blocks": (group, ...), "final_norm": {"scale"},
     "lm_head": (d, V)}

where ``blocks`` is a tuple with one dict per run of identical layer specs
(:func:`pattern_groups`), each leaf stacked ``(pattern_repeats, count,
...)``.  The per-leaf compress, the packed wire layout and so the wire
bytes follow this leaf order and these shapes.  The JAX scans over repeats
and over a group's layers are loops here.  Only ``remat="none"`` (what the
trainer uses) is offered; recomputation is ROADMAP §1.14.
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
    bad = [s.kind for s in cfg.layer_pattern
           if s.kind != "attn" or s.moe is not None or not s.d_ff
           or s.attention.is_mla]
    if bad or cfg.encoder is not None or cfg.stub_frontend:
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA decoders are ported (MoE, MLA, "
            "Mamba-2, encoders and stub frontends are ROADMAP §1.13)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _block_params(cfg: ArchConfig, spec: LayerSpec) -> Dict[str, Any]:
    d = cfg.d_model
    return {"norm_mixer": L.rmsnorm_params(d),
            "mixer": L.attention_params(d, spec.attention),
            "norm_ffn": L.rmsnorm_params(d),
            "ffn": L.mlp_params(d, spec.d_ff, spec.gated_mlp)}


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
    h = L.rmsnorm(p["norm_mixer"], x, cfg.norm_eps)
    out, _ = L.attention_fwd(p["mixer"], spec.attention, h,
                             positions=positions, chunk=chunk)
    x = x + out
    h = L.rmsnorm(p["norm_ffn"], x, cfg.norm_eps)
    return x + L.mlp_fwd(p["ffn"], h)


def forward(cfg: ArchConfig, params, tokens, *, remat: str = "none",
            chunk: int = 1024):
    """tokens: (b, s) integers.  Returns the logits (b, s, V)."""
    if remat != "none":
        raise NotImplementedError(
            f"remat={remat!r} is not ported yet: ROADMAP §1.14")
    x = params["embed"][tokens.long()].to(DTYPES[cfg.dtype])
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    groups = pattern_groups(cfg)
    for r in range(cfg.pattern_repeats):
        for (spec, count), gp in zip(groups, params["blocks"]):
            for c in range(count):
                p_one = T.tree_map(lambda a: a[r, c], gp)
                x = _block_fwd(cfg, spec, p_one, x, positions=positions,
                               chunk=chunk)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return torch.einsum("bsd,dv->bsv", x, params["lm_head"])


def loss_fn(cfg: ArchConfig, params, tokens, *, remat: str = "none",
            chunk: int = 1024):
    """Next-token cross-entropy (the dense family has no MoE aux term)."""
    logits = forward(cfg, params, tokens, remat=remat, chunk=chunk)
    lg = logits[:, :-1].to(_F32)
    tgt = tokens[:, 1:].long()
    lse = torch.logsumexp(lg, dim=-1)
    picked = lg.gather(-1, tgt[..., None])[..., 0]
    return (lse - picked).mean()
