"""Model layers of the dense GQA family: RMSNorm, RoPE, chunked
online-softmax attention, the MLP.

Counterpart of ``repro/models/layers.py`` for what a dense GQA decoder
(starcoder2) uses.  Conventions as there: activations are (batch, seq,
d_model) in the model dtype, normalisation and softmax statistics in
float32, weights in the JAX package's layout (``wq`` is (d, heads,
head_dim), ``wo`` (heads, head_dim, d)).  The matrix products are plain
PyTorch (the JAX package leaves them to XLA, not to a Pallas kernel).
MLA, MoE, Mamba-2 and the decode path are ROADMAP §1.13.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttentionSpec
from repro_torch.models.params import P

NEG_INF = -1e9          # finite mask value, as in the JAX package
_F32 = torch.float32


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_params(d: int):
    return {"scale": P((d,), ("embed",), init="ones", dtype="float32")}


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.to(_F32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].to(_F32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: (..., seq, heads..., head_dim); positions: (..., seq) int.  The
    frequencies and angles are float32, as in the JAX package."""
    hd = x.shape[-1]
    half = hd // 2
    j = torch.arange(0, half, dtype=_F32, device=x.device)
    # filled on the device: a host-to-device copy would sync the stream
    freqs = torch.pow(torch.full((), theta, dtype=_F32, device=x.device),
                      -j / half)
    ang = positions.to(_F32)[..., None] * freqs
    for _ in range(x.dim() - positions.dim() - 1):
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention: online softmax over KV chunks (training / prefill)
# ---------------------------------------------------------------------------


def _chunk_mask(qpos, kpos, *, causal: bool, window: Optional[int],
                kv_valid_len=None):
    """qpos: (sq,), kpos: (L,) -> bool (sq, L)."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > qpos[:, None] - window
    if kv_valid_len is not None:
        m &= kpos[None, :] < kv_valid_len
    return m


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      kv_valid_len=None, chunk=1024):
    """Online-softmax attention in float32.

    q: (b, sq, nkv, g, hd), the GQA groups g = heads / kv_heads explicit;
    k, v: (b, skv, nkv, hd).  Returns (b, sq, nkv, g, hd) in q's dtype.
    The JAX scan over KV chunks is a loop here (one pass when skv is not a
    multiple of ``chunk``)."""
    b, sq, nkv, g, hd = q.shape
    skv = k.shape[1]
    if skv % chunk:
        chunk = skv
    dev = q.device
    qf = q.to(_F32) * (1.0 / math.sqrt(hd))
    qpos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, nkv, g, sq), -1e30, dtype=_F32, device=dev)
    l = torch.zeros((b, nkv, g, sq), dtype=_F32, device=dev)
    acc = torch.zeros((b, nkv, g, sq, hd), dtype=_F32, device=dev)
    for j in range(skv // chunk):
        kc = k[:, j * chunk:(j + 1) * chunk].to(_F32)
        vc = v[:, j * chunk:(j + 1) * chunk].to(_F32)
        s = torch.einsum("bqkgh,bckh->bkgqc", qf, kc)
        kpos = j * chunk + torch.arange(chunk, device=dev)
        mask = _chunk_mask(qpos, kpos, causal=causal, window=window,
                           kv_valid_len=kv_valid_len)
        s = torch.where(mask[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqc,bckh->bkgqh", p,
                                                    vc)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return torch.movedim(out, 3, 1).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


def attention_params(d: int, a: AttentionSpec):
    if a.is_mla:
        raise NotImplementedError(
            "multi-head latent attention is not ported yet: ROADMAP §1.13")
    return {
        "wq": P((d, a.num_heads, a.head_dim), ("embed", "heads", "head_dim"),
                init="scaled", fan_in=d),
        "wk": P((d, a.num_kv_heads, a.head_dim),
                ("embed", "kv_heads", "head_dim"), init="scaled", fan_in=d),
        "wv": P((d, a.num_kv_heads, a.head_dim),
                ("embed", "kv_heads", "head_dim"), init="scaled", fan_in=d),
        "wo": P((a.num_heads, a.head_dim, d), ("heads", "head_dim", "embed"),
                init="scaled", fan_in=a.num_heads * a.head_dim),
    }


def attention_fwd(p, a: AttentionSpec, x, *, positions, window_override=None,
                  chunk=1024):
    """Causal self-attention forward.  x: (b, s, d).  Returns (out, (k,
    v))."""
    b, s, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = rope(q, positions, a.rope_theta)
    k = rope(k, positions, a.rope_theta)
    g = a.num_heads // a.num_kv_heads
    qg = q.reshape(b, s, a.num_kv_heads, g, a.head_dim)
    window = a.window if window_override is None else window_override
    out = chunked_attention(qg, k, v, causal=True, window=window,
                            chunk=chunk)
    out = out.reshape(b, s, a.num_heads * a.head_dim)
    wo = p["wo"].reshape(a.num_heads * a.head_dim, -1)
    return torch.einsum("bsk,kd->bsd", out, wo), (k, v)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_params(d: int, d_ff: int, gated: bool = True):
    if gated:
        return {
            "w_gate": P((d, d_ff), ("embed", "mlp"), init="scaled", fan_in=d),
            "w_up": P((d, d_ff), ("embed", "mlp"), init="scaled", fan_in=d),
            "w_down": P((d_ff, d), ("mlp", "embed"), init="scaled",
                        fan_in=d_ff),
        }
    return {
        "w_up": P((d, d_ff), ("embed", "mlp"), init="scaled", fan_in=d),
        "w_down": P((d_ff, d), ("mlp", "embed"), init="scaled", fan_in=d_ff),
    }


def mlp_fwd(p, x):
    h = torch.einsum("bsd,df->bsf", x, p["w_up"])
    if "w_gate" in p:
        gate = torch.einsum("bsd,df->bsf", x, p["w_gate"])
        h = F.silu(gate) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["w_down"])
