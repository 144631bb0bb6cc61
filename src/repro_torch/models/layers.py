"""Model layers: RMSNorm, RoPE, chunked online-softmax attention (GQA,
windowed, and MLA's training form), the MLP, the MoE and the Mamba-2 (SSD)
mixer.

Counterpart of ``repro/models/layers.py``'s training path.  Conventions as
there: activations are (batch, seq, d_model) in the model dtype,
normalisation and softmax statistics in float32, weights in the JAX
package's layout (``wq`` is (d, heads, head_dim), ``wo`` (heads, head_dim,
d)).  The matrix products are plain PyTorch (the JAX package leaves them
to XLA, not to a Pallas kernel).

The ``*_tp`` forms are the training forward on leaves split over a model
axis (``models/tensor.py``; ``group`` a ``launch.mesh.ModelGroup``), with
the parameter names of the whole layer and each leaf this rank's shard as
``models/params.shard`` cuts it: column-split projections in, row-split
out.  A layer whose leaves the axis does not split (JAX's divisibility
fallback) runs whole on every rank.

The decode functions take one new token against a cache and write the
cache IN PLACE (at ``pos``, or ``pos % S`` for a ring), where the JAX
package returns an updated copy (``dynamic_update_slice`` under
``donate_argnums``).  ``pos`` is a Python int, so that no mask or slot
needs a read from the device; they return the cache they were given.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttentionSpec, MoESpec, SSMSpec
from repro_torch.models import tensor as TP
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


def decode_attention(q, k_cache, v_cache, *, pos: int, window=None,
                     ring: bool = False):
    """One-token attention against a cache, softmax in float32.

    q: (b, nkv, g, hd); caches: (b, S, nkv, hd); pos: the index of the
    current token (already written into the cache).  ``ring``: the cache
    is a ring buffer of S = window slots written at ``t % S``."""
    S, hd = k_cache.shape[1], k_cache.shape[3]
    s = torch.einsum("bkgh,bskh->bkgs", q.to(_F32) * (1.0 / math.sqrt(hd)),
                     k_cache.to(_F32))
    slots = torch.arange(S, device=q.device)
    if ring:
        # slot s holds global position pos - ((pos - s) mod S); valid if >= 0
        valid = pos - torch.remainder(pos - slots, S) >= 0
    else:
        valid = slots <= pos
        if window is not None:
            valid &= slots > pos - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.to(_F32))
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


def attention_params(d: int, a: AttentionSpec):
    if a.is_mla:
        return mla_params(d, a)
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
                  kv=None, kv_valid_len=None, chunk=1024):
    """Training/prefill forward.  x: (b, s, d).  ``kv``: an optional (b,
    skv, d) source for cross-attention (the encoder's states), which takes
    no rotary and no causal mask.  Returns (out, (k, v)), or MLA's (out,
    (ckv,))."""
    if a.is_mla:
        return mla_fwd(p, a, x, positions=positions, chunk=chunk)
    b, s, _ = x.shape
    cross = kv is not None
    src = kv if cross else x
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"])
    if not cross:
        q = rope(q, positions, a.rope_theta)
        k = rope(k, positions, a.rope_theta)
    g = a.num_heads // a.num_kv_heads
    qg = q.reshape(b, s, a.num_kv_heads, g, a.head_dim)
    window = a.window if window_override is None else window_override
    out = chunked_attention(qg, k, v, causal=not cross, window=window,
                            kv_valid_len=kv_valid_len, chunk=chunk)
    out = out.reshape(b, s, a.num_heads * a.head_dim)
    wo = p["wo"].reshape(a.num_heads * a.head_dim, -1)
    return torch.einsum("bsk,kd->bsd", out, wo), (k, v)


def attention_decode(p, a: AttentionSpec, x, cache, *, pos: int,
                     window_override=None, ring=False):
    """x: (b, 1, d); cache: {"k", "v"} (b, S, nkv, hd), or MLA's
    {"ckv"}.  Writes the current token's k and v into the cache (at pos,
    or pos % S for a ring), then attends.  Returns (out, cache)."""
    if a.is_mla:
        return mla_decode(p, a, x, cache, pos=pos)
    b = x.shape[0]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])        # (b, 1, H, hd)
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv, a.rope_theta)[:, 0]
    k = rope(k, posv, a.rope_theta)[:, 0]
    slot = pos % cache["k"].shape[1] if ring else pos
    cache["k"][:, slot] = k
    cache["v"][:, slot] = v[:, 0]
    g = a.num_heads // a.num_kv_heads
    qg = q.reshape(b, a.num_kv_heads, g, a.head_dim)
    window = a.window if window_override is None else window_override
    out = decode_attention(qg, cache["k"], cache["v"], pos=pos,
                           window=None if ring else window, ring=ring)
    out = out.reshape(b, 1, a.num_heads * a.head_dim)
    wo = p["wo"].reshape(a.num_heads * a.head_dim, -1)
    return torch.einsum("bsk,kd->bsd", out, wo), cache


def attention_cache(a: AttentionSpec, batch: int, cache_len: int, dtype):
    if a.is_mla:
        return {"ckv": P((batch, cache_len, a.kv_lora_rank),
                         ("batch", "kv_seq", "kv_lora"), init="zeros",
                         dtype=dtype)}
    shape = (batch, cache_len, a.num_kv_heads, a.head_dim)
    axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": P(shape, axes, init="zeros", dtype=dtype),
            "v": P(shape, axes, init="zeros", dtype=dtype)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention), training form
# ---------------------------------------------------------------------------


def mla_params(d: int, a: AttentionSpec):
    r = a.kv_lora_rank
    return {
        "wq": P((d, a.num_heads, a.head_dim), ("embed", "heads", "head_dim"),
                init="scaled", fan_in=d),
        "w_dkv": P((d, r), ("embed", "kv_lora"), init="scaled", fan_in=d),
        "w_uk": P((r, a.num_heads, a.head_dim),
                  ("kv_lora", "heads", "head_dim"), init="scaled", fan_in=r),
        "w_uv": P((r, a.num_heads, a.head_dim),
                  ("kv_lora", "heads", "head_dim"), init="scaled", fan_in=r),
        "wo": P((a.num_heads, a.head_dim, d), ("heads", "head_dim", "embed"),
                init="scaled", fan_in=a.num_heads * a.head_dim),
    }


def mla_fwd(p, a: AttentionSpec, x, *, positions, chunk=1024):
    """Training: the latent expanded to full K/V, with no rotary (the JAX
    package's NoPE convention, so that training matches its absorbed
    decode form).  Returns (out, (ckv,)), ckv: (b, s, kv_lora_rank): the
    (out, cache) signature of every mixer here and in the JAX package;
    prefill keeps ckv as the cache that :func:`mla_decode` reads."""
    del positions                       # NoPE: no position enters
    b, s, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    ckv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"])
    k = torch.einsum("bsr,rhk->bshk", ckv, p["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", ckv, p["w_uv"])
    qg = q.reshape(b, s, a.num_heads, 1, a.head_dim)      # g = 1 per head
    out = chunked_attention(qg, k, v, causal=True, chunk=chunk)
    out = out.reshape(b, s, a.num_heads * a.head_dim)
    wo = p["wo"].reshape(a.num_heads * a.head_dim, -1)
    return torch.einsum("bsk,kd->bsd", out, wo), (ckv,)


def mla_decode(p, a: AttentionSpec, x, cache, *, pos: int):
    """Decode in the absorbed form: scores and context live in the latent
    space, in float32, so the cache holds only ckv (b, S, kv_lora_rank).
    NoPE, as :func:`mla_fwd` (the JAX package's convention: the released
    DeepSeek models split each head into a rotary and a NoPE part)."""
    b = x.shape[0]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])[:, 0]   # (b, H, hd)
    ckv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"])
    cache["ckv"][:, pos] = ckv[:, 0]
    c = cache["ckv"].to(_F32)
    # absorb: q_lat[h] = w_uk[., h, :]^T q[h]  -> (b, H, r)
    q_lat = torch.einsum("bhk,rhk->bhr", q.to(_F32), p["w_uk"].to(_F32))
    s = torch.einsum("bhr,bsr->bhs", q_lat * (1.0 / math.sqrt(a.head_dim)),
                     c)
    valid = torch.arange(c.shape[1], device=x.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    pr = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pr = pr / torch.clamp_min(pr.sum(dim=-1, keepdim=True), 1e-30)
    ctx_lat = torch.einsum("bhs,bsr->bhr", pr, c)
    out = torch.einsum("bhr,rhk->bhk", ctx_lat, p["w_uv"].to(_F32))
    out = out.reshape(b, 1, a.num_heads * a.head_dim).to(x.dtype)
    wo = p["wo"].reshape(a.num_heads * a.head_dim, -1)
    return torch.einsum("bsk,kd->bsd", out, wo), cache


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


# ---------------------------------------------------------------------------
# MoE: token-choice top-k with capacity, sort-free cumsum dispatch
# ---------------------------------------------------------------------------


def moe_params(d: int, m: MoESpec):
    p = {
        "router": P((d, m.num_experts), ("embed", "experts"),
                    init="scaled", fan_in=d, dtype="float32"),
        "w_gate": P((m.num_experts, d, m.d_ff), ("experts", "embed", "mlp"),
                    init="scaled", fan_in=d),
        "w_up": P((m.num_experts, d, m.d_ff), ("experts", "embed", "mlp"),
                  init="scaled", fan_in=d),
        "w_down": P((m.num_experts, m.d_ff, d), ("experts", "mlp", "embed"),
                    init="scaled", fan_in=m.d_ff),
    }
    if m.num_shared_experts:
        p["shared"] = mlp_params(d, m.num_shared_experts * m.shared_d_ff)
    return p


def moe_capacity(m: MoESpec, tokens: int) -> int:
    """Slots per expert and batch row: tokens * top_k / E * the capacity
    factor, rounded up to a multiple of 8 (at least 8)."""
    c = int(math.ceil(tokens * m.top_k / m.num_experts * m.capacity_factor))
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """One MoE layer's routing, per batch row (capacity C per row).

    probs (b, s, E) float32; gates (b, s, k) float32, renormalised;
    eidx (b, s, k) int64, each token's experts in descending probability
    (ties: lower expert first); keep (b, s*k) bool, the slot fits in its
    expert's capacity; dst (b, s*k) int64, the slot ``e * C + pos`` in the
    flat (E*C) buffer, ``E * C`` where dropped; slot_tok (b, E*C) int32,
    1 + the token in each buffer slot, 0 where empty."""

    probs: torch.Tensor
    gates: torch.Tensor
    eidx: torch.Tensor
    keep: torch.Tensor
    dst: torch.Tensor
    slot_tok: torch.Tensor


def moe_route(p, m: MoESpec, x) -> Routing:
    """The routing of ``repro/models/layers.py:moe_fwd``, integer for
    integer: routing is discrete, so a difference moves whole tokens.

    ``lax.top_k`` returns the k largest in descending order, the lower
    index first among ties; ``torch.topk`` promises neither, so the
    experts are the first k of a stable descending sort.  A slot's
    position in its expert is the int32 count of earlier slots (token
    major, then slot) routed to the same expert; a slot at position >= C
    is dropped."""
    logits = torch.einsum("bsd,de->bse", x.to(_F32), p["router"].to(_F32))
    return _route(m, logits)


def _route(m: MoESpec, logits) -> Routing:
    """:func:`moe_route` from the router's float32 logits (b, s, E)."""
    b, s, _ = logits.shape
    E, k = m.num_experts, m.top_k
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    eidx = torch.sort(probs.detach(), dim=-1, descending=True,
                      stable=True).indices[..., :k]
    gates = probs.gather(-1, eidx)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    C = moe_capacity(m, s)
    e_flat = eidx.reshape(b, s * k)
    onehot = _one_hot(e_flat, E, torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos_flat = pos.gather(2, e_flat[..., None])[..., 0].long()
    keep = pos_flat < C
    dst = torch.where(keep, e_flat * C + pos_flat, E * C)
    # 1 + the token of each slot (token major): no host-side count needed
    src = torch.arange(s * k, device=dev, dtype=torch.int32) // k + 1
    # kept slots are unique; every dropped one lands in the extra column
    slot_tok = torch.zeros((b, E * C + 1), dtype=torch.int32, device=dev)
    slot_tok.scatter_(1, dst, src.expand(b, s * k))
    return Routing(probs, gates, eidx, keep, dst, slot_tok[:, :-1])


def _one_hot(idx, n: int, dtype):
    """One-hot by comparison: ``F.one_hot`` checks its classes' range on
    some devices, which reads the indices back to the host."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


class _Dispatch(torch.autograd.Function):
    """The expert buffer ``buf[b, q] = x[b, slot_tok[b, q] - 1]`` (zero in
    an empty slot), whose backward sums each token's k slot gradients in
    buffer order (ascending ``dst``), in the gradient's dtype, rounding
    after each add: the order and roundings of JAX's transpose of the
    gather, a scatter-add over the buffer's slots, so that the sum is
    bitwise JAX's in float32 and in bfloat16.

    Autograd's backward of the gather is a ``scatter_add`` over tokens that
    appear up to k times, whose float sums on CUDA land in atomic order:
    a round would not repeat bit for bit.  The combine's gathers need no
    such care: each kept slot is read by one (token, j) alone, and the
    dropped reads (clamped to the last slot) carry exact zeros."""

    @staticmethod
    def forward(ctx, x, slot_tok, dst, k: int):
        d = x.shape[-1]
        idx = (slot_tok.long() - 1).clamp_min(0)[..., None].expand(-1, -1, d)
        buf = torch.gather(x, 1, idx)
        ctx.save_for_backward(dst)
        ctx.k = k
        return torch.where((slot_tok > 0)[..., None], buf,
                           torch.zeros((), dtype=x.dtype, device=x.device))

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        k, (b, EC, d) = ctx.k, g.shape
        # a token's slots in buffer order; dropped ones (dst = E*C) last
        at = torch.sort(dst.reshape(b, -1, k), dim=-1).values
        acc = torch.zeros((b, at.shape[1], d), dtype=g.dtype,
                          device=g.device)
        for j in range(k):
            aj = at[..., j]
            gj = torch.gather(g, 1, aj.clamp_max(EC - 1)[..., None]
                              .expand(-1, -1, d))
            acc = acc + torch.where((aj < EC)[..., None], gj, 0.0)
        return acc, None, None, None


def moe_fwd(p, m: MoESpec, x, fsdp=None):
    """x: (b, s, d) -> (y, aux), aux the load-balance loss
    ``E * sum(frac_tokens * frac_probs)`` (of the whole batch over the
    data group with ``fsdp``, :func:`_route_fractions`).

    Dispatch is per batch row (capacity C per sequence), as in the JAX
    package: each kept slot gathers its token into an (E, C) buffer, the
    gated expert FFNs run on the buffer, and each token sums its top-k
    outputs in slot order, weighted by its gates, in float32."""
    b, s, d = x.shape
    E, k = m.num_experts, m.top_k
    r = moe_route(p, m, x)
    C = moe_capacity(m, s)
    buf = _Dispatch.apply(x, r.slot_tok, r.dst, k)
    buf = buf.reshape(b, E, C, d)
    h = torch.einsum("becd,edf->becf", buf, p["w_up"])
    g = torch.einsum("becd,edf->becf", buf, p["w_gate"])
    y = torch.einsum("becf,efd->becd", F.silu(g) * h, p["w_down"])
    y_flat = y.reshape(b, E * C, d)
    out = torch.zeros((b, s, d), dtype=_F32, device=x.device)
    for j in range(k):
        at = r.dst[:, j::k].clamp_max(E * C - 1)
        gath = torch.gather(y_flat, 1, at[..., None].expand(-1, -1, d))
        gath = torch.where(r.keep[:, j::k, None], gath.to(_F32), 0.0)
        out = out + gath * r.gates[:, :, j, None]
    out = out.to(x.dtype)
    if "shared" in p:
        out = out + mlp_fwd(p["shared"], x)
    frac_tokens, frac_probs = _route_fractions(r, E, fsdp)
    aux = E * (frac_tokens * frac_probs).sum()
    return out, aux


def _route_fractions(r: Routing, E: int, fsdp=None):
    """The load-balance loss's two means over the batch: the share of the
    slots routed to each expert and each expert's mean probability.
    ``fsdp`` (``models.tensor.FSDP``): this rank holds a slice of the
    batch, and the means are the whole batch's, over the data group."""
    frac_tokens = _one_hot(r.eidx, E, _F32).mean(dim=(0, 1, 2))
    frac_probs = r.probs.mean(dim=(0, 1))
    if fsdp is not None:
        frac_tokens, frac_probs = fsdp.mean(frac_tokens), \
            fsdp.mean(frac_probs)
    return frac_tokens, frac_probs


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------


def ssm_params(d: int, s: SSMSpec):
    d_inner = s.expand * d
    h = s.num_heads(d)
    conv_ch = d_inner + 2 * s.d_state
    return {
        "in_proj": P((d, 2 * d_inner + 2 * s.d_state + h),
                     ("embed", "ssm_inner"), init="scaled", fan_in=d),
        "conv_w": P((s.d_conv, conv_ch), ("conv", "ssm_inner"),
                    init="scaled", fan_in=s.d_conv),
        "conv_b": P((conv_ch,), ("ssm_inner",), init="zeros"),
        "a_log": P((h,), ("ssm_heads",), init="ones", dtype="float32"),
        "dt_bias": P((h,), ("ssm_heads",), init="zeros", dtype="float32"),
        "d_skip": P((h,), ("ssm_heads",), init="ones", dtype="float32"),
        "norm": rmsnorm_params(d_inner)["scale"],
        "out_proj": P((d_inner, d), ("ssm_inner", "embed"),
                      init="scaled", fan_in=d_inner),
    }


def _segsum(x):
    """x: (..., T) -> (..., T, T), out[i, j] = sum of x_k for j < k <= i
    (i >= j), -inf above the diagonal (so that exp gives 0 there, and its
    gradient 0: the where passes none to the masked sums)."""
    T_ = x.shape[-1]
    xx = x[..., None].expand(*x.shape, T_)                 # [..., i, j] = x_i
    ones = torch.ones((T_, T_), dtype=torch.bool, device=x.device)
    xx = torch.where(torch.tril(ones, -1), xx, 0.0)
    seg = torch.cumsum(xx, dim=-2)
    return torch.where(torch.tril(ones), seg, -math.inf)


def ssd_chunked(xh, dt, A, B, C, chunk: int):
    """SSD (state-space duality) chunked scan.

    xh: (b, s, h, p); dt: (b, s, h) float32 (after softplus); A: (h,)
    float32 < 0; B, C: (b, s, n) (one group).  Returns (y, final_state),
    y: (b, s, h, p) float32, final_state: (b, h, p, n) float32.  One chunk
    of s when s is not a multiple of ``chunk``.

    The JAX package's three-operand einsums are pairwise contractions here,
    in the order written beside each, so that no intermediate depends on
    an einsum path search (a bad path for the first materialises a (b, c,
    h, l, m, p) tensor)."""
    b, s, h, pdim = xh.shape
    n = B.shape[-1]
    if s % chunk:
        chunk = s
    nc = s // chunk
    xc = xh.to(_F32).reshape(b, nc, chunk, h, pdim)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.to(_F32).reshape(b, nc, chunk, n)
    Cc = C.to(_F32).reshape(b, nc, chunk, n)
    dA = dtc * A                                           # (b, c, l, h)
    dA_cum = torch.cumsum(dA, dim=2)
    xdt = xc * dtc[..., None]                              # (b, c, l, h, p)

    # intra-chunk (diagonal blocks), "bclm,bchlm,bcmhp->bclhp":
    # (scores * L) over (b, c, h, l, m), then contract m with xdt
    L = torch.exp(_segsum(dA.transpose(-1, -2)))           # (b, c, h, l, m)
    scores = torch.einsum("bcln,bcmn->bclm", Cc, Bc)
    y_diag = torch.matmul(scores[:, :, None] * L, xdt.transpose(2, 3))
    y_diag = y_diag.transpose(2, 3)                        # (b, c, l, h, p)

    # states carried out of each chunk, "bcln,bclh,bclhp->bchpn":
    # decay * xdt over (b, c, l, h, p), then contract l with B
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)
    states = torch.einsum("bclhp,bcln->bchpn",
                          decay_states[..., None] * xdt, Bc)

    # inter-chunk recurrence (the JAX scan over chunks)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])           # (b, c, h)
    state = torch.zeros((b, h, pdim, n), dtype=_F32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (b, c, h, p, n)

    # "bcln,bchpn,bclh->bclhp": contract n of C with the carried states,
    # then the decay into each position
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, prev_states) \
        * torch.exp(dA_cum)[..., None]
    return (y_diag + y_off).reshape(b, s, h, pdim), state


def causal_conv(x, w, bias):
    """Depthwise causal conv.  x: (b, s, ch); w: (width, ch)."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = 0
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return out + bias


def ssm_fwd(p, spec: SSMSpec, x, *, norm_eps=1e-6):
    """Mamba-2 block forward (training).  x: (b, s, d) -> (y, {"state":
    final SSM state, "conv": the last d_conv - 1 raw conv inputs}): the
    mixers' (out, cache) signature (:func:`mla_fwd`)."""
    b, s, d = x.shape
    d_inner = spec.expand * d
    n = spec.d_state
    h = spec.num_heads(d)
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"])
    z, xin, Braw, Craw, dtraw = torch.split(
        zxbcdt, [d_inner, d_inner, n, n, h], dim=-1)
    xbc_raw = torch.cat([xin, Braw, Craw], dim=-1)         # (b, s, ch)
    xbc = F.silu(causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xin, Braw, Craw = torch.split(xbc, [d_inner, n, n], dim=-1)
    A = -torch.exp(p["a_log"].to(_F32))
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x past 20
    u = dtraw.to(_F32) + p["dt_bias"].to(_F32)
    dt = torch.logaddexp(u, torch.zeros((), dtype=_F32, device=x.device))
    xh = xin.reshape(b, s, h, spec.head_dim)
    y, final_state = ssd_chunked(xh, dt, A, Braw, Craw, spec.chunk_size)
    y = y + xh.to(_F32) * p["d_skip"].to(_F32)[:, None]
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm({"scale": p["norm"]}, y, norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return out, {"state": final_state,
                 "conv": xbc_raw[:, -(spec.d_conv - 1):, :]}


def ssm_decode(p, spec: SSMSpec, x, cache, *, norm_eps=1e-6):
    """One-token Mamba-2 step.  x: (b, 1, d); cache: {"conv": (b, d_conv
    - 1, ch) the last raw conv inputs, "state": (b, h, p, n) float32},
    both updated in place.  Returns (out, cache)."""
    b, _, d = x.shape
    d_inner = spec.expand * d
    n = spec.d_state
    h = spec.num_heads(d)
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"])[:, 0]
    z, xin, Braw, Craw, dtraw = torch.split(
        zxbcdt, [d_inner, d_inner, n, n, h], dim=-1)
    xbc = torch.cat([xin, Braw, Craw], dim=-1)             # (b, ch)
    window = torch.cat([cache["conv"], xbc[:, None]], dim=1)  # (b, w, ch)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"])
                      + p["conv_b"])
    cache["conv"].copy_(window[:, 1:])
    xin, Braw, Craw = torch.split(conv_out, [d_inner, n, n], dim=-1)
    A = -torch.exp(p["a_log"].to(_F32))
    u = dtraw.to(_F32) + p["dt_bias"].to(_F32)
    dt = torch.logaddexp(u, torch.zeros((), dtype=_F32, device=x.device))
    xh = xin.reshape(b, h, spec.head_dim).to(_F32)
    # "bh,bhp,bn->bhpn": (dt * x) outer B
    inc = (dt[..., None] * xh)[..., None] * Braw.to(_F32)[:, None, None]
    state = cache["state"] * torch.exp(dt * A)[..., None, None] + inc
    cache["state"].copy_(state)
    y = torch.einsum("bn,bhpn->bhp", Craw.to(_F32), state)
    y = y + xh * p["d_skip"].to(_F32)[:, None]
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    y = y * F.silu(z[:, None])
    y = rmsnorm({"scale": p["norm"]}, y, norm_eps)
    return torch.einsum("bse,ed->bsd", y, p["out_proj"]), cache


def ssm_cache(spec: SSMSpec, d: int, batch: int, dtype):
    d_inner = spec.expand * d
    h = spec.num_heads(d)
    ch = d_inner + 2 * spec.d_state
    return {
        "conv": P((batch, spec.d_conv - 1, ch), ("batch", "conv", "ssm_inner"),
                  init="zeros", dtype=dtype),
        "state": P((batch, h, spec.head_dim, spec.d_state),
                   ("batch", "ssm_heads", "head_dim", "ssm_state"),
                   init="zeros", dtype="float32"),
    }


# ---------------------------------------------------------------------------
# Tensor-parallel training forms (a model axis above 1)
# ---------------------------------------------------------------------------


def _moe_hint(x, *axes):
    """A sharding constraint on the expert buffer in the JAX package; the
    port's communication is explicit, so the identity."""
    return x


def gqa_tp(p, a: AttentionSpec, x, *, group, positions, kv=None,
           causal=True, rotary=True, window=None, kv_valid_len=None,
           chunk=1024):
    """GQA attention with ``wq``/``wo`` split on heads and ``wk``/``wv`` on
    kv_heads where the axis divides them: this rank's heads, then the
    row-split ``wo`` summed over the group.  Heads are contiguous per
    rank, so with kv_heads split too a rank's query heads are exactly the
    groups of its kv heads (``chunked_attention``'s ``(kv, g)`` layout);
    with kv_heads replicated (the divisibility fallback) a rank takes the
    kv heads of its query heads from the whole ``wk``/``wv`` (one kv head
    per query head where its heads cut a group).  Without a head split
    the layer runs whole, as :func:`attention_fwd`.  ``kv``: the
    cross-attention source (whole on every rank).  Returns (out, (k, v))
    with this rank's k and v."""
    H, K, hd = a.num_heads, a.num_kv_heads, a.head_dim
    Hl = p["wq"].shape[1]
    if Hl == H:
        # no head split (nor a kv one): the whole layer on every rank
        group = None
    b, s, _ = x.shape
    x1 = TP.copy(x, group)
    src = x1 if kv is None else TP.copy(kv, group)
    q = torch.einsum("bsd,dhk->bshk", x1, p["wq"])
    if p["wk"].shape[1] != K:
        wk, wv = p["wk"], p["wv"]
    else:
        wk, wv = TP.copy(p["wk"], group), TP.copy(p["wv"], group)
    k = torch.einsum("bsd,dhk->bshk", src, wk)
    v = torch.einsum("bsd,dhk->bshk", src, wv)
    if rotary:
        q = rope(q, positions, a.rope_theta)
        k = rope(k, positions, a.rope_theta)
    g = H // K
    if k.shape[2] != K or Hl == H:
        nkv, gl = k.shape[2], Hl // k.shape[2]
    else:
        h0 = (H // group.size) * group.index
        kv0, kv1 = h0 // g, (h0 + Hl - 1) // g + 1
        if h0 % g == 0 and (kv1 - kv0) * g == Hl:
            k, v, nkv, gl = k[:, :, kv0:kv1], v[:, :, kv0:kv1], kv1 - kv0, g
        elif kv1 - kv0 == 1:
            k, v, nkv, gl = k[:, :, kv0:kv1], v[:, :, kv0:kv1], 1, Hl
        else:
            idx = torch.arange(h0, h0 + Hl, device=x.device) // g
            k, v, nkv, gl = k[:, :, idx], v[:, :, idx], Hl, 1
    out = chunked_attention(q.reshape(b, s, nkv, gl, hd), k, v,
                            causal=causal, window=window,
                            kv_valid_len=kv_valid_len, chunk=chunk)
    out = out.reshape(b, s, Hl * hd)
    wo = p["wo"].reshape(Hl * hd, -1)
    return TP.reduce(torch.einsum("bsk,kd->bsd", out, wo), group), (k, v)


def attention_fwd_tp(p, a: AttentionSpec, x, *, group, positions,
                     window_override=None, kv=None, kv_valid_len=None,
                     chunk=1024):
    """:func:`attention_fwd` on leaves split over the model axis
    (:func:`gqa_tp`; MLA: :func:`mla_fwd_tp`)."""
    if a.is_mla:
        return mla_fwd_tp(p, a, x, group=group, positions=positions,
                          chunk=chunk)
    cross = kv is not None
    window = a.window if window_override is None else window_override
    return gqa_tp(p, a, x, group=group, positions=positions, kv=kv,
                  causal=not cross, rotary=not cross, window=window,
                  kv_valid_len=kv_valid_len, chunk=chunk)


def mla_fwd_tp(p, a: AttentionSpec, x, *, group, positions, chunk=1024):
    """:func:`mla_fwd` with ``wq``, ``w_uk``, ``w_uv`` split on heads and
    ``wo`` by rows; the latent ``ckv`` (``w_dkv`` replicated) is computed
    whole on every rank, which then expands only its heads' K and V."""
    del positions                       # NoPE, as mla_fwd
    Hl = p["wq"].shape[1]
    if Hl == a.num_heads:
        return mla_fwd(p, a, x, positions=None, chunk=chunk)
    b, s, _ = x.shape
    x1 = TP.copy(x, group)
    q = torch.einsum("bsd,dhk->bshk", x1, p["wq"])
    ckv = torch.einsum("bsd,dr->bsr", x1, TP.copy(p["w_dkv"], group))
    k = torch.einsum("bsr,rhk->bshk", ckv, p["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", ckv, p["w_uv"])
    out = chunked_attention(q.reshape(b, s, Hl, 1, a.head_dim), k, v,
                            causal=True, chunk=chunk)
    out = out.reshape(b, s, Hl * a.head_dim)
    wo = p["wo"].reshape(Hl * a.head_dim, -1)
    return TP.reduce(torch.einsum("bsk,kd->bsd", out, wo), group), (ckv,)


def mlp_fwd_tp(p, x, *, group, d_ff: int):
    """:func:`mlp_fwd` with ``w_gate``/``w_up`` column-split and
    ``w_down`` row-split (``d_ff`` the whole width); whole where the axis
    does not split it."""
    if p["w_up"].shape[-1] == d_ff:
        return mlp_fwd(p, x)
    x1 = TP.copy(x, group)
    h = torch.einsum("bsd,df->bsf", x1, p["w_up"])
    if "w_gate" in p:
        h = F.silu(torch.einsum("bsd,df->bsf", x1, p["w_gate"])) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return TP.reduce(torch.einsum("bsf,fd->bsd", h, p["w_down"]), group)


def moe_fwd_tp(p, m: MoESpec, x, *, group, fsdp=None):
    """:func:`moe_fwd` with the experts split over the model axis.

    The router is ("embed", "experts"): each rank's logits are its
    experts' columns, all-gathered before the softmax and top-k, so the
    routing and the dispatch plan are computed the same on every rank.
    Each rank then fills and runs only its experts' slots (the dispatch's
    backward on those slots), combines them in slot order in float32,
    and the ranks' partial combines are summed (g).  The load-balance
    loss is summed the same way, over each rank's experts (its means the
    whole batch's with ``fsdp``).  The shared experts follow
    :func:`mlp_fwd_tp`."""
    b, s, d = x.shape
    E, k = m.num_experts, m.top_k
    El = p["w_up"].shape[0]
    if El == E:
        out, aux = moe_fwd({kk: v for kk, v in p.items() if kk != "shared"},
                           m, x, fsdp)
    else:
        x1 = TP.copy(x, group)
        logits = torch.einsum("bsd,de->bse", x1.to(_F32),
                              p["router"].to(_F32))
        r = _route(m, TP.gather(logits, group, 2))
        C = moe_capacity(m, s)
        e0 = El * group.index
        lo, hi = e0 * C, (e0 + El) * C
        here = (r.dst >= lo) & (r.dst < hi)
        dst = torch.where(here, r.dst - lo, El * C)
        buf = _Dispatch.apply(x1, r.slot_tok[:, lo:hi], dst, k)
        buf = _moe_hint(buf.reshape(b, El, C, d), "data", "model", None,
                        None)
        h = torch.einsum("becd,edf->becf", buf, p["w_up"])
        gt = torch.einsum("becd,edf->becf", buf, p["w_gate"])
        y = torch.einsum("becf,efd->becd", F.silu(gt) * h, p["w_down"])
        y_flat = _moe_hint(y, "data", "model", None, None) \
            .reshape(b, El * C, d)
        part = torch.zeros((b, s, d), dtype=_F32, device=x.device)
        for j in range(k):
            at = dst[:, j::k].clamp_max(El * C - 1)
            gath = torch.gather(y_flat, 1, at[..., None].expand(-1, -1, d))
            gath = torch.where(here[:, j::k, None], gath.to(_F32), 0.0)
            part = part + gath * r.gates[:, :, j, None]
        out = TP.reduce(part, group).to(x.dtype)
        frac_tokens, frac_probs = _route_fractions(r, E, fsdp)
        aux = TP.reduce(E * (frac_tokens[e0:e0 + El]
                             * frac_probs[e0:e0 + El]).sum(), group)
    if "shared" in p:
        out = out + mlp_fwd_tp(p["shared"], x, group=group,
                               d_ff=m.num_shared_experts * m.shared_d_ff)
    return out, aux


def ssm_fwd_tp(p, spec: SSMSpec, x, *, group, norm_eps=1e-6):
    """:func:`ssm_fwd` on leaves split over the model axis.

    ``in_proj``'s "ssm_inner" columns are the concatenation [z, x, B, C,
    dt], and an even split does not fall on its boundaries (mamba2-1.3b:
    8,512 columns, 4,256 a rank at two, where z alone is 4,096).  The
    gated RMSNorm also normalises over the whole d_inner.  So this layer
    all-gathers activations rather than keeping them split: ``in_proj``'s
    and the depthwise conv's split outputs are gathered along the feature
    dim (reduce-scattered backward), the scan runs whole on every rank
    with ``a_log``, ``dt_bias`` and ``d_skip`` gathered the same way, and
    each rank feeds its heads' slice of the normed output to its rows of
    ``out_proj``, summed over the group (g)."""
    b, s, d = x.shape
    d_inner = spec.expand * d
    n = spec.d_state
    h = spec.num_heads(d)
    conv_ch = d_inner + 2 * n
    x1 = TP.copy(x, group)
    zxbcdt = TP.column(x1, p["in_proj"], group, 2 * d_inner + 2 * n + h,
                       "bsd,de->bse")
    z, xin, Braw, Craw, dtraw = torch.split(
        zxbcdt, [d_inner, d_inner, n, n, h], dim=-1)
    xbc_raw = torch.cat([xin, Braw, Craw], dim=-1)
    if p["conv_w"].shape[-1] != conv_ch:
        lo, hi = group.chunk(conv_ch)
        xbc = TP.gather(F.silu(causal_conv(xbc_raw[..., lo:hi], p["conv_w"],
                                           p["conv_b"])), group, 2)
    else:
        xbc = F.silu(causal_conv(xbc_raw, TP.copy(p["conv_w"], group),
                                 TP.copy(p["conv_b"], group)))
    xin, Braw, Craw = torch.split(xbc, [d_inner, n, n], dim=-1)
    whole = lambda name, size: TP.gather_or_copy(p[name], group, size, 0)
    A = -torch.exp(whole("a_log", h).to(_F32))
    u = dtraw.to(_F32) + whole("dt_bias", h).to(_F32)
    dt = torch.logaddexp(u, torch.zeros((), dtype=_F32, device=x.device))
    xh = xin.reshape(b, s, h, spec.head_dim)
    y, final_state = ssd_chunked(xh, dt, A, Braw, Craw, spec.chunk_size)
    y = y + xh.to(_F32) * whole("d_skip", h).to(_F32)[:, None]
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm({"scale": whole("norm", d_inner)}, y, norm_eps)
    out = TP.row(y, p["out_proj"], group, "bse,ed->bsd")
    return out, {"state": final_state,
                 "conv": xbc_raw[:, -(spec.d_conv - 1):, :]}
