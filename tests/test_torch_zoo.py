"""The port's MoE, MLA and Mamba-2 (SSD) layers and the zoo's models
against the JAX package, on the CPU, at the sizes of ``reduce_for_smoke``.

Inputs are made with numpy from a seed; weights cross from JAX as numpy
arrays (bfloat16 as its bits).  Routing is discrete, so it is compared
bitwise: the port's experts per token against what ``lax.top_k`` gave
inside JAX's own ``moe_fwd``, and the port's buffer and combine indices
against the indices JAX's ``take_along_axis`` calls received there (and
against a numpy replay of the dispatch).  Float results are compared
within the tolerances stated beside each test, with the error measured
when the test was written.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_model_params, to_torch
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core import fed as jfed
from repro.launch import train as jtrain
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.params import materialize as jmaterialize
from repro.optim import adam as jadam
from repro_torch import tree as T
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import FedConfig, fed_init, make_fl_round, wire
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.launch import train
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.params import count_params
from repro_torch.optim import AdamHyper

#: the transformer tests' float32 tolerance: rtol 1e-5, and atol 1e-5 of
#: the compared array's largest element
F32_TOL = 1e-5


def _close(a, b, tol=F32_TOL, what=""):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=tol,
                               atol=tol * float(np.abs(b).max()),
                               err_msg=what)


def _smoke_spec(name, field):
    """A layer spec of a smoke config: the first layer's ``field``."""
    cfg = reduce_for_smoke(get_config(name))
    return cfg.d_model, getattr(cfg.layer_pattern[0], field)


def _params(meta_jax, seed):
    """A JAX layer's float32 parameters and the same values as tensors."""
    jp = jmaterialize(meta_jax, jax.random.PRNGKey(seed), "float32")
    return jp, to_torch(jax.tree.map(np.asarray, jp))


def _value_and_grads(jfn, tfn, jp, tp, x, cot):
    """``sum(out * cot) + aux`` and its gradients in both packages, for the
    parameters and the input x (numpy float32)."""
    def jloss(p, xx):
        out, aux = jfn(p, xx)
        return jnp.sum(out.astype(jnp.float32) * cot) + aux
    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    leaves, td = T.flatten(tp)
    req = [t.clone().requires_grad_(True) for t in leaves]
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tfn(td.unflatten(req), xt)
    loss = (out.float() * torch.from_numpy(cot)).sum() + aux
    loss.backward()
    pairs = [(t.grad, g) for t, g in zip(req, jax.tree_util.tree_leaves(jgp))]
    return float(loss.detach()), float(jl), pairs + [(xt.grad, jgx)]


# ---------------------------------------------------------------------------
# MoE: routing bitwise, outputs and gradients within float32 tolerance
# ---------------------------------------------------------------------------


def _dispatch_replay(eidx, E, C):
    """numpy replay of the sort-free dispatch from the experts per token:
    (dst, keep, slot_tok)."""
    b, s, k = eidx.shape
    dst = np.full((b, s * k), E * C, np.int64)
    keep = np.zeros((b, s * k), bool)
    slot_tok = np.zeros((b, E * C), np.int32)
    for bi in range(b):
        fill = [0] * E
        for t in range(s):
            for j in range(k):
                e = int(eidx[bi, t, j])
                if fill[e] < C:
                    dst[bi, t * k + j] = e * C + fill[e]
                    keep[bi, t * k + j] = True
                    slot_tok[bi, e * C + fill[e]] = t + 1
                fill[e] += 1
    return dst, keep, slot_tok


def _jax_moe_routing(jp, spec, x):
    """JAX's ``moe_fwd`` on x, eagerly, with what ``lax.top_k`` returned
    and the indices each ``take_along_axis`` received: the position
    gather, the buffer gather, then one combine gather per slot j."""
    seen = {"top_k": [], "take": []}
    top_k, take = jax.lax.top_k, jnp.take_along_axis

    def rec_top_k(v, k):
        out = top_k(v, k)
        seen["top_k"].append(np.asarray(out[1]))
        return out

    def rec_take(a, idx, axis=None, **kw):
        seen["take"].append(np.asarray(idx)[..., 0])
        return take(a, idx, axis=axis, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", rec_top_k)
        mp.setattr(jnp, "take_along_axis", rec_take)
        y, aux = JL.moe_fwd(jp, spec, jnp.asarray(x))
    assert len(seen["top_k"]) == 1 and len(seen["take"]) == 2 + spec.top_k
    return y, aux, seen


def _assert_routing_is_jaxs(tp, spec, x, jp):
    """The port's routing against JAX's, integer for integer; returns it
    with JAX's forward."""
    y, aux, seen = _jax_moe_routing(jp, spec, x)
    r = TL.moe_route(tp, spec, torch.from_numpy(x))
    b, s, _ = x.shape
    E, k = spec.num_experts, spec.top_k
    C = TL.moe_capacity(spec, s)
    eidx = r.eidx.numpy()
    np.testing.assert_array_equal(eidx, seen["top_k"][0])
    dst, keep, slot_tok = _dispatch_replay(eidx, E, C)
    np.testing.assert_array_equal(r.dst.numpy(), dst)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot_tok.numpy(), slot_tok)
    np.testing.assert_array_equal(np.maximum(slot_tok - 1, 0),
                                  seen["take"][1])
    for j in range(k):
        np.testing.assert_array_equal(np.minimum(dst[:, j::k], E * C - 1),
                                      seen["take"][2 + j])
    return r, y, aux


def _moe_case(seed=0, s=16, **spec_kw):
    d, spec = _smoke_spec("deepseek-v2-lite-16b", "moe")
    spec = dataclasses.replace(spec, **spec_kw)
    jp, tp = _params(JL.moe_params(d, spec), seed)
    x = np.random.default_rng(seed).standard_normal((2, s, d)) \
        .astype(np.float32)
    return spec, jp, tp, x


def test_moe_matches_jax_in_float32():
    """Routing (experts, dst, keep, slot_tok) bitwise; y, aux and the
    gradients of ``sum(y * cot) + aux`` within the float32 tolerance
    (measured: y 2.1e-7 of its largest, aux equal, gradients 3.2e-7)."""
    spec, jp, tp, x = _moe_case()
    _, y, aux = _assert_routing_is_jaxs(tp, spec, x, jp)
    ty, taux = TL.moe_fwd(tp, spec, torch.from_numpy(x))
    _close(ty, y, what="y")
    _close(taux, aux, what="aux")
    cot = np.random.default_rng(1).standard_normal(x.shape) \
        .astype(np.float32)
    loss, jl, grads = _value_and_grads(
        lambda p, xx: JL.moe_fwd(p, spec, xx),
        lambda p, xx: TL.moe_fwd(p, spec, xx), jp, tp, x, cot)
    np.testing.assert_allclose(loss, jl, rtol=F32_TOL)
    for a, b in grads:
        _close(a, b)


def test_moe_ties_keep_the_lower_expert():
    """A zero router gives every expert the same probability: each token
    takes experts 0..k-1, in that order, in both packages."""
    spec, jp, tp, x = _moe_case()
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    r, y, _ = _assert_routing_is_jaxs(tp, spec, x, jp)
    want = np.broadcast_to(np.arange(spec.top_k), r.eidx.shape)
    np.testing.assert_array_equal(r.eidx.numpy(), want)
    _close(TL.moe_fwd(tp, spec, torch.from_numpy(x))[0], y)


def test_moe_drops_the_same_tokens():
    """A router that sends every token to expert 0 first (and, through
    the tie, to expert 1 second) at capacity factor 0.25: C = 8 of 16
    tokens, so both experts drop the same last 8 tokens in both
    packages."""
    spec, jp, tp, x = _moe_case(capacity_factor=0.25)
    x[..., 0] = 1.0
    router = np.zeros(jp["router"].shape, np.float32)
    router[0, 0] = 50.0
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    r, y, _ = _assert_routing_is_jaxs(tp, spec, x, jp)
    C = TL.moe_capacity(spec, x.shape[1])
    assert C == 8
    keep = r.keep.numpy().reshape(2, -1, spec.top_k)
    assert keep[:, :C].all() and not keep[:, C:].any()
    _close(TL.moe_fwd(tp, spec, torch.from_numpy(x))[0], y)


def test_moe_shared_expert_is_added():
    """The shared experts' MLP adds to the routed output: y with them
    minus y with them zeroed is ``mlp_fwd(shared, x)`` (float32 rounding
    of the sum, 1e-6 of the largest; measured 4.8e-8), and y matches
    JAX's with them (measured 1.4e-7)."""
    spec, jp, tp, x = _moe_case(seed=2)
    assert spec.num_shared_experts == 1 and "shared" in tp
    xt = torch.from_numpy(x)
    y = TL.moe_fwd(tp, spec, xt)[0]
    no_shared = dict(tp, shared=T.tree_map(torch.zeros_like, tp["shared"]))
    shared = TL.mlp_fwd(tp["shared"], xt)
    assert float(shared.abs().max()) > 1e-3
    _close(y - TL.moe_fwd(no_shared, spec, xt)[0], shared.detach().numpy(),
           tol=1e-6)
    _close(y, JL.moe_fwd(jp, spec, jnp.asarray(x))[0])


def test_moe_dispatch_backward_is_repeatable():
    """The dispatch's backward sums each token's slot gradients in buffer
    order, in the gradient's dtype: two runs agree bit for bit, and with
    k = 3 of 8 experts they equal JAX's transpose of its gather (a
    scatter-add over the buffer's slots) bit for bit, in float32 and in
    bfloat16, where a sum in another order or rounded once differs."""
    spec, _, tp, x = _moe_case(seed=3, s=32, top_k=3, num_experts=8)
    r = TL.moe_route(tp, spec, torch.from_numpy(x))
    assert int(r.keep.sum()) > x.shape[1] * 2 * 2
    g = np.random.default_rng(4).standard_normal(
        (2, r.slot_tok.shape[1], x.shape[2])).astype(np.float32)
    st = jnp.asarray(r.slot_tok.numpy())

    def jax_gather(xx):
        buf = jnp.take_along_axis(xx, jnp.maximum(st - 1, 0)[..., None],
                                  axis=1)
        return jnp.where((st > 0)[..., None], buf, 0)

    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        def grad():
            xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
            buf = TL._Dispatch.apply(xt, r.slot_tok, r.dst, spec.top_k)
            (buf * torch.from_numpy(g).to(tdt)).sum().backward()
            return buf.detach(), xt.grad

        (buf, a), (_, b) = grad(), grad()
        assert torch.equal(a, b)
        jbuf, vjp = jax.vjp(jax.jit(jax_gather), jnp.asarray(x).astype(jdt))
        jg = vjp(jnp.asarray(g).astype(jdt))[0]
        np.testing.assert_array_equal(buf.float().numpy(),
                                      np.asarray(jbuf).astype(np.float32))
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(jg).astype(np.float32))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def test_mla_matches_jax_in_float32():
    """MLA's training form (latent expanded to K/V, no rotary): output,
    latent and gradients within the float32 tolerance (measured 3.5e-7)."""
    d, spec = _smoke_spec("deepseek-v2-lite-16b", "attention")
    assert spec.is_mla
    jp, tp = _params(JL.attention_params(d, spec), 5)
    assert sorted(tp) == ["w_dkv", "w_uk", "w_uv", "wo", "wq"]
    x = np.random.default_rng(5).standard_normal((2, 24, d)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24)).copy()
    jout, (jckv,) = jax.jit(lambda p, xx: JL.attention_fwd(
        p, spec, xx, positions=jnp.asarray(pos)))(jp, jnp.asarray(x))
    tout, (tckv,) = TL.attention_fwd(tp, spec, torch.from_numpy(x),
                                     positions=torch.from_numpy(pos))
    _close(tout, jout)
    _close(tckv, jckv)
    cot = np.random.default_rng(6).standard_normal(x.shape) \
        .astype(np.float32)
    zero = lambda out: (out[0], 0.0)
    loss, jl, grads = _value_and_grads(
        lambda p, xx: zero(JL.attention_fwd(p, spec, xx,
                                            positions=jnp.asarray(pos))),
        lambda p, xx: zero(TL.attention_fwd(
            p, spec, xx, positions=torch.from_numpy(pos))),
        jp, tp, x, cot)
    np.testing.assert_allclose(loss, jl, rtol=F32_TOL)
    for a, b in grads:
        _close(a, b)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------


def _ssd_sequential(xh, dt, A, B, C):
    """The recurrence in float64: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,
    y_t = C_t h_t."""
    b, s, h, p = xh.shape
    state = np.zeros((b, h, p, B.shape[-1]))
    ys = []
    for t in range(s):
        decay = np.exp(dt[:, t] * A)
        upd = np.einsum("bh,bhp,bn->bhpn", dt[:, t], xh[:, t], B[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(np.einsum("bn,bhpn->bhp", C[:, t], state))
    return np.stack(ys, 1), state


def _ssd_inputs(s, seed=7):
    rng = np.random.default_rng(seed)
    b, h, p, n = 2, 3, 8, 16
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt = np.logaddexp(f(b, s, h), 0).astype(np.float32)
    A = -np.exp(0.3 * f(h)).astype(np.float32)
    return f(b, s, h, p), dt, A, f(b, s, n), f(b, s, n)


@pytest.mark.parametrize("s,chunk", [(64, 16), (48, 32)],
                         ids=["chunked", "one_chunk_fallback"])
def test_ssd_chunked_matches_jax_and_the_recurrence(s, chunk):
    """y and the final state against JAX's ``ssd_chunked`` (float32
    tolerance; measured 6.2e-7) and against the sequential recurrence in
    float64 (1e-5 of the largest: the chunked form sums in float32, in
    other orders; measured 9.4e-7).  48 is not a multiple of 32, so the
    second case runs one chunk of 48, as JAX's fallback does."""
    ins = _ssd_inputs(s)
    ty, tstate = TL.ssd_chunked(*map(torch.from_numpy, ins), chunk)
    jy, jstate = jax.jit(JL.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, ins), chunk)
    _close(ty, jy)
    _close(tstate, jstate)
    sy, sstate = _ssd_sequential(*(x.astype(np.float64) for x in ins))
    _close(ty, sy)
    _close(tstate, sstate)


def test_segsum_gradient_is_zero_above_the_diagonal():
    """exp(_segsum) is 0 above the diagonal (-inf there); its gradient
    must be finite and equal JAX's (measured 9.0e-8 of the largest), with
    no NaN from exp(-inf)."""
    x = np.random.default_rng(8).standard_normal((3, 12)).astype(np.float32)
    w = np.random.default_rng(9).standard_normal((3, 12, 12)) \
        .astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = torch.exp(TL._segsum(xt))
    assert float(out.detach().triu(1).abs().max()) == 0.0
    (out * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jnp.exp(JL._segsum(v)) * w))(
        jnp.asarray(x))
    assert bool(torch.isfinite(xt.grad).all())
    _close(xt.grad, jg)


def test_ssm_fwd_matches_jax_in_float32():
    """The Mamba-2 block: output, final state, conv tail and the gradients
    of every parameter and of x (the final state's too, through a second
    cotangent) within the float32 tolerance (measured 1.4e-6 of a leaf's
    largest).  The sequence is two chunks of the smoke chunk size."""
    d, spec = _smoke_spec("mamba2-1-3b", "ssm")
    jp, tp = _params(JL.ssm_params(d, spec), 10)
    assert sorted(tp) == ["a_log", "conv_b", "conv_w", "d_skip", "dt_bias",
                          "in_proj", "norm", "out_proj"]
    s = 2 * spec.chunk_size
    x = (0.5 * np.random.default_rng(10).standard_normal((2, s, d))) \
        .astype(np.float32)
    jout, jc = jax.jit(lambda p, xx: JL.ssm_fwd(p, spec, xx))(
        jp, jnp.asarray(x))
    tout, tc = TL.ssm_fwd(tp, spec, torch.from_numpy(x))
    _close(tout, jout)
    _close(tc["state"], jc["state"])
    _close(tc["conv"], jc["conv"])
    rng = np.random.default_rng(11)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    scot = rng.standard_normal(jc["state"].shape).astype(np.float32)

    def with_state(out_cache, w):
        out, cache = out_cache
        return out, (cache["state"] * w).sum()

    loss, jl, grads = _value_and_grads(
        lambda p, xx: with_state(JL.ssm_fwd(p, spec, xx), jnp.asarray(scot)),
        lambda p, xx: with_state(TL.ssm_fwd(p, spec, xx),
                                 torch.from_numpy(scot)),
        jp, tp, x, cot)
    np.testing.assert_allclose(loss, jl, rtol=F32_TOL)
    for a, b in grads:
        assert bool(torch.isfinite(a).all())
        _close(a, b)


# ---------------------------------------------------------------------------
# The zoo's models: trees, loss and gradients
# ---------------------------------------------------------------------------

#: The two configurations the card runs, with their cuts (depth only:
#: deepseek keeps its whole 102,400-row vocabulary), parameters and
#: leaves.
FULL_WIDTH = {
    "deepseek-v2-lite-16b": (dict(pattern_repeats=1), 1_002_051_584, 17),
    "mamba2-1-3b": (dict(pattern_repeats=8), 310_081_024, 11),
}


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_full_width_tree_matches_jax_at_the_cut(name):
    """The card's parameter tree, shapes and dtypes leaf for leaf (no
    tensor is made), and its FedAdam-SSM wire bits."""
    cut, n_params, n_leaves = FULL_WIDTH[name]
    j = dataclasses.replace(jget_config(name), **cut)
    t = dataclasses.replace(get_config(name), **cut)
    jl = jax.tree_util.tree_leaves(JM.abstract_params_sds(j))
    tl = T.leaves(TM.abstract_params(t))
    assert [p.shape for p in tl] == [x.shape for x in jl]
    assert [p.dtype or t.dtype for p in tl] == [x.dtype.name for x in jl]
    assert count_params(TM.abstract_params(t)) == n_params
    assert len(tl) == n_leaves
    sizes = [int(np.prod(p.shape)) for p in tl]
    assert wire.mask_wire_bits(sizes, 0.05, exact_topk=False) % 8 == 0


def _zoo_configs(name, dtype):
    return (dataclasses.replace(jreduce(jget_config(name)), dtype=dtype),
            dataclasses.replace(reduce_for_smoke(get_config(name)),
                                dtype=dtype))


def _loss_and_grads(name, dtype, seq=32):
    jcfg, tcfg = _zoo_configs(name, dtype)
    jp, tp = np_model_params(jcfg, tcfg)
    for a, b in zip(T.leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert a.dtype == getattr(torch, b.dtype.name)
    toks = np.random.default_rng(0).integers(0, 512, (2, seq)) \
        .astype(np.int32)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, t: JM.loss_fn(jcfg, p, t, remat="none")))(
            jp, jnp.asarray(toks))
    leaves, td = T.flatten(tp)
    req = [x.clone().requires_grad_(True) for x in leaves]
    loss = TM.loss_fn(tcfg, td.unflatten(req), torch.from_numpy(toks),
                      remat="none")
    loss.backward()
    grads = [(x.grad.float().numpy(), np.asarray(g).astype(np.float32))
             for x, g in zip(req, jax.tree_util.tree_leaves(jg))]
    return float(loss.detach()), float(jl), grads


#: Each zoo model's float32 gradient tolerance, in units of a leaf's
#: largest gradient, with the worst error measured.  Jamba's eight mixed
#: layers are ill-conditioned: a random one-ulp perturbation of its
#: weights alone moves the port's own gradients by 5.1e-5 of a leaf's
#: largest (2.6e-6 for deepseek, 3.6e-6 for mamba).
ZOO_F32 = {"deepseek-v2-lite-16b": 1e-5,        # 1.6e-6
           "mamba2-1-3b": 1e-5,                 # 1.6e-6
           "jamba-1-5-large-398b": 2e-4,        # 5.0e-5
           "kimi-k2-1t-a32b": 1e-5,             # 1.7e-6
           "starcoder2-7b": 1e-5,               # 1.4e-6
           "mistral-large-123b": 1e-5,          # 1.4e-6
           "gemma3-27b": 1e-5}                  # 4.2e-6


@pytest.mark.parametrize("name", sorted(ZOO_F32))
def test_zoo_loss_and_grads_match_jax_in_float32(name):
    """Loss (with the MoE aux term) within 1e-5 relative and every
    gradient element within ``ZOO_F32`` of its leaf's largest.  Jamba's
    smoke pattern is eight distinct blocks (SSD and attention mixers,
    dense and MoE FFNs), so it also holds ``pattern_groups``; gemma3's
    holds the local/global window groups."""
    loss, jl, grads = _loss_and_grads(name, "float32")
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    tol = ZOO_F32[name]
    for a, b in grads:
        np.testing.assert_allclose(a, b, rtol=tol,
                                   atol=tol * float(np.abs(b).max()))


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_zoo_loss_and_grads_match_jax_in_bfloat16(name):
    """bfloat16 matrices, float32 norms, router and SSD vectors: the
    bounds of the transformer's bfloat16 test (loss within 1e-3 relative,
    every gradient element within 4e-2 of its leaf's largest; measured
    deepseek 3.7e-4 and 1.7e-2, mamba 5.7e-6 and 3.3e-2)."""
    loss, jl, grads = _loss_and_grads(name, "bfloat16")
    np.testing.assert_allclose(loss, jl, rtol=1e-3)
    for a, b in grads:
        assert np.abs(a - b).max() <= 4e-2 * np.abs(b).max()


def test_kernel_adam_takes_a_tied_gradient_contiguous(monkeypatch):
    """mamba2 ties its embedding: the lookup and the head both read it, and
    autograd returns its gradient transposed (strides (1, V)).  The fused
    Adam kernel takes contiguous operands only, so ``adam_step`` hands it
    the gradient contiguous (a no-op for the other leaves)."""
    from repro_torch.core.fed import _value_and_grad
    from repro_torch.kernels.fused_adam import ops as FA
    from repro_torch.optim.adam import AdamState, adam_step
    _, tcfg = _zoo_configs("mamba2-1-3b", "bfloat16")
    p = TM.init_params(tcfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512,
                                                              (2, 32)))
    _, g = _value_and_grad(
        lambda q, b: TM.loss_fn(tcfg, q, b, remat="none"), p, toks)
    assert not g["embed"].is_contiguous()
    seen = []
    real = FA.fused_adam_apply
    monkeypatch.setattr(FA, "fused_adam_apply", lambda s, w, gg, m, v: (
        seen.append(gg.is_contiguous()), real(s, w, gg, m, v))[1])
    zeros = T.tree_map(torch.zeros_like, p)
    adam_step(p, g, AdamState(zeros, zeros, 0), AdamHyper(lr=1e-3),
              use_kernel=True)
    assert len(seen) == len(T.leaves(p)) and all(seen)


# ---------------------------------------------------------------------------
# Two FedAdam-SSM rounds against jitted JAX, and the CLI
# ---------------------------------------------------------------------------

ROUNDS, CLIENTS, SEQ = 2, 4, 32


def _jax_kernels_to_oracles(mp, dtype):
    """Route the JAX round's kernels to their jnp oracles (the same
    selection, counts and arithmetic, which its wrappers themselves take
    below one tile): the fused Adam, the per-leaf selection and apply
    (bfloat16 trees) and the packed histogram and apply (float32 trees,
    whose Pallas kernels the installed jax cannot interpret).  The Pallas
    kernels in interpret mode would add one lowering per leaf, about 20 s
    of XLA compile a model; ``test_torch_perleaf_kernels.py`` holds the
    port's per-leaf kernels bitwise against the Pallas kernels
    themselves."""
    import repro.core.sparsify as JS
    from repro.kernels.fused_adam import ops as jfa
    from repro.kernels.fused_adam.ref import fused_adam_ref
    from repro.kernels.packed_topk import ref as jpref
    from repro.kernels.ssm_apply.ref import ssm_apply_ef_ref
    from repro.kernels.topk_mask.ref import select_tau_ref
    mp.setattr(jfa, "fused_adam", lambda w, g, m, v, h, count: fused_adam_ref(
        jfa._effective_scalars(h, count), w, g, m, v))
    if dtype == "bfloat16":
        mp.setattr(JS, "select_tau_kernel",
                   lambda x, k: (select_tau_ref(x, k), None))
        mp.setattr(JS, "ssm_apply_ef", ssm_apply_ef_ref)
        return

    def apply_ef(taus2, seg_ids, ks, ns, dw, dm, dv, score=None, *,
                 with_residual=True, value_dtype=None):
        return jpref.packed_apply_ef_ref(
            taus2, seg_ids, ks, ns, (dw, dm, dv), score,
            with_residual=with_residual, value_dtype=value_dtype)

    mp.setattr(JS, "packed_hist_kernel", jpref.packed_hist_ref)
    mp.setattr(JS, "packed_apply_ef", apply_ef)


@pytest.fixture(scope="module",
                params=[("deepseek-v2-lite-16b", "float32"),
                        ("deepseek-v2-lite-16b", "bfloat16"),
                        ("mamba2-1-3b", "float32"),
                        ("mamba2-1-3b", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def zoo_rounds(request):
    """Two rounds of FedAdam-SSM (threshold masks, error feedback, the
    fused Adam, the kernel backend) of a smoke model, the port on the CPU
    (the kernels' plain versions) against JAX's jitted round, from the
    same weights and batches.  A float32 tree takes the packed compress;
    a bfloat16 one, with its float32 norms (and router or SSD vectors),
    the per-leaf kernels that the card runs."""
    name, dtype = request.param
    jcfg, tcfg = _zoo_configs(name, dtype)
    fed_kw = dict(algorithm="fedadam_ssm", alpha=0.05, n_clients=CLIENTS,
                  local_epochs=3, exact_topk=False, error_feedback=True,
                  use_kernel_adam=True, sparsify_backend="kernel")
    jf = jfed.FedConfig(**fed_kw, adam=jadam.AdamHyper(lr=1e-3))
    tf = FedConfig(**fed_kw, adam=AdamHyper(lr=1e-3))
    jp, tp = np_model_params(jcfg, tcfg)
    jround = jax.jit(jfed.make_fl_round(
        jf, lambda p, b: JM.loss_fn(jcfg, p, b["tokens"], remat="none")))
    tround = make_fl_round(
        tf, lambda p, b: TM.loss_fn(tcfg, p, b["tokens"], remat="none"))
    js, ts = jfed.fed_init(jf, jp), fed_init(tf, tp)
    reset_launches()
    out = []
    with pytest.MonkeyPatch.context() as mp:
        _jax_kernels_to_oracles(mp, dtype)
        for r in range(ROUNDS):
            jb = jtrain.build_client_batches(jcfg, CLIENTS, 2, SEQ, seed=r)
            tb = train.build_client_batches(tcfg, CLIENTS, 2, SEQ, seed=r,
                                            device="cpu")
            assert np.array_equal(tb["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))
            js, jm = jround(js, jb)
            ts, tm = tround(ts, tb)
            out.append((js, jm, ts, tm))
    return name, dtype, out, dict(LAUNCHES)


def test_zoo_round_uplink_bits_are_exact(zoo_rounds):
    name, _, rounds, launches = zoo_rounds
    assert all(v == 0 for v in launches.values())
    for js, jm, ts, tm in rounds:
        assert float(tm["uplink_bits"]) == float(jm["uplink_bits"])
    sizes = tuple(x.numel() for x in T.leaves(ts.W))
    assert len(sizes) == FULL_WIDTH[name][2]
    assert float(tm["uplink_bits"]) == float(np.float32(
        CLIENTS * wire.mask_wire_bits(sizes, 0.05, exact_topk=False)))


def _shares(rounds):
    """Per round: the loss's largest relative difference, and over the
    whole model the share of EF-support elements that differ for some
    client and the share of W, M, V elements beyond rtol 2^-7 plus 1e-3
    (W) or 4e-2 (M, V) of their leaf's largest (the transformer round
    test's per-element tolerances)."""
    out = []
    for js, jm, ts, tm in rounds:
        tl, jl = tm["loss"].numpy(), np.asarray(jm["loss"])
        row = {"loss": float(np.max(np.abs(tl - jl) / np.abs(jl)))}
        err = zip(T.leaves(ts.client_state["comp"]["err"]),
                  jax.tree_util.tree_leaves(js.client_state["comp"]["err"]))
        flips = [((a.float().numpy() == 0) != (np.asarray(b) == 0))
                 for a, b in err]
        row["support"] = sum(f.sum() for f in flips) / sum(f.size
                                                           for f in flips)
        for name, atol in (("W", 1e-3), ("M", 4e-2), ("V", 4e-2)):
            bad = n = 0
            for a, b in zip(T.leaves(getattr(ts, name)),
                            jax.tree_util.tree_leaves(getattr(js, name))):
                assert a.dtype == getattr(torch, b.dtype.name)
                a = a.float().numpy()
                b = np.asarray(b).astype(np.float32)
                bad += np.sum(~np.isclose(a, b, rtol=2.0 ** -7,
                                          atol=atol * float(np.abs(b).max())))
                n += a.size
            row[name] = bad / n
        out.append(row)
    return out


#: Bounds of the rounds against JAX, with the largest value measured over
#: the two rounds of each model.  float32: the algorithm is the same and
#: only summation orders differ, so supports agree but for elements within
#: an ulp of a tau.  Measured: deepseek loss 5.4e-6, supports 7.3e-6 of
#: the model, W and M 1.3e-5, V 0; mamba loss 1.6e-7, supports 1.8e-6,
#: W, M and V 0.  bfloat16: each gradient differs by bfloat16 roundings
#: (the bfloat16 loss test: a median per-element difference of 1.3-1.7%
#: in deepseek's leaves, 1.1-3.5% in mamba's, the most in the SSD's head
#: vectors, whose float32 gradients are sums over bfloat16 activations),
#: and the first local Adam steps move every element by about lr * 3.16
#: in the sign of its gradient whatever its size, so small gradients that
#: round to the other sign move their element the other way; in deepseek
#: the MoE also routes the tokens near a tie between two experts to other
#: experts once the weights differ.  A client's loss moves by some 1e-3
#: relative, and a few percent of the model's elements fall on the other
#: side of a tau; both models' float32 rounds show that no more than
#: rounding is at play.  Measured: deepseek loss 5.1e-3, supports 4.0%,
#: W 2.1%, M 2.4%, V 0.17%; mamba loss 3.3e-3, supports 9.5%, W 6.3%,
#: M 8.0%, V 0.44%.
ROUND_BOUNDS = {
    "float32": {"loss": 5e-5, "support": 1e-4, "W": 1e-4, "M": 1e-4,
                "V": 1e-4},
    "bfloat16": {"loss": 1e-2, "support": 0.15, "W": 0.1, "M": 0.12,
                 "V": 0.02},
}


def test_zoo_round_matches_jitted_jax(zoo_rounds):
    """Loss, EF supports and W, M, V after each round within
    ``ROUND_BOUNDS``."""
    _, dtype, rounds, _ = zoo_rounds
    bounds = ROUND_BOUNDS[dtype]
    for r, row in enumerate(_shares(rounds)):
        for key, value in row.items():
            assert value <= bounds[key], (r, key, value)


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_cli_runs_the_zoo_on_cpu(name, capsys):
    state, _ = train.main(["--arch", name, "--smoke", "--rounds", "1",
                           "--device", "cpu", "--kernel-adam",
                           "--threshold-topk", "--clients", "2",
                           "--local-epochs", "1", "--seq", "32"])
    out = capsys.readouterr().out
    assert f"[train] {name}-smoke:" in out and "device: cpu" in out
    line = [x for x in out.splitlines() if x.startswith("[round   0]")][0]
    assert np.isfinite(float(line.split("loss=")[1].split()[0]))
    assert len(T.leaves(state.W)) == FULL_WIDTH[name][2]
