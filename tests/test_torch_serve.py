"""The port's serving path (decode layers, caches, prefill, the decode
step, ``launch/serve.py``) and its encoder and stub-frontend models
against the JAX package, on the CPU, at the sizes of ``reduce_for_smoke``
in float32.

Inputs are made with numpy from a seed and handed to both packages;
weights cross with ``params_from_jax`` and caches with
``caches_from_jax``.  MoE models run with the capacity factor raised to
8, where no token drops (the reference's ``_no_drop``): capacity routing
over s tokens and over one differ otherwise.  Tolerances are stated beside
each test with the error measured when it was written.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_model_params, to_torch
from repro.configs import available_archs as javailable
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core import fed as jfed
from repro.core.compressors import make_compressor as jmake_compressor
from repro.launch import train as jtrain
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.params import is_meta
from repro.models.params import materialize as jmaterialize
from repro.optim import adam as jadam
from repro_torch import tree as T
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import FedConfig
from repro_torch.launch import serve, train
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.params import P, count_params, materialize
from repro_torch.optim import AdamHyper


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def _close(a, b, tol, what=""):
    """Every element within ``tol`` relative, and ``tol`` of b's largest
    element absolute."""
    a, b = _np(a), _np(b)
    np.testing.assert_allclose(a, b, rtol=tol,
                               atol=tol * float(np.abs(b).max()),
                               err_msg=what)


def _no_drop(cfg):
    """The capacity factor raised to 8 (no MoE token drops)."""
    return dataclasses.replace(cfg, layer_pattern=tuple(
        dataclasses.replace(sp, moe=dataclasses.replace(
            sp.moe, capacity_factor=8.0)) if sp.moe else sp
        for sp in cfg.layer_pattern))


def _configs(name, dtype="float32"):
    """Both packages' smoke config of ``name`` in ``dtype``, no drops."""
    return tuple(_no_drop(dataclasses.replace(r(g(name)), dtype=dtype))
                 for g, r in ((jget_config, jreduce),
                              (get_config, reduce_for_smoke)))


def _layer_params(meta_jax, seed):
    jp = jmaterialize(meta_jax, jax.random.PRNGKey(seed), "float32")
    return jp, to_torch(jax.tree.map(np.asarray, jp))


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# The decode layers, float32: within 1e-5 of JAX (measured at most 9.2e-7
# of the largest element)
# ---------------------------------------------------------------------------

LAYER_TOL = 1e-5

#: decode_attention's masks: (cache slots S, window, ring, pos)
MASKS = {"full": (12, None, False, 7), "window": (12, 4, False, 9),
         "ring": (5, None, True, 2), "ring_wrapped": (5, None, True, 13)}


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_decode_attention_matches_jax(mask):
    S, window, ring, pos = MASKS[mask]
    rng = np.random.default_rng(0)
    q = _rand(rng, (2, 2, 3, 16))
    k, v = _rand(rng, (2, S, 2, 16)), _rand(rng, (2, S, 2, 16))
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), pos=jnp.int32(pos),
                               window=window, ring=ring)
    got = TL.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), pos=pos, window=window,
                              ring=ring)
    _close(got, want, LAYER_TOL)


def _gqa_spec(window=None):
    _, a = _smoke_attention("starcoder2-3b")
    return dataclasses.replace(a, window=window)


def _smoke_attention(name):
    cfg = reduce_for_smoke(get_config(name))
    return cfg.d_model, cfg.layer_pattern[0].attention


#: attention_decode's cases: (window, cache slots, ring, positions run)
ATTN_CASES = {"full": (None, 10, False, range(10)),
              "window": (4, 10, False, range(10)),
              "ring": (4, 4, True, range(10))}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_decode_matches_jax(case):
    """Ten steps of one GQA layer from a zero cache, the port's cache
    written in place, the JAX cache returned: every output and the
    caches after each step (the ring wraps twice)."""
    window, S, ring, steps = ATTN_CASES[case]
    d, a = 128, _gqa_spec(window)
    jp, tp = _layer_params(JL.attention_params(d, a), 1)
    rng = np.random.default_rng(2)
    shape = (2, S, a.num_kv_heads, a.head_dim)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for pos in steps:
        x = _rand(rng, (2, 1, d))
        jy, jc = JL.attention_decode(jp, a, jnp.asarray(x), jc,
                                     pos=jnp.int32(pos), ring=ring)
        ty, tc2 = TL.attention_decode(tp, a, torch.from_numpy(x), tc,
                                      pos=pos, ring=ring)
        assert tc2 is tc
        _close(ty, jy, LAYER_TOL, f"out at {pos}")
        for key in ("k", "v"):
            _close(tc[key], jc[key], LAYER_TOL, f"{key} at {pos}")


def test_ring_cache_equals_full_cache():
    """A windowed layer on a ring of ``window`` slots and on a full cache
    with the window mask: the same outputs at every step (the softmax
    sums the same terms in another slot order; measured 4.4e-7)."""
    window, steps = 4, 13
    d, a = 128, _gqa_spec(window)
    _, tp = _layer_params(JL.attention_params(d, a), 3)
    rng = np.random.default_rng(4)
    shape = (2, steps, a.num_kv_heads, a.head_dim)
    full = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    ring = {k: torch.zeros((2, window) + shape[2:]) for k in ("k", "v")}
    for pos in range(steps):
        x = torch.from_numpy(_rand(rng, (2, 1, d)))
        yf, _ = TL.attention_decode(tp, a, x, full, pos=pos)
        yr, _ = TL.attention_decode(tp, a, x, ring, pos=pos, ring=True)
        _close(yr, yf, 1e-6, f"step {pos}")
        # the ring holds the window's last tokens, each at t % window
        for t in range(max(0, pos - window + 1), pos + 1):
            assert torch.equal(ring["k"][:, t % window], full["k"][:, t])


def test_mla_decode_matches_jax():
    """The absorbed MLA form (latent scores and context in float32, the
    cache holding ckv alone), eight steps."""
    cfg = _configs("deepseek-v2-lite-16b")[1]
    d, a = cfg.d_model, cfg.layer_pattern[0].attention
    jp, tp = _layer_params(JL.mla_params(d, a), 5)
    rng = np.random.default_rng(6)
    S = 8
    jc = {"ckv": jnp.zeros((2, S, a.kv_lora_rank))}
    tc = {"ckv": torch.zeros((2, S, a.kv_lora_rank))}
    for pos in range(S):
        x = _rand(rng, (2, 1, d))
        jy, jc = JL.mla_decode(jp, a, jnp.asarray(x), jc, pos=jnp.int32(pos))
        ty, _ = TL.mla_decode(tp, a, torch.from_numpy(x), tc, pos=pos)
        _close(ty, jy, LAYER_TOL, f"out at {pos}")
        _close(tc["ckv"], jc["ckv"], LAYER_TOL, f"ckv at {pos}")


def test_ssm_decode_matches_jax():
    """Six Mamba-2 steps from a random float32 state and conv window:
    outputs, the conv window and the state."""
    cfg = _configs("mamba2-1-3b")[1]
    d, s = cfg.d_model, cfg.layer_pattern[0].ssm
    jp, tp = _layer_params(JL.ssm_params(d, s), 7)
    meta = TL.ssm_cache(s, d, 2, "float32")
    rng = np.random.default_rng(8)
    c = {k: _rand(rng, meta[k].shape, 0.5) for k in ("conv", "state")}
    jc = {k: jnp.asarray(v) for k, v in c.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in c.items()}
    for step in range(6):
        x = _rand(rng, (2, 1, d))
        jy, jc = JL.ssm_decode(jp, s, jnp.asarray(x), jc)
        ty, _ = TL.ssm_decode(tp, s, torch.from_numpy(x), tc)
        _close(ty, jy, LAYER_TOL, f"out at {step}")
        for k in ("conv", "state"):
            _close(tc[k], jc[k], LAYER_TOL, f"{k} at {step}")


def test_cross_attention_matches_jax():
    """attention_fwd with ``kv``: keys and values from the encoder's
    states, no rotary, no causal mask (and a kv_valid_len)."""
    d, a = _smoke_attention("whisper-base")
    jp, tp = _layer_params(JL.attention_params(d, a), 9)
    rng = np.random.default_rng(10)
    x, enc = _rand(rng, (2, 6, d)), _rand(rng, (2, 20, d))
    pos = np.tile(np.arange(6), (2, 1))
    for valid in (None, 13):
        jy, (jk, jv) = JL.attention_fwd(
            jp, a, jnp.asarray(x), positions=jnp.asarray(pos),
            kv=jnp.asarray(enc), kv_valid_len=valid)
        ty, (tk, tv) = TL.attention_fwd(
            tp, a, torch.from_numpy(x), positions=torch.from_numpy(pos),
            kv=torch.from_numpy(enc), kv_valid_len=valid)
        _close(ty, jy, LAYER_TOL, f"valid {valid}")
        _close(tk, jk, LAYER_TOL)
        _close(tv, jv, LAYER_TOL)


def test_encoder_fwd_matches_jax():
    """Whisper's encoder (non-causal self-attention with rotary, the GELU
    MLP, the final norm) over the smoke config's 64 frames."""
    jcfg, tcfg = _configs("whisper-base")
    jp, tp = np_model_params(jcfg, tcfg, seed=11)
    frames = _rand(np.random.default_rng(12), (2, 64, jcfg.d_model), 0.02)
    want = JM._encoder_fwd(jcfg, jp["encoder"], jnp.asarray(frames))
    got = TM._encoder_fwd(tcfg, tp["encoder"], torch.from_numpy(frames))
    _close(got, want, LAYER_TOL)


# ---------------------------------------------------------------------------
# Trees: the encoder's leaves and the caches, without allocating
# ---------------------------------------------------------------------------


def _meta_rows(leaves):
    return [(tuple(p.shape), tuple(p.axes), p.init, p.dtype) for p in leaves]


def test_cache_meta_is_the_jax_packages():
    """cache_meta's tree, shapes, axes and dtypes, leaf for leaf, for
    every zoo config, full and reduced, short and long (a ring at the
    long context window), and decode_layout's groups."""
    for name in javailable():
        for full in (True, False):
            j, t = jget_config(name), get_config(name)
            if not full:
                j, t = jreduce(j), reduce_for_smoke(t)
            for seq, long_mode in ((96, False), (8192, True)):
                jm = JM.cache_meta(j, 2, seq, long_mode)
                tm = TM.cache_meta(t, 2, seq, long_mode)
                assert len(jm) == len(tm)
                for jg, tg in zip(jm, tm):
                    assert sorted(jg) == sorted(tg), name
                    assert _meta_rows(T.leaves(tg)) == _meta_rows(
                        jax.tree_util.tree_leaves(jg, is_leaf=is_meta))
                assert TM.decode_layout(t, seq, long_mode) \
                    == JM.decode_layout(j, seq, long_mode)


@pytest.mark.parametrize("name", ["whisper-base", "llava-next-mistral-7b"])
def test_full_tree_matches_jax(name):
    """The encoder's and the cross-attention's leaves at full width: the
    JAX tree's shapes and dtypes leaf for leaf, and its size."""
    j, t = jget_config(name), get_config(name)
    jl = jax.tree_util.tree_leaves(JM.abstract_params_sds(j))
    tl = T.leaves(TM.abstract_params(t))
    assert [p.shape for p in tl] == [x.shape for x in jl]
    assert [p.dtype or t.dtype for p in tl] == [x.dtype.name for x in jl]
    assert count_params(TM.abstract_params(t)) == sum(x.size for x in jl)


def test_materialize_scales_in_place_bitwise():
    """Each leaf is drawn in float32 and scaled in place: the bits of the
    old ``(x * std).to(dtype)``, in leaf order from one generator, for
    every init kind and both leaf dtypes."""
    tree = {"a": P((3, 40), ("x", "y")),
            "b": P((5, 7), ("x", "y"), init="scaled", fan_in=11),
            "c": P((6, 9), ("x", "y"), init="scaled"),
            "d": P((13,), ("x",), init="scaled", dtype="float32"),
            "e": P((4,), ("x",), init="zeros"),
            "f": P((4,), ("x",), init="ones", dtype="float32"),
            "g": P((2, 3, 8), ("x", "y", "z"), dtype="float32")}
    got = materialize(tree, 3, "bfloat16")
    gen = torch.Generator().manual_seed(3)
    for key in sorted(tree):
        p = tree[key]
        dtype = getattr(torch, p.dtype or "bfloat16")
        if p.init in ("zeros", "ones"):
            want = torch.full(p.shape, float(p.init == "ones"), dtype=dtype)
        else:
            fan = p.fan_in or (p.shape[-2] if len(p.shape) >= 2
                               else p.shape[-1])
            std = 1.0 / np.sqrt(fan) if p.init == "scaled" else 0.02
            x = torch.randn(p.shape, generator=gen, dtype=torch.float32)
            want = (x * float(std)).to(dtype)
        assert got[key].dtype == dtype
        assert torch.equal(got[key].view(torch.int16) if dtype ==
                           torch.bfloat16 else got[key],
                           want.view(torch.int16) if dtype ==
                           torch.bfloat16 else want), key


# ---------------------------------------------------------------------------
# Whole models: prefill and a teacher-forced decode against jitted JAX
# ---------------------------------------------------------------------------

#: The families and what each holds: GQA; local windows and global
#: layers; MLA + MoE (no drop); SSD; the hybrid's eight mixed blocks;
#: encoder-decoder with cross caches; the VLM's stub prefix.
FAMILIES = ("starcoder2-3b", "gemma3-27b", "deepseek-v2-lite-16b",
            "mamba2-1-3b", "jamba-1-5-large-398b", "whisper-base",
            "llava-next-mistral-7b")
B, PROMPT, GEN = 2, 12, 4

#: float32 tolerance of the models' logits and caches against JAX, of
#: their largest element (measured at most 6.4e-6, jamba's, over the
#: prefill, its caches and the sixteen decode steps).
MODEL_TOL = 2e-5


def _pad_into(zeros, pre):
    """Prefill caches (over the prompt) in decode caches of the full
    length: a leaf of the same shape whole, else along its kv_seq axis
    (axis 3 of (repeat, count, b, S, ...))."""
    out = []
    for z, p in zip(zeros, pre):
        z = np.array(z)
        if z.shape == p.shape:
            z[...] = p
        else:
            z[:, :, :, :p.shape[3]] = p
        out.append(z)
    return out


@pytest.fixture(scope="module", params=FAMILIES)
def served(request):
    """One smoke model of each family in float32 in both packages, from
    one numpy seed: the prefill over a 12-token prompt (after a VLM's
    16-token prefix), and a teacher-forced decode of the prompt and 4
    more tokens from zero caches (whisper's cross caches from prefill; a
    VLM's whole caches from prefill, decoding the 4 after it)."""
    name = request.param
    jcfg, tcfg = _configs(name)
    jp, tp = np_model_params(jcfg, tcfg, seed=0)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, PROMPT + GEN)) \
        .astype(np.int32)
    embeds, n_front = None, 0
    if jcfg.stub_frontend:
        n = jcfg.encoder.src_len if jcfg.encoder is not None else \
            min(jcfg.stub_frontend_tokens, 16)
        embeds = _rand(rng, (B, n, jcfg.d_model), 0.02)
        n_front = 0 if jcfg.encoder is not None else n
    jkw = {} if embeds is None else {"frontend_embeds": jnp.asarray(embeds)}
    tkw = {} if embeds is None else {
        "frontend_embeds": torch.from_numpy(embeds)}
    seq = n_front + PROMPT + GEN
    jl, jc = jax.jit(lambda p, t: JM.prefill(jcfg, p, t, **jkw))(
        jp, jnp.asarray(toks[:, :PROMPT]))
    tl, tc = TM.prefill(tcfg, tp, torch.from_numpy(toks[:, :PROMPT]), **tkw)

    # decode from zero caches, or seeded from JAX's prefill
    zeros, td = jax.tree_util.tree_flatten(
        jmaterialize(JM.cache_meta(jcfg, B, seq), jax.random.PRNGKey(0)))
    pre = [np.asarray(x) for x in jax.tree_util.tree_leaves(jc)]
    start = 0
    if n_front:
        leaves = _pad_into(zeros, pre)
        start = PROMPT
    else:
        leaves = [np.array(z) for z in zeros]
        if jcfg.encoder is not None:
            paths = [jax.tree_util.keystr(k) for k, _ in
                     jax.tree_util.tree_flatten_with_path(jc)[0]]
            for i, path in enumerate(paths):
                if "cross_" in path:
                    leaves[i] = pre[i]
    jcache = td.unflatten([jnp.asarray(x) for x in leaves])
    tcache = TM.caches_from_jax(td.unflatten(leaves), tcfg, B, seq,
                                device="cpu")
    jstep = jax.jit(functools.partial(JM.decode_step, jcfg, seq_len=seq))
    steps = []
    for i in range(start, PROMPT + GEN):
        pos = n_front + i if n_front else i
        jlog, jcache = jstep(jp, jcache, jnp.int32(pos),
                             jnp.asarray(toks[:, i]))
        tlog, _ = TM.decode_step(tcfg, tp, tcache, pos,
                                 torch.from_numpy(toks[:, i]), seq_len=seq)
        steps.append((np.asarray(jlog), tlog.clone()))
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, tp=tp, toks=toks,
                tkw=tkw, prefill=(jl, jc, tl, tc), steps=steps,
                caches=(jcache, tcache), seq=seq, n_front=n_front)


def test_prefill_matches_jax(served):
    """The last position's logits and every cache leaf (k and v, ckv,
    the SSD state and conv tail, the cross keys and values)."""
    jl, jc, tl, tc = served["prefill"]
    _close(tl, jl, MODEL_TOL, "logits")
    jleaves = jax.tree_util.tree_leaves(jc)
    tleaves = T.leaves(tc)
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        assert tuple(a.shape) == b.shape
        _close(a, b, MODEL_TOL, served["name"])


def test_decode_sequence_matches_jax(served):
    """Each step's logits, the greedy token of each (identical) and the
    caches after the last step."""
    for i, (jlog, tlog) in enumerate(served["steps"]):
        _close(tlog, jlog, MODEL_TOL, f"step {i}")
        assert np.array_equal(tlog.argmax(-1).numpy(), jlog.argmax(-1))
    jc, tc = served["caches"]
    for a, b in zip(T.leaves(tc), jax.tree_util.tree_leaves(jc)):
        _close(a, b, MODEL_TOL, "caches")


def _padded(cfg, seq, pre):
    """Zero decode caches of length seq holding the port's prefill caches
    ``pre`` (:func:`_pad_into`'s rule)."""
    caches = serve.new_caches(cfg, B, seq, "cpu")
    for z, p in zip(T.leaves(caches), T.leaves(pre)):
        (z if z.shape == p.shape else z[:, :, :, :p.shape[3]]).copy_(p)
    return caches


#: Tokens the port's own replay sends through prefill: the SSD's conv
#: tail holds the last d_conv - 1 = 3 inputs, and a shorter prefill (in
#: both packages) returns a shorter tail than its cache's.
FIRST = 4


def _replay(served, n):
    """The port alone: the first FIRST tokens through prefill (after a
    VLM's prefix; whisper's cross caches come with it), then the tokens
    up to n through decode_step.  Returns the logits of tokens FIRST - 1
    to n - 1 (b, n - FIRST + 1, V) and the caches."""
    cfg, tp, toks, nf = (served[k] for k in ("tcfg", "tp", "toks",
                                             "n_front"))
    lg, pre = TM.prefill(cfg, tp, torch.from_numpy(toks[:, :FIRST]),
                         **served["tkw"])
    caches, logits = _padded(cfg, served["seq"], pre), [lg]
    for i in range(FIRST, n):
        lg, _ = TM.decode_step(cfg, tp, caches, nf + i,
                               torch.from_numpy(toks[:, i]),
                               seq_len=served["seq"])
        logits.append(lg)
    return torch.stack(logits, 1), caches


#: Decode against the port's own forward, in float32: within this share
#: of the largest logit (the reference's test allows 0.05; measured at
#: most 7.5e-6, jamba's).
SELF_TOL = 2e-5


def test_decode_matches_forward(served):
    """Replaying the tokens through decode_step gives the parallel
    forward's logits at every token's position (after a VLM's
    prefix)."""
    dec, _ = _replay(served, PROMPT + GEN)
    fwd, _ = TM.forward(served["tcfg"], served["tp"],
                        torch.from_numpy(served["toks"]), **served["tkw"])
    _close(dec, fwd[:, served["n_front"] + FIRST - 1:], SELF_TOL)


def test_prefill_seeds_decode(served):
    """decode(prefill(prompt)) continues as decoding the prompt token by
    token: the prompt's last logits, then one more step from each cache
    state with the same token (the reference's test, within SELF_TOL
    where it allows 0.05)."""
    cfg, tp, seq = served["tcfg"], served["tp"], served["seq"]
    pos = served["n_front"] + PROMPT
    dec, caches_a = _replay(served, PROMPT)
    _, _, tl, tc = served["prefill"]
    _close(tl, dec[:, -1], SELF_TOL)
    caches_b = _padded(cfg, seq, tc)
    nxt = dec[:, -1].argmax(-1)
    la, _ = TM.decode_step(cfg, tp, caches_a, pos, nxt, seq_len=seq)
    lb, _ = TM.decode_step(cfg, tp, caches_b, pos, nxt, seq_len=seq)
    _close(lb, la, SELF_TOL)


def test_ring_decode_matches_windowed_forward():
    """gemma3's local layers decode on rings of 64 slots over 80 tokens
    (the ring wraps), its global layers on full caches: the logits of
    every position equal the forward's, whose chunked attention masks
    the same windows (measured 1.3e-6 of the largest logit)."""
    _, cfg = _configs("gemma3-27b")
    s = 80
    layout = TM.decode_layout(cfg, s, False)
    assert any(ring for _, ring, _, _ in layout)
    assert any(not ring for _, ring, _, _ in layout)
    tp = TM.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, s)))
    caches = serve.new_caches(cfg, 1, s, "cpu")
    dec = torch.stack([TM.decode_step(cfg, tp, caches, i, toks[:, i],
                                      seq_len=s)[0] for i in range(s)], 1)
    fwd, _ = TM.forward(cfg, tp, toks)
    _close(dec, fwd, SELF_TOL)


def test_long_mode_decode_matches_jax():
    """decode_step's long_mode: every full-attention layer rings at the
    long context window (here 8 slots over 14 tokens), against jitted
    JAX's (measured 8.4e-7 of the largest logit)."""
    jcfg, tcfg = (dataclasses.replace(c, long_context_window=8)
                  for c in _configs("starcoder2-3b"))
    jp, tp = np_model_params(jcfg, tcfg, seed=4)
    s = 14
    assert TM.decode_layout(tcfg, s, True)[0][:2] == ("attn", True)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, s)) \
        .astype(np.int32)
    jc = jmaterialize(JM.cache_meta(jcfg, B, s, True), jax.random.PRNGKey(0))
    tc = materialize(TM.cache_meta(tcfg, B, s, True), 0, "float32")
    jstep = jax.jit(functools.partial(JM.decode_step, jcfg, seq_len=s,
                                      long_mode=True))
    for i in range(s):
        jl, jc = jstep(jp, jc, jnp.int32(i), jnp.asarray(toks[:, i]))
        tl, _ = TM.decode_step(tcfg, tp, tc, i, torch.from_numpy(toks[:, i]),
                               seq_len=s, long_mode=True)
        _close(tl, jl, MODEL_TOL, f"step {i}")


# ---------------------------------------------------------------------------
# Training with the encoder and the stub frontend
# ---------------------------------------------------------------------------

#: float32 gradient tolerance of a leaf's largest element (measured:
#: whisper 1.5e-6, llava 1.4e-6).
FRONT_TOL = 1e-5


@pytest.mark.parametrize("name", ["whisper-base", "llava-next-mistral-7b"])
def test_frontend_loss_and_grads_match_jax(name):
    """loss_fn with the trainer's embeddings (built alike by both
    packages' build_client_batches): the loss within 1e-5 relative and
    every gradient, the encoder's and cross-attention's included."""
    jcfg, tcfg = _configs(name)
    jp, tp = np_model_params(jcfg, tcfg, seed=0)
    jb = jtrain.build_client_batches(jcfg, 1, 2, 32, seed=3)
    tb = train.build_client_batches(tcfg, 1, 2, 32, seed=3, device="cpu")
    for k in ("tokens", "embeds"):
        assert np.array_equal(tb[k].numpy(), np.asarray(jb[k]))
    toks, emb = jb["tokens"][0], jb["embeds"][0]
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, toks, frontend_embeds=emb,
                             remat="none")))(jp)
    leaves, td = T.flatten(tp)
    req = [x.clone().requires_grad_(True) for x in leaves]
    loss = TM.loss_fn(tcfg, td.unflatten(req), tb["tokens"][0],
                      frontend_embeds=tb["embeds"][0], remat="none")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(req)
    for x, g in zip(req, jleaves):
        _close(x.grad, g, FRONT_TOL)


@pytest.mark.parametrize("name", ["whisper-base", "llava-next-mistral-7b"])
def test_frontend_round_uplink_bits_are_exact(name):
    """One FedAdam-SSM round of the smoke model (bfloat16, the per-leaf
    compress) through the trainer's loss with its embeddings: finite
    losses, and the bill equal to JAX's for the same tree (the encoder's
    leaves in it)."""
    cfg = reduce_for_smoke(get_config(name))
    jcfg = jreduce(jget_config(name))
    kw = dict(algorithm="fedadam_ssm", alpha=0.05, n_clients=2,
              local_epochs=1, exact_topk=False)
    fed = FedConfig(**kw, adam=AdamHyper(lr=1e-3))
    run, state = train.make_trainer(cfg, fed, device="cpu")
    batch = train.build_client_batches(cfg, 2, 2, 16, device="cpu")
    state, mets = run(state, batch)
    assert torch.isfinite(mets["loss"]).all()
    sizes = tuple(x.numel() for x in T.leaves(state.W))
    jsizes = tuple(x.size for x in jax.tree_util.tree_leaves(
        JM.abstract_params_sds(jcfg)))
    assert sizes == jsizes
    n_enc = len(T.leaves(TM.abstract_params(cfg).get("encoder")))
    assert n_enc == (9 if cfg.encoder is not None else 0)
    per_client = jmake_compressor(jfed.FedConfig(
        **kw, adam=jadam.AdamHyper(lr=1e-3))).wire_bits_per_client(jsizes)
    assert float(mets["uplink_bits"]) == float(np.float32(2 * per_client))


# ---------------------------------------------------------------------------
# The serving CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "whisper-base",
                                  "llava-next-mistral-7b"])
def test_serve_cli_runs_on_cpu(name, capsys):
    out = serve.main(["--arch", name, "--smoke", "--device", "cpu",
                      "--prompt-len", "8", "--gen", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"[serve] {name}-smoke: batch=2 prompt=8 gen=4"
    assert lines[1].startswith("[serve] prompt replay ")
    assert lines[1].endswith(" tok/s)")
    assert lines[2] == f"[serve] sample: {out[0].tolist()}"
    assert tuple(out.shape) == (2, 4)
    assert int(out.max()) < get_config(name).vocab_size


def test_serve_cli_is_greedy_and_repeatable(capsys):
    """Two runs print the same tokens; the tokens are the argmax of the
    replayed logits, step by step (no temperature)."""
    argv = ["--arch", "mamba2-1-3b", "--smoke", "--device", "cpu",
            "--prompt-len", "6", "--gen", "3"]
    a, b = serve.main(argv), serve.main(argv)
    assert torch.equal(a, b)
    cfg = reduce_for_smoke(get_config("mamba2-1-3b"))
    params, toks, _, seq = serve.setup(cfg, 2, 6, 3, device="cpu")
    caches = serve.new_caches(cfg, 2, seq, "cpu")
    logits, pos = serve.replay(cfg, params, caches, toks, seq_len=seq)
    got = []
    for _ in range(3):
        got.append(logits.argmax(-1))
        logits, _ = TM.decode_step(cfg, params, caches, pos, got[-1],
                                   seq_len=seq)
        pos += 1
    assert torch.equal(torch.stack(got, 1), a)


def test_serve_cli_needs_a_card_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "mamba2-1-3b", "--smoke"])
