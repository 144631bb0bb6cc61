"""The port's quantizers, its sign, b-bit and dense wire codecs and its
quantizing compressors against the JAX package.

* ``uniform_encode``/``uniform_decode``: codes and scales bitwise against
  eager JAX.  Jitted XLA rewrites the scale's ``/ qmax`` as a product with
  the reciprocal, so against it a scale may be one float32 ulp off and a
  code one step off where that ulp moves ``x / scale`` across a half.
* ``sign_quant``: the signs bitwise; the scale (a block's mean |x|) within
  8 float32 ulps, since PyTorch and XLA sum a block in other orders (at
  most 5 ulps seen over 20 seeds of 256 blocks on the CPU).
* The codecs: words, scales and values bitwise against the JAX codecs on
  the same carrier, the JAX words packed by its wirepack kernel in
  interpret mode (``REPRO_SPARSIFY_BACKEND=kernel``) and by its jnp
  references; ``8 * payload_nbytes`` equals the layout's wire bits.
* The compressors: Efficient-Adam's codes, scales, words, carrier and EF
  residual bitwise against eager JAX; 1-bit Adam's sign words bitwise and
  its scales within the sign scale's bound; FedAdam and FedSGD build no
  payload in ``compress``, and the one ``pack_wire`` builds is JAX's.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_bitwise, bf16_bits, bits, leaf_to_jax,
                           leaf_to_torch)
from repro.core import compressors as JC
from repro.core import comm as jcomm
from repro.core import quantize as JQ
from repro.core import wire as JW
from repro.kernels.wirepack import ref as jwref
from repro_torch.core import comm, compressors, quantize as Q
from repro_torch.core import wire as W
from repro_torch.core.compressors import Deltas
from repro_torch.kernels.wirepack import ops as WO

#: float32 ulps between the port's and XLA's mean |block| (see above).
SIGN_SCALE_ULPS = 8
#: Leaves of a tree with a ragged last block, a sub-block leaf and a 2-D
#: leaf; the bfloat16 one is the transformer's matrix dtype.
SHAPES = [(9001,), (37,), (8, 1024), (3, 5, 7)]


def _x(seed, n=64 * 1024 - 77, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _tree(seed, scale=1e-3, bf16=("l2",)):
    """numpy leaves (uint16 = bfloat16 bits)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, s in enumerate(SHAPES):
        x = (rng.standard_normal(s) * scale).astype(np.float32)
        out[f"l{i}"] = bf16_bits(x) if f"l{i}" in bf16 else x
    return out


def _jt(tree):
    return {k: leaf_to_jax(v) for k, v in tree.items()}


def _tt(tree):
    return {k: leaf_to_torch(v) for k, v in tree.items()}


def _ulps(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    sp = np.spacing(np.abs(b).astype(np.float32)).astype(np.float64)
    return float(np.max(np.abs(a - b) / sp))


@pytest.fixture(params=["kernel", "reference"])
def jax_wire_backend(request, monkeypatch):
    """The JAX codecs' word packer: its Pallas kernel in interpret mode, or
    its jnp reference."""
    monkeypatch.setenv("REPRO_SPARSIFY_BACKEND", request.param)
    return request.param


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits_", [2, 4, 8])
def test_uniform_encode_decode_bitwise_vs_eager_jax(bits_):
    x = _x(0)
    c, s = Q.uniform_encode(torch.from_numpy(x), bits_)
    jc, js = JQ.uniform_encode(jnp.asarray(x), bits_)
    assert c.dtype == torch.int32 and s.dtype == torch.float32
    assert_bitwise(c, np.asarray(jc), "codes")
    assert_bitwise(s, np.asarray(js), "scales")
    qmax = 2 ** (bits_ - 1) - 1
    assert int(c.abs().max()) == qmax
    assert_bitwise(Q.uniform_decode(c, s),
                   np.asarray(JQ.uniform_decode(jc, js)), "decode")
    # the round trip is JAX's uniform_quant
    assert_bitwise(Q.uniform_decode(c, s),
                   np.asarray(JQ.uniform_quant(jnp.asarray(x), bits_)),
                   "quant")


@pytest.mark.parametrize("bits_", [4, 8])
def test_uniform_encode_within_an_ulp_of_jitted_jax(bits_):
    x = _x(1)
    c, s = Q.uniform_encode(torch.from_numpy(x), bits_)
    jc, js = jax.jit(lambda a: JQ.uniform_encode(a, bits_))(jnp.asarray(x))
    jc, js = np.asarray(jc), np.asarray(js)
    assert _ulps(s.numpy(), js) <= 1.0
    same = np.repeat(bits(s) == bits(js), 1024)[:x.size]
    assert np.array_equal(c.numpy()[same], jc[same])
    assert np.all(np.abs(c.numpy() - jc) <= 1)


def test_sign_quant_signs_bitwise_scales_within_bound():
    for seed, scale in ((2, 1.0), (3, 1e-4)):
        x = _x(seed, scale=scale)
        q = Q.sign_quant(torch.from_numpy(x)).numpy()
        for ref in (JQ.sign_quant(jnp.asarray(x)),
                    jax.jit(JQ.sign_quant)(jnp.asarray(x))):
            ref = np.asarray(ref)
            assert np.array_equal(np.signbit(q), np.signbit(ref))
            assert _ulps(q, ref) <= SIGN_SCALE_ULPS
        # two-valued per block: +-scale
        blocks = np.abs(np.pad(q, (0, (-q.size) % 1024))).reshape(-1, 1024)
        assert np.all((blocks[:, :1] == blocks) | (blocks == 0))


def test_tree_sign_quant_matches_eager_jax():
    """Per leaf of a mixed-dtype tree: the signs bitwise, the scales
    within the sign scale's bound at the leaf's precision."""
    tree = _tree(5)
    ref = JQ.tree_sign_quant(_jt(tree))
    out = Q.tree_sign_quant(_tt(tree))
    for k in tree:
        a = out[k].float().numpy()
        b = np.asarray(ref[k].astype(jnp.float32))
        assert np.array_equal(np.signbit(a), np.signbit(b)), k
        # a bfloat16 carrier rounds the scale to bfloat16: one bfloat16
        # ulp is 2^16 float32 ulps
        bound = SIGN_SCALE_ULPS if out[k].dtype == torch.float32 \
            else 2 ** 16
        assert _ulps(a, b) <= bound, k


# ---------------------------------------------------------------------------
# The word-level scheme wrappers
# ---------------------------------------------------------------------------


def test_sign_and_bbit_wrappers_match_the_jax_references():
    rng = np.random.default_rng(6)
    xp = rng.standard_normal((64, 128)).astype(np.float32)
    xp[3, :7] = 0.0
    xp[4, :5] = -0.0
    words, scales = WO.pack_sign_scale(torch.from_numpy(xp))
    jw, js = jwref.pack_sign_scale_ref(jnp.asarray(xp))
    assert_bitwise(words, np.asarray(jw), "sign words")
    assert_bitwise(scales, np.asarray(js), "sign scales")
    assert_bitwise(WO.unpack_sign_scale(words, scales),
                   np.asarray(jwref.unpack_sign_scale_ref(jw, js)),
                   "sign carrier")
    for b in (2, 4, 8):
        qmax = 2 ** (b - 1) - 1
        codes = rng.integers(-qmax, qmax + 1, (64, 128)).astype(np.int32)
        w = WO.pack_bbit(torch.from_numpy(codes), b)
        assert_bitwise(w, np.asarray(jwref.pack_bbit_ref(
            jnp.asarray(codes), b)), f"b={b} words")
        assert_bitwise(WO.unpack_bbit(w, b), codes, f"b={b} codes")
        assert_bitwise(WO.pack_bbit_plain(torch.from_numpy(codes), b), w)


# ---------------------------------------------------------------------------
# The codecs
# ---------------------------------------------------------------------------


def test_pack_sign_matches_jax(jax_wire_backend):
    # the carrier made once (the JAX quantizer's) and handed to both codecs
    carrier = {k: np.asarray(v).view(np.uint16) if v.dtype == jnp.bfloat16
               else np.asarray(v)
               for k, v in JQ.tree_sign_quant(_jt(_tree(7))).items()}
    pay = W.pack_sign(_tt(carrier))
    jpay = JW.pack_sign(_jt(carrier))
    assert len(pay.words) == len(pay.scales) == 1 and not pay.values
    assert_bitwise(pay.words[0], np.asarray(jpay.words[0]), "sign words")
    assert_bitwise(pay.scales[0], np.asarray(jpay.scales[0]), "scales")
    sizes = tuple(int(np.prod(s)) for s in SHAPES)
    nbytes = W.payload_nbytes(pay)
    assert nbytes == JW.payload_nbytes(jpay)
    assert 8 * nbytes == W.sign_wire_bits(sizes) == JW.sign_wire_bits(sizes)
    back = W.unpack_sign(pay, _tt(carrier))
    for k in carrier:
        assert_bitwise(back[k], carrier[k], f"round trip [{k}]")


@pytest.mark.parametrize("bits_", [2, 4, 8])
def test_pack_bbit_codes_matches_jax(jax_wire_backend, bits_):
    tree = _tree(8)
    enc = [JQ.uniform_encode(leaf_to_jax(tree[k]), bits_) for k in tree]
    codes = [np.asarray(c) for c, _ in enc]
    scales = [np.asarray(s) for _, s in enc]
    pay = W.pack_bbit_codes([leaf_to_torch(c) for c in codes],
                            [leaf_to_torch(s) for s in scales], bits_)
    jpay = JW.pack_bbit_codes([c for c, _ in enc], [s for _, s in enc],
                              bits_)
    assert len(pay.words) == 1 and len(pay.scales) == len(SHAPES)
    assert_bitwise(pay.words[0], np.asarray(jpay.words[0]), "code words")
    for a, b in zip(pay.scales, jpay.scales):
        assert_bitwise(a, np.asarray(b), "scales")
    sizes = tuple(int(np.prod(s)) for s in SHAPES)
    nbytes = W.payload_nbytes(pay)
    assert nbytes == JW.payload_nbytes(jpay)
    assert 8 * nbytes == W.bbit_wire_bits(sizes, bits_) == \
        JW.bbit_wire_bits(sizes, bits_)
    like = _tt(tree)
    back = W.unpack_bbit_codes(pay, like, bits_)
    ref = JW.unpack_bbit_codes(jpay, _jt(tree), bits_)
    for k in tree:
        assert back[k].dtype == like[k].dtype
        assert_bitwise(back[k], np.asarray(ref[k]), f"decode [{k}]")


@pytest.mark.parametrize("n_tensors", [1, 3])
def test_pack_dense_matches_jax(n_tensors):
    trees = [_tree(s) for s in (9, 10, 11)][:n_tensors]
    pay = W.pack_dense([_tt(t) for t in trees])
    jpay = JW.pack_dense([_jt(t) for t in trees])
    assert len(pay.values) == n_tensors and not pay.words
    for a, b in zip(pay.values, jpay.values):
        assert_bitwise(a, np.asarray(b), "plane")
    sizes = tuple(int(np.prod(s)) for s in SHAPES)
    assert 8 * W.payload_nbytes(pay) == W.dense_wire_bits(sizes, n_tensors) \
        == JW.dense_wire_bits(sizes, n_tensors)
    for out, t in zip(W.unpack_dense(pay, _tt(trees[0])), trees):
        for k in t:
            assert_bitwise(out[k], t[k], f"round trip [{k}]")


def test_wire_bits_match_jax_and_comm():
    for sizes in [(1,), (37, 9001), (800, 51200, 401408, 1280),
                  (3 * (1 << 20) + 5, 64)]:
        d = sum(sizes)
        assert W.sign_wire_bits(sizes) == JW.sign_wire_bits(sizes)
        assert W.dense_wire_bits(sizes) == JW.dense_wire_bits(sizes) == \
            comm.bits_fedadam(d, 1)
        assert W.dense_wire_bits(sizes, 1) == comm.bits_fedsgd(d, 1)
        for b in (2, 4, 8):
            assert W.bbit_wire_bits(sizes, b) == JW.bbit_wire_bits(sizes, b)
        for algo in ("onebit_adam", "efficient_adam", "fedsgd", "fedadam"):
            assert comm.bits_for(algo, d, 1, 3) == \
                jcomm.bits_for(algo, d, 1, 3)


# ---------------------------------------------------------------------------
# The compressors against eager JAX
# ---------------------------------------------------------------------------


def _Fed(algorithm, quant_bits=8):
    """The FedConfig fields the quantizing compressors' factories read."""
    return SimpleNamespace(algorithm=algorithm, quant_bits=quant_bits,
                           q_bits=32)


def _deltas_and_state(seed):
    tree, err = _tree(seed), _tree(seed + 1, 1e-5)
    zeros = {k: np.zeros_like(v) for k, v in tree.items()}
    return tree, err, zeros


@pytest.mark.parametrize("quant_bits", [4, 8])
def test_efficient_adam_compress_bitwise_vs_eager_jax(jax_wire_backend,
                                                      quant_bits):
    dW, err, z = _deltas_and_state(20)
    jcomp = JC.make_compressor(_Fed("efficient_adam", quant_bits))
    tcomp = compressors.make_compressor(_Fed("efficient_adam", quant_bits))
    assert (tcomp.transport, tcomp.local_update, tcomp.server_update,
            tcomp.wire_layout) == (jcomp.transport, jcomp.local_update,
                                   jcomp.server_update, jcomp.wire_layout)
    jp, jst, jbits = jcomp.compress(JC.Deltas(_jt(dW), _jt(z), _jt(z)),
                                    {"err": _jt(err)})
    tp, tst, tbits = tcomp.compress(Deltas(_tt(dW), _tt(z), _tt(z)),
                                    {"err": _tt(err)})
    assert tbits == int(jbits)
    for k in dW:
        assert_bitwise(tp.W[k], np.asarray(jp.W[k]), f"carrier [{k}]")
        assert_bitwise(tst["err"][k], np.asarray(jst["err"][k]),
                       f"EF residual [{k}]")
        assert not bool(tp.M[k].any()) and not bool(tp.V[k].any())
    assert_bitwise(tp.wire.words[0], np.asarray(jp.wire.words[0]), "words")
    for a, b in zip(tp.wire.scales, jp.wire.scales):
        assert_bitwise(a, np.asarray(b), "scales")
    sizes = tuple(int(np.prod(s)) for s in SHAPES)
    assert 8 * W.payload_nbytes(tp.wire) == tcomp.wire_bits_per_client(sizes)
    back = tcomp.unpack_wire(tp.wire, _tt(dW))
    for k in dW:
        assert_bitwise(back.W[k], tp.W[k], f"wire round trip [{k}]")


def test_onebit_adam_compress_vs_eager_jax(jax_wire_backend):
    dM, err, z = _deltas_and_state(30)
    jcomp = JC.make_compressor(_Fed("onebit_adam"))
    tcomp = compressors.make_compressor(_Fed("onebit_adam"))
    assert (tcomp.transport, tcomp.local_update, tcomp.server_update,
            tcomp.wire_layout) == ("quantized", "momentum", "precond_m",
                                   "sign")
    jp, jst, jbits = jcomp.compress(JC.Deltas(_jt(z), _jt(dM), _jt(z)),
                                    {"err": _jt(err)})
    tp, tst, tbits = tcomp.compress(Deltas(_tt(z), _tt(dM), _tt(z)),
                                    {"err": _tt(err)})
    assert tbits == int(jbits)
    assert_bitwise(tp.wire.words[0], np.asarray(jp.wire.words[0]),
                   "sign words")
    assert _ulps(tp.wire.scales[0].numpy(),
                 np.asarray(jp.wire.scales[0])) <= SIGN_SCALE_ULPS
    for k in dM:
        a = tp.M[k].float().numpy()
        b = np.asarray(jp.M[k].astype(jnp.float32))
        assert np.array_equal(np.signbit(a), np.signbit(b)), k
        assert not bool(tp.W[k].any()) and not bool(tp.V[k].any())
    sizes = tuple(int(np.prod(s)) for s in SHAPES)
    assert 8 * W.payload_nbytes(tp.wire) == tcomp.wire_bits_per_client(sizes)
    back = tcomp.unpack_wire(tp.wire, _tt(dM))
    for k in dM:
        assert_bitwise(back.M[k], tp.M[k], f"wire round trip [{k}]")


@pytest.mark.parametrize("algorithm", ["fedadam", "fedsgd"])
def test_dense_compress_builds_no_payload_and_pack_wire_matches_jax(
        algorithm):
    """The dense round never decodes a payload, so ``compress`` builds
    none; ``pack_wire`` on the same deltas gives the JAX compressor's
    planes bitwise, ``8 * payload_nbytes`` equal to the layout's bits,
    and decodes to the deltas it sent."""
    trees = [_tree(s) for s in (40, 41, 42)]
    jcomp = JC.make_compressor(_Fed(algorithm))
    tcomp = compressors.make_compressor(_Fed(algorithm))
    assert (tcomp.transport, tcomp.local_update, tcomp.server_update) == \
        (jcomp.transport, jcomp.local_update, jcomp.server_update)
    deltas = Deltas(*map(_tt, trees))
    tp, tst, tbits = tcomp.compress(deltas, None)
    jp, _, jbits = jcomp.compress(JC.Deltas(*map(_jt, trees)), None)
    assert tp.wire is None and tst is None and tbits == int(jbits)
    for part, t in zip(tp[:3], trees):
        for k in t:
            assert_bitwise(part[k], t[k], f"carrier [{k}]")
    pay = tcomp.pack_wire(deltas)
    assert len(pay.values) == tcomp.n_tensors == len(jp.wire.values)
    for a, b in zip(pay.values, jp.wire.values):
        assert_bitwise(a, np.asarray(b), "plane")
    sizes = tuple(int(np.prod(s)) for s in SHAPES)
    assert 8 * W.payload_nbytes(pay) == tcomp.wire_bits_per_client(sizes)
    back = tcomp.unpack_wire(pay, deltas.W)
    for part, t in zip(back[:tcomp.n_tensors], trees):
        for k in t:
            assert_bitwise(part[k], t[k], f"round trip [{k}]")
