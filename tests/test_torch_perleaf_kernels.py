"""The port's per-leaf kernels (fused_adam, absmax, count_ge, select_tau,
apply_mask and topk_mask, ssm_apply_ef, ssm_apply), the per-leaf fused
compress and FedAdam-Top's per-leaf masks against the JAX package.

The port runs on the CPU, where each wrapper runs its kernel's plain
version; the JAX side runs its Pallas kernels in interpret mode (leaves of
8192 elements and more; smaller ones go to its jnp oracle), in float32 and
in bfloat16, at lengths below, at and above one 8192-element tile and with
an odd tail.  Inputs come from numpy with a seed; bfloat16 crosses as its
bits.  Everything is bitwise except where a tolerance is stated with its
reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (COUNT_CASES, as_dtype, assert_bitwise, bits,
                           count_edge_cases, leaf_to_jax, leaf_to_torch,
                           taus_sorted)
from repro.core import sparsify as JS
from repro.core import wire as JW
from repro.kernels.fused_adam import ops as jfused
from repro.kernels.fused_adam.ref import fused_adam_ref as jfused_ref
from repro.kernels.ssm_apply import ops as jssm
from repro.kernels.topk_mask import ops as jtm
from repro.kernels.topk_mask import topk_mask as jtmk
from repro.optim import adam as jadam
from repro_torch.core import sparsify as S
from repro_torch.core import wire as W
from repro_torch.core.compressors import (IndependentTopKCompressor,
                                         SharedTopKCompressor, tree_sub)
from repro_torch.kernels.fused_adam import ops as fused
from repro_torch.kernels.ssm_apply import ops as ssm
from repro_torch.kernels.topk_mask import ops as tm
from repro_torch.kernels.topk_mask import ref as tmref
from repro_torch.optim import adam

DTYPES = ["float32", "bfloat16"]
# below one 8192-element tile, exactly one, and above with an odd tail
LENGTHS = [1000, 8192, 20001]
ALPHA = 0.05
EPS32 = float(np.finfo(np.float32).eps)


def _pair(x, dtype):
    """The same leaf for both packages: (jax array, torch tensor)."""
    a = as_dtype(x, dtype)
    return leaf_to_jax(a), leaf_to_torch(a)


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x).astype(np.float64)


def _spacing(x, dtype):
    sp = np.spacing(np.abs(x).astype(np.float32)).astype(np.float64)
    return sp * 2.0 ** 16 if dtype == "bfloat16" else sp


def _assert_adam_close(out, ref, inputs, lr, dtype, exact_moments):
    """(w', m', v') against a reference computed with other roundings.

    * an FMA in ``b1*m + (1-b1)*g`` (jitted XLA) skips a rounding of each
      product: m' may differ by 2 float32 epsilons of its terms'
      magnitude, v' likewise, then one rounding to the dtype;
    * w' = w - lr * m' * rsqrt(v' + eps): the root (PyTorch's CPU rsqrt is
      1/sqrt, two roundings; XLA's is another sequence) moves lr * upd by
      4 float32 epsilons of itself, m' and v' carry their own error
      through, and w' rounds once to the dtype.
    With ``exact_moments`` m' and v' must be bitwise equal instead."""
    w, g, m, v = (_f64(x) for x in inputs)
    wr, mr, vr = (_f64(x) for x in ref)
    dm = 2 * EPS32 * (0.9 * np.abs(m) + 0.1 * np.abs(g))
    dv = 2 * EPS32 * (0.999 * np.abs(v) + 0.001 * g * g)
    if exact_moments:
        assert_bitwise(out[1], ref[1], "m")
        assert_bitwise(out[2], ref[2], "v")
        dm = dv = 0.0
    else:
        for name, a, b, d in (("m", out[1], mr, dm), ("v", out[2], vr, dv)):
            err = np.abs(_f64(a) - b)
            assert np.all(err <= _spacing(b, dtype) + d), name
    root = 1.0 / np.sqrt(vr + 1e-6)
    bound = (_spacing(wr, dtype) + 4 * EPS32 * np.abs(w - wr)
             + lr * (dm + np.abs(mr) * dv * root ** 2) * root)
    err = np.abs(_f64(out[0]) - wr)
    assert np.all(err <= bound), float(np.max(err - bound))


# ---------------------------------------------------------------------------
# fused_adam (ROADMAP §2 row 5)
# ---------------------------------------------------------------------------


def _adam_case(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    w, g, m = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(n)).astype(np.float32) * 0.01
    return [_pair(x, dtype) for x in (w, g * 0.1, m * 0.01, v)]


@pytest.mark.parametrize("bias", [False, True])
def test_effective_scalars_match_jax(bias):
    h = jadam.AdamHyper(lr=3e-3, bias_correction=bias)
    th = adam.AdamHyper(lr=3e-3, bias_correction=bias)
    for count in (0, 1, 7, 999):
        ref = jfused._effective_scalars(h, jnp.asarray(count, jnp.int32))
        assert_bitwise(fused.effective_scalars(th, count, "cpu"), ref,
                       f"count {count}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("bias", [False, True])
def test_fused_adam_plain_matches_jax_op_by_op(dtype, n, bias):
    """m' and v' bitwise against fused_adam_ref run eagerly (op by op, as
    the plain version runs); w' within the root's error
    (:func:`_assert_adam_close`)."""
    h = jadam.AdamHyper(lr=3e-3, bias_correction=bias)
    scalars = jfused._effective_scalars(h, jnp.asarray(4, jnp.int32))
    (jw, tw), (jg, tg), (jm, tm_), (jv, tv) = _adam_case(n, dtype)
    ref = jfused_ref(scalars, jw, jg, jm, jv)
    out = fused.fused_adam_plain(torch.from_numpy(np.array(scalars)),
                                 tw, tg, tm_, tv)
    _assert_adam_close(out, ref, (tw, tg, tm_, tv), 3e-3, dtype,
                       exact_moments=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_fused_adam_matches_jax_pallas_kernel(dtype, n):
    """The whole wrapper (scalars included) against JAX's ``fused_adam``,
    which runs the jitted interpret-mode Pallas kernel from 8192 elements
    on.  Inside jit XLA fuses the kernel body and contracts ``b1*m +
    (1-b1)*g`` into an FMA: the bounds of :func:`_assert_adam_close`;
    below one tile JAX runs its oracle eagerly and m', v' are bitwise."""
    h = jadam.AdamHyper(lr=3e-3)
    th = adam.AdamHyper(lr=3e-3)
    (jw, tw), (jg, tg), (jm, tm_), (jv, tv) = _adam_case(n, dtype, seed=1)
    ref = jfused.fused_adam(jw, jg, jm, jv, h, jnp.asarray(2, jnp.int32))
    out = fused.fused_adam_apply(fused.effective_scalars(th, 2, "cpu"),
                                 tw, tg, tm_, tv)
    for name, a, b in zip("wmv", out, ref):
        assert a.dtype == getattr(torch, dtype), name
    _assert_adam_close(out, ref, (tw, tg, tm_, tv), 3e-3, dtype,
                       exact_moments=n < 8192)


def test_fused_path_is_not_the_unfused_step():
    """1 - b1 in float32 (0.100000024) is not float32(1 - 0.9): the fused
    and the unfused Adam differ in m' at the last bit (ROADMAP §3)."""
    (_, tw), (_, tg), (_, tm_), (_, tv) = _adam_case(4096, "float32")
    h = adam.AdamHyper()
    unf = adam._adam_leaf(tw, tg, tm_, tv, h, 0)
    fus = fused.fused_adam_apply(fused.effective_scalars(h, 0, "cpu"),
                                 tw, tg, tm_, tv)
    assert not np.array_equal(bits(unf[1]), bits(fus[1]))
    assert float(1.0 - torch.tensor(0.9)) == pytest.approx(0.100000024,
                                                           abs=1e-9)


def test_adam_step_use_kernel_matches_jax_over_a_tree():
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 4000), "b": (128,), "c": (9000,)}
    dts = {"a": "bfloat16", "b": "float32", "c": "bfloat16"}
    mk = lambda scale: {k: as_dtype(rng.standard_normal(s) * scale, dts[k])
                        for k, s in shapes.items()}
    w, g, m = mk(1.0), mk(0.1), mk(0.01)
    v = {k: as_dtype(np.abs(rng.standard_normal(s)) * 0.01, dts[k])
         for k, s in shapes.items()}
    jt = lambda t: {k: leaf_to_jax(x) for k, x in t.items()}
    tt = lambda t: {k: leaf_to_torch(x) for k, x in t.items()}
    h = jadam.AdamHyper(lr=1e-2)
    jp, jst = jadam.adam_step(jt(w), jt(g), jadam.AdamState(
        jt(m), jt(v), jnp.asarray(0, jnp.int32)), h, use_kernel=True)
    tp, tst = adam.adam_step(tt(w), tt(g), adam.AdamState(tt(m), tt(v), 0),
                             adam.AdamHyper(lr=1e-2), use_kernel=True)
    assert tst.count == 1
    for k in shapes:
        out = (tp[k], tst.m[k], tst.v[k])
        assert all(x.dtype == getattr(torch, dts[k]) for x in out)
        # leaves of 8192+ elements ran the jitted Pallas kernel (FMA)
        _assert_adam_close(out, (jp[k], jst.m[k], jst.v[k]),
                           (tt(w)[k], tt(g)[k], tt(m)[k], tt(v)[k]), 1e-2,
                           dts[k], exact_moments=np.prod(shapes[k]) < 8192)


# ---------------------------------------------------------------------------
# absmax, count_ge, select_tau (rows 6 and 7)
# ---------------------------------------------------------------------------


def _padded_2d(x):
    n = x.size
    return jnp.pad(x.reshape(-1), (0, (-n) % 8192)).reshape(-1, 1024)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_absmax_and_count_ge_match_jax_kernels(dtype, n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jam = jtmk.absmax_2d(_padded_2d(jx))
    am = tm.absmax(tx)
    assert_bitwise(am, jam, "absmax")
    taus = tmref.log2_taus(am)
    jc = jtmk.count_ge_2d(jnp.asarray(taus.numpy()), _padded_2d(jx))
    assert_bitwise(tm.count_ge(taus, tx), jc, "counts")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_select_tau_matches_jax_kernel(dtype, n):
    x = np.random.default_rng(n + 1).standard_normal(n).astype(np.float32)
    jx, tx = _pair(x, dtype)
    k = S.k_for(n, ALPHA)
    jtau, jcount = jtm.select_tau_kernel(jx, k)
    tau, count = tm.select_tau(tx, k)
    assert_bitwise(tau, jtau, "tau")
    assert_bitwise(count, jcount, "count")
    assert_bitwise(tmref.select_tau_ref(tx, k), jtau, "select_tau_ref")
    mask = tmref.topk_mask_ref(tx, k)
    assert int(mask.sum()) == int(count)
    assert k <= int(count) <= k + tmref.overselect_bound(k, n)


@pytest.mark.parametrize("n", [1000, 20001])
@pytest.mark.parametrize("dtype,kind", [("float32", "zero"),
                                        ("bfloat16", "zero"),
                                        ("float32", "subnormal")])
def test_select_tau_counts_the_padding_like_jax(dtype, kind, n):
    """Where tau comes out 0 the JAX wrapper's achieved count takes in its
    zero padding up to a whole 8192-element tile: n + (-n mod 8192).  On
    an all-zero leaf absmax is 0.  On the subnormal-scaled leaf it is not
    (fewer than k elements are non-zero, all a few 2^-149), yet the log2
    candidates underflow to 0 and tau comes out 0 all the same.  (XLA
    flushes the subnormals to zero and reaches the same tau and count.  A
    bfloat16 leaf cannot take this path: its smallest subnormal, 2^-133,
    times the smallest log2 factor, 2^-15.5, is still above 0.)"""
    rng = np.random.default_rng(n + 3)
    scale = 0.0 if kind == "zero" else 0.2 * 2.0 ** -149
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    jx, tx = _pair(x, dtype)
    k = S.k_for(n, ALPHA)
    if kind == "subnormal":             # the premise of the case
        assert 0 < int((tx != 0).sum()) < k
        assert 0 < float(tm.absmax(tx)) < float(np.finfo(np.float32).tiny)
    jtau, jcount = jtm.select_tau_kernel(jx, k)
    tau, count = tm.select_tau(tx, k)
    assert_bitwise(tau, jtau, "tau")
    assert_bitwise(count, jcount, "count")
    assert float(tau) == 0.0 and int(count) == n + (-n) % 8192


def count_ge_by_rank(taus: torch.Tensor, x: torch.Tensor,
                     pad: int = 0) -> torch.Tensor:
    """The count kernel's formulation in torch.  For non-increasing,
    NaN-free candidates each element's rank (the first j with |x| >=
    taus[j], 32 for none and for NaN) is found by ``searchsorted`` on the
    ascending candidates, the ranks are counted (``bincount``) and
    count[j] is the prefix sum over ranks <= j (``cumsum``).  Other
    candidates take the 32-compare count, as the kernel's CTAs do.  The
    ``pad`` zeros count where a candidate is <= 0."""
    a = x.reshape(-1).to(torch.float32).abs()
    if taus_sorted(taus):
        at_or_below = torch.searchsorted(taus.flip(0).contiguous(), a,
                                         right=True)
        rank = torch.where(a.isnan(), 32, 32 - at_or_below)
        counts = torch.bincount(rank, minlength=33)[:32].cumsum(0)
    else:
        counts = (a[None, :] >= taus[:, None]).sum(dim=1)
    return (counts + pad * (taus <= 0)).to(torch.float32)


def count_ge_by_key_table(taus: torch.Tensor, x: torch.Tensor,
                          pad: int = 0) -> torch.Tensor:
    """The kernel's ranks of a bfloat16 leaf (sorted NaN-free candidates),
    in torch: the first |bfloat16| key (bits with the sign cleared) at or
    above each candidate bounds it; a key's rank is the number of bounds
    above it, 32 for the NaN keys above +inf (0x7f80); each element's rank
    is the table's entry at its key, then ``bincount`` and ``cumsum``."""
    u = taus.view(torch.int32).to(torch.int64)
    bound = torch.where(taus > 0, (u >> 16) + ((u & 0xffff) != 0), 0)
    keys = torch.arange(0x8000)
    table = (bound[None, :] > keys[:, None]).sum(dim=1)
    table[keys > 0x7f80] = 32
    key = x.reshape(-1).view(torch.int16).to(torch.int64) & 0x7fff
    counts = torch.bincount(table[key], minlength=33)[:32].cumsum(0)
    return (counts + pad * (taus <= 0)).to(torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", COUNT_CASES)
def test_count_ge_rank_formulation_matches_plain_and_jax(dtype, case):
    """The rank-and-prefix-sum count (and, for a bfloat16 leaf, its
    key-table ranks) bitwise against ``count_ge_plain`` and JAX's
    ``count_ge_2d`` (over the leaf and its zero padding, interpret mode),
    on each edge case: all-equal and all-zero candidates, NaN and
    infinities in x, a NaN candidate, unsorted candidates, +0 and -0 on
    both sides, subnormal elements, subnormal candidates (not against
    JAX: XLA flushes them to zero) and elements tied with candidates."""
    n = 20001
    taus, x, xla_exact = count_edge_cases(n, getattr(torch, dtype))[case]
    assert taus_sorted(taus) == (case not in ("nan_taus", "unsorted"))
    pad = (-n) % 8192
    got = count_ge_by_rank(taus, x, pad)
    assert_bitwise(got, tm.count_ge_plain(taus, x, pad), "plain")
    assert_bitwise(got, tm.count_ge(taus, x, pad), "wrapper")
    if dtype == "bfloat16" and taus_sorted(taus):
        assert_bitwise(count_ge_by_key_table(taus, x, pad), got, "table")
    if xla_exact:
        xj = x.view(torch.int16).numpy().view(np.uint16) \
            if dtype == "bfloat16" else x.numpy()
        jc = jtmk.count_ge_2d(jnp.asarray(taus.numpy()),
                              _padded_2d(leaf_to_jax(xj)))
        assert_bitwise(got, jc, "jax")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_topk_mask_matches_jax_kernel(dtype, n):
    """``topk_mask`` (select_tau, then apply_mask) against JAX's
    ``topk_mask_kernel``, whose apply_mask_2d runs in interpret mode:
    mask, tau and count bitwise; ``apply_mask`` alone against
    ``apply_mask_2d`` on the same tau (int8 0/1 there, bool here)."""
    x = np.random.default_rng(n + 2).standard_normal(n).astype(np.float32)
    x = x.reshape(-1, 7) if n % 7 == 0 else x
    jx, tx = _pair(x, dtype)
    k = S.k_for(n, ALPHA)
    jmask, jtau, jcount = jtm.topk_mask_kernel(jx, k)
    mask, tau, count = tm.topk_mask(tx, k)
    assert mask.dtype == torch.bool and mask.shape == tx.shape
    assert_bitwise(mask, np.asarray(jmask), "mask")
    assert_bitwise(tau, jtau, "tau")
    assert_bitwise(count, jcount, "count")
    j8 = np.asarray(jtmk.apply_mask_2d(jtau, _padded_2d(jx)))
    assert j8.dtype == np.int8
    assert np.array_equal(tm.apply_mask(tau, tx).reshape(-1).numpy(),
                          j8.reshape(-1)[:n].astype(bool))
    assert int(mask.sum()) == int(count)


# ---------------------------------------------------------------------------
# ssm_apply (row 10) and ssm_apply_ef (row 9)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8192,), (50_000,), (8, 4096)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_apply_matches_jax(shape, dtype):
    """The 3-in/3-out apply at the shapes and dtypes of the JAX package's
    own ``test_ssm_apply_matches_ref``, against its Pallas kernel in
    interpret mode: bitwise, tau 0.7."""
    rng = np.random.default_rng(2)
    pairs = [_pair(rng.standard_normal(shape).astype(np.float32), dtype)
             for _ in range(3)]
    tau = 0.7
    ref = jssm.ssm_apply(jnp.float32(tau), *(j for j, _ in pairs))
    out = ssm.ssm_apply(torch.tensor(tau, dtype=torch.float32),
                        *(t for _, t in pairs))
    assert len(out) == 3
    for i, (a, b) in enumerate(zip(out, ref)):
        assert a.dtype == getattr(torch, dtype) and a.shape == shape
        assert_bitwise(a, b, f"output {i}")


#: dw, dm and dv dtypes of the mixed calls (one stream differs or all do).
MIXED_DTYPES = [("float32", "bfloat16", "float32"),
                ("bfloat16", "float32", "float32"),
                ("float32", "float32", "bfloat16"),
                ("bfloat16", "bfloat16", "float32"),
                ("float32", "bfloat16", "bfloat16"),
                ("bfloat16", "float32", "bfloat16")]


@pytest.mark.parametrize("shape", [(8192,), (20001,), (100,)])
@pytest.mark.parametrize("dtypes", MIXED_DTYPES, ids="-".join)
def test_ssm_apply_mixed_dtypes_match_jax(shape, dtypes):
    """dw, dm and dv each in its own dtype, as the JAX kernel takes them:
    each output in its input's dtype, bitwise against ``ssm_apply_2d`` in
    interpret mode (from one 8192-element tile on; below it, JAX's jnp
    oracle), tau from the leaf's own selection."""
    rng = np.random.default_rng(4)
    pairs = [_pair(rng.standard_normal(shape).astype(np.float32) * s, dt)
             for s, dt in zip((1e-2, 1e-3, 1e-5), dtypes)]
    n = int(np.prod(shape))
    jtau, _ = jtm.select_tau_kernel(pairs[0][0], S.k_for(n, ALPHA))
    ref = jssm.ssm_apply(jtau, *(j for j, _ in pairs))
    out = ssm.ssm_apply(torch.from_numpy(np.array(jtau)),
                        *(t for _, t in pairs))
    assert len(out) == 3
    for i, (a, b, dt) in enumerate(zip(out, ref, dtypes)):
        assert a.dtype == getattr(torch, dt) and a.shape == shape
        assert_bitwise(a, b, f"output {i}")


def _ssm_case(n, dtype, seed):
    rng = np.random.default_rng(seed)
    dw = rng.standard_normal(n).astype(np.float32) * 1e-2
    dm, sc = (rng.standard_normal(n).astype(np.float32) * s
              for s in (1e-3, 1.0))
    dv = np.abs(rng.standard_normal(n)).astype(np.float32) * 1e-5
    return [_pair(x, dtype) for x in (dw, dm, dv, sc)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("value_dtype,with_residual,use_score", [
    (None, True, False), ("bfloat16", False, True), ("float16", True, True)])
def test_ssm_apply_ef_matches_jax(dtype, n, value_dtype, with_residual,
                                  use_score):
    (jw, tw), (jm, tm_), (jv, tv), (js, ts) = _ssm_case(n, dtype, n)
    score_j, score_t = (js, ts) if use_score else (None, None)
    k = S.k_for(n, ALPHA)
    jtau, _ = jtm.select_tau_kernel(jw if score_j is None else score_j, k)
    tau = torch.from_numpy(np.array(jtau))
    ref = jssm.ssm_apply_ef(jtau, jw, jm, jv, score_j,
                            with_residual=with_residual,
                            value_dtype=value_dtype)
    out = ssm.ssm_apply_ef(tau, tw, tm_, tv, score_t,
                           with_residual=with_residual,
                           value_dtype=value_dtype)
    assert len(out) == len(ref) == 3 + with_residual
    for i, (a, b) in enumerate(zip(out, ref)):
        assert a.dtype == getattr(torch, dtype)
        assert_bitwise(a, b, f"output {i}")


@pytest.mark.parametrize("n", LENGTHS)
def test_ssm_apply_ef_float32_score_on_bfloat16_leaves_matches_jax(n):
    """``fairness_top``'s float32 scores beside bfloat16 dw, dm, dv (the
    TPU kernel widens a score of any type): every output bitwise JAX's,
    in the streams' dtype."""
    (jw, tw), (jm, tm_), (jv, tv) = _ssm_case(n, "bfloat16", n)[:3]
    js, ts = _ssm_case(n, "float32", n + 1)[3]
    jtau, _ = jtm.select_tau_kernel(js, S.k_for(n, ALPHA))
    ref = jssm.ssm_apply_ef(jtau, jw, jm, jv, js)
    out = ssm.ssm_apply_ef(torch.from_numpy(np.array(jtau)), tw, tm_, tv, ts)
    for i, (a, b) in enumerate(zip(out, ref)):
        assert a.dtype == torch.bfloat16
        assert_bitwise(a, b, f"output {i}")


# ---------------------------------------------------------------------------
# The per-leaf fused compress on a mixed bfloat16 / float32 tree
# ---------------------------------------------------------------------------

#: A transformer-like tree: bfloat16 matrices, float32 norm scales; leaves
#: below, at and above one tile, and an odd tail.
MIXED = {"embed": ((64, 130), "bfloat16"), "norm": ((128,), "float32"),
         "w_up": ((2, 1, 64, 128), "bfloat16"), "tail": ((9001,), "bfloat16"),
         "final": ((8192,), "float32")}


def _mixed_deltas(seed):
    rng = np.random.default_rng(seed)
    out = []
    for scale, absval in ((1e-2, False), (1e-3, False), (1e-5, True)):
        t = {}
        for k, (shape, dt) in MIXED.items():
            x = rng.standard_normal(shape) * scale
            t[k] = as_dtype(np.abs(x) if absval else x, dt)
        out.append(t)
    return out


def _both(tree):
    return ({k: leaf_to_jax(x) for k, x in tree.items()},
            {k: leaf_to_torch(x) for k, x in tree.items()})


@pytest.fixture(scope="module")
def mixed_compress():
    """Both packages' per-leaf fused compress of one mixed tree, per
    scope, on their kernel backends."""
    (jw, tw), (jm, tm_), (jv, tv) = (_both(t) for t in _mixed_deltas(5))
    out = {}
    for scope in ("per_tensor", "global"):
        ref = JS.tree_shared_compress_fused(None, jw, jm, jv, ALPHA, scope,
                                            with_residual=True)
        got = S.tree_shared_compress_fused(None, tw, tm_, tv, ALPHA, scope,
                                           with_residual=True)
        out[scope] = (ref, got)
    return (tw, tm_, tv), out


@pytest.mark.parametrize("scope", ["per_tensor", "global"])
def test_mixed_tree_fused_compress_matches_jax(mixed_compress, scope):
    _, out = mixed_compress
    ref, got = out[scope]
    for i, (a, b) in enumerate(zip(got, ref)):
        for k in MIXED:
            assert a[k].dtype == (torch.bool if i == 4 else
                                  getattr(torch, MIXED[k][1]))
            assert_bitwise(a[k], b[k], f"output {i} [{k}]")


@pytest.mark.parametrize("scope", ["per_tensor", "global"])
def test_mixed_tree_fused_compress_matches_composed_ops(mixed_compress,
                                                        scope):
    """Given its own masks, the fused path is the composed reference
    arithmetic (mask apply, then the residual ``tree_sub``)."""
    (tw, tm_, tv), out = mixed_compress
    sW, sM, sV, err, mask = out[scope][1]
    for got, x in ((sW, tw), (sM, tm_), (sV, tv)):
        ref = S.tree_sparsify(x, mask)
        for k in MIXED:
            assert_bitwise(got[k], ref[k], k)
    comp_err = tree_sub(tw, S.tree_sparsify(tw, mask))
    for k in MIXED:
        assert_bitwise(err[k], comp_err[k], k)


def test_mixed_tree_compressor_and_wire_match_jax(monkeypatch):
    """SharedTopKCompressor on the kernel backend carries the mixed tree
    through error feedback, the diagnostics and the wire: the payload is
    byte-identical to the JAX package's and ``8 * nbytes`` is the
    accounted wire bits."""
    from repro.core.compressors import Deltas as JDeltas
    from repro.core.compressors.topk import SharedTopKCompressor as JShared
    from repro_torch.core.compressors import Deltas
    monkeypatch.setenv("REPRO_SPARSIFY_BACKEND", "kernel")
    monkeypatch.setenv(S.SPARSIFY_BACKEND_ENV, "kernel")
    (jw, tw), (jm, tm_), (jv, tv) = (_both(t) for t in _mixed_deltas(6))
    kw = dict(alpha=ALPHA, exact_topk=False, error_feedback=True)
    jc, tc = JShared(**kw), SharedTopKCompressor(**kw)
    jst, tst = jc.init_state(jw), tc.init_state(tw)
    for _ in range(2):                  # round 2 consumes the residual
        jp, jst, _ = jc.compress(JDeltas(jw, jm, jv), jst)
        tp, tst, _ = tc.compress(Deltas(tw, tm_, tv), tst)
        for k in MIXED:
            assert_bitwise(tst["err"][k], jst["err"][k], f"err[{k}]")
            for a, b in zip(tp[:3], jp[:3]):
                assert_bitwise(a[k], b[k], k)
        for name in tp.diag:
            np.testing.assert_allclose(float(tp.diag[name]),
                                       float(jp.diag[name]), rtol=1e-5,
                                       err_msg=name)
        assert_bitwise(tp.wire.words[0], jp.wire.words[0], "bitmap words")
        for i, (a, b) in enumerate(zip(tp.wire.values, jp.wire.values)):
            assert_bitwise(a, b, f"value stream {i}")
    sizes = tuple(int(np.prod(s)) for s, _ in
                  (MIXED[k] for k in sorted(MIXED)))
    nbytes = W.payload_nbytes(tp.wire)
    assert nbytes == JW.payload_nbytes(jp.wire)
    assert 8 * nbytes == tc.wire_bits_per_client(sizes)
    back = tc.unpack_wire(tp.wire, tw)
    for a, b in zip(back, tp[:3]):
        for k in MIXED:
            assert a[k].dtype == b[k].dtype
            assert_bitwise(a[k], b[k], k)


@pytest.mark.parametrize("scope", ["per_tensor", "global"])
def test_mixed_tree_fairness_top_matches_jax(monkeypatch, scope):
    """``fairness_top`` on the mixed tree, kernel backend: its float32
    scores take the selection passes, then the fused apply beside each
    leaf's own streams (no dtype bail to the composed masks).  Two
    rounds with error feedback: the sparse triple and the residual
    bitwise JAX's, the diagnostics within float32 summation order."""
    from repro.core.compressors import Deltas as JDeltas
    from repro.core.compressors.topk import SharedTopKCompressor as JShared
    from repro_torch.core.compressors import Deltas
    monkeypatch.setenv("REPRO_SPARSIFY_BACKEND", "kernel")
    monkeypatch.setenv(S.SPARSIFY_BACKEND_ENV, "kernel")
    (jw, tw), (jm, tm_), (jv, tv) = (_both(t) for t in _mixed_deltas(8))
    kw = dict(rule="fairness_top", alpha=ALPHA, mask_scope=scope,
              exact_topk=False, error_feedback=True)
    jc, tc = JShared(**kw), SharedTopKCompressor(**kw)
    assert tc._fused_compress(tw, tm_, tv, True) is not None
    jst, tst = jc.init_state(jw), tc.init_state(tw)
    for _ in range(2):                  # round 2 consumes the residual
        jp, jst, jbits = jc.compress(JDeltas(jw, jm, jv), jst)
        tp, tst, tbits = tc.compress(Deltas(tw, tm_, tv), tst)
        assert tbits == jbits
        for k in MIXED:
            assert_bitwise(tst["err"][k], jst["err"][k], f"err[{k}]")
            for a, b in zip(tp[:3], jp[:3]):
                assert a[k].dtype == getattr(torch, MIXED[k][1])
                assert_bitwise(a[k], b[k], k)
        for name in tp.diag:
            np.testing.assert_allclose(float(tp.diag[name]),
                                       float(jp.diag[name]), rtol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("scope", ["per_tensor", "global"])
def test_mixed_tree_fedadam_top_matches_jax(monkeypatch, scope):
    """FedAdam-Top on the mixed tree: the packed layout does not take it,
    so each delta gets its own threshold masks per leaf (topk_mask: the
    selection passes and apply_mask).  Two rounds with error feedback on
    the kernel backend: sparse triple, residual and the three-bitmap wire
    payload bitwise against the JAX package's; the diagnostics within
    float32 summation order (rtol 1e-5)."""
    from repro.core.compressors import Deltas as JDeltas
    from repro.core.compressors.topk import (
        IndependentTopKCompressor as JIndependent)
    from repro_torch.core.compressors import Deltas
    monkeypatch.setenv("REPRO_SPARSIFY_BACKEND", "kernel")
    monkeypatch.setenv(S.SPARSIFY_BACKEND_ENV, "kernel")
    (jw, tw), (jm, tm_), (jv, tv) = (_both(t) for t in _mixed_deltas(7))
    kw = dict(alpha=ALPHA, mask_scope=scope, exact_topk=False,
              error_feedback=True)
    jc, tc = JIndependent(**kw), IndependentTopKCompressor(**kw)
    assert tc._fused_compress(tw, tm_, tv, True) is None
    jst, tst = jc.init_state(jw), tc.init_state(tw)
    for _ in range(2):                  # round 2 consumes the residual
        jp, jst, jbits = jc.compress(JDeltas(jw, jm, jv), jst)
        tp, tst, tbits = tc.compress(Deltas(tw, tm_, tv), tst)
        assert tbits == jbits
        for k in MIXED:
            assert_bitwise(tst["err"][k], jst["err"][k], f"err[{k}]")
            for a, b in zip(tp[:3], jp[:3]):
                assert a[k].dtype == getattr(torch, MIXED[k][1])
                assert_bitwise(a[k], b[k], k)
        for name in tp.diag:
            np.testing.assert_allclose(float(tp.diag[name]),
                                       float(jp.diag[name]), rtol=1e-5,
                                       err_msg=name)
        assert len(tp.wire.words) == len(tp.wire.values) == 3
        for i in range(3):
            assert_bitwise(tp.wire.words[i], jp.wire.words[i], f"words {i}")
            assert_bitwise(tp.wire.values[i], jp.wire.values[i],
                           f"values {i}")
    sizes = tuple(int(np.prod(s)) for s, _ in
                  (MIXED[k] for k in sorted(MIXED)))
    nbytes = W.payload_nbytes(tp.wire)
    assert nbytes == JW.payload_nbytes(jp.wire)
    assert 8 * nbytes == tc.wire_bits_per_client(sizes)
    for a, b in zip(tc.unpack_wire(tp.wire, tw), tp[:3]):
        for k in MIXED:
            assert_bitwise(a[k], b[k], k)
