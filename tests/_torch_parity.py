"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
comparisons look at the bits (float32 and uint32 viewed as int32)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

# The port's CPU tests run on one torch thread: the suite's workers share
# the machine's cores, and PyTorch's default of a thread per core in each
# of them oversubscribes it (every port test file imports this module,
# and so does each worker's collection).
torch.set_num_threads(1)


def rand_leaves(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def np_tree(seed, shapes, scale=1.0, absval=False):
    leaves = rand_leaves(seed, shapes, scale)
    if absval:
        leaves = [np.abs(x) for x in leaves]
    return {f"l{i}": x for i, x in enumerate(leaves)}


def to_torch(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def to_jax(tree):
    import jax.numpy as jnp
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_jax(v) for v in tree)
    return jnp.asarray(tree)


def bits(x) -> np.ndarray:
    """The raw bits of a float32/int32/uint32/bfloat16/bool array or
    tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        elif x.dtype in (torch.bfloat16, torch.float16):
            x = x.view(torch.int16)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype == np.bool_:
        return x
    if x.itemsize == 2:
        return x.view(np.int16)
    return x.view(np.int32) if x.itemsize == 4 else x


# bfloat16 crosses between the packages as its uint16 bit pattern, so both
# sides hold the same values (numpy has no bfloat16 of its own; JAX's is
# the ml_dtypes type).


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> the uint16 bits of its bfloat16 rounding (nearest even)."""
    import jax.numpy as jnp
    return np.asarray(x, np.float32).astype(jnp.bfloat16).view(np.uint16)


def as_dtype(x: np.ndarray, dtype: str) -> np.ndarray:
    """float32 data in the working dtype's numpy form: float32 as is,
    bfloat16 as its uint16 bits."""
    return bf16_bits(x) if dtype == "bfloat16" else np.asarray(x, np.float32)


def np_bits_tree(tree):
    """A JAX tree as numpy leaves, bfloat16 leaves as uint16 bit views."""
    import jax
    return jax.tree.map(
        lambda x: np.asarray(x).view(np.uint16) if x.dtype.itemsize == 2
        else np.asarray(x), tree)


def np_model_params(jcfg, tcfg, seed=0):
    """A zoo model's parameters in both packages from one numpy seed, by
    the JAX package's init rules (zeros, ones, N(0, 1/fan_in), N(0,
    0.02²)) and leaf dtypes: no JAX random draw to compile per leaf
    shape.  Returns (JAX tree, the port's tree on the CPU)."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro.models.params import is_meta
    from repro_torch.models import model as TM
    rng = np.random.default_rng(seed)

    def draw(p):
        dtype = jnp.dtype(p.dtype or jcfg.dtype)
        if p.init in ("zeros", "ones"):
            return jnp.full(p.shape, p.init == "ones", dtype)
        fan_in = p.fan_in or (p.shape[-2] if len(p.shape) >= 2
                              else p.shape[-1])
        std = 1.0 / np.sqrt(max(1, fan_in)) if p.init == "scaled" else 0.02
        x = (rng.standard_normal(p.shape) * std).astype(np.float32)
        return jnp.asarray(x).astype(dtype)

    jp = jax.tree.map(draw, JM.abstract_params(jcfg), is_leaf=is_meta)
    return jp, TM.params_from_jax(np_bits_tree(jp), tcfg, "cpu")


def leaf_to_torch(x: np.ndarray, device="cpu") -> torch.Tensor:
    """A numpy leaf as a tensor; uint16 is taken as bfloat16 bits."""
    x = np.asarray(x)
    if x.dtype == np.uint16:
        return torch.from_numpy(x.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(x.copy()).to(device)


def leaf_to_jax(x: np.ndarray):
    """A numpy leaf as a JAX array; uint16 is taken as bfloat16 bits."""
    import jax.numpy as jnp
    x = np.asarray(x)
    return jnp.asarray(x.view(jnp.bfloat16) if x.dtype == np.uint16 else x)


def assert_bitwise(a, b, what=""):
    ba, bb = bits(a), bits(b)
    assert ba.shape == bb.shape, f"{what}: shape {ba.shape} vs {bb.shape}"
    diff = int(np.sum(ba != bb))
    assert diff == 0, f"{what}: {diff} of {ba.size} elements differ"


def assert_tree_bitwise(a, b, what=""):
    assert sorted(a) == sorted(b), f"{what}: keys differ"
    for k in a:
        assert_bitwise(a[k], b[k], f"{what}[{k}]")


@pytest.fixture
def cuda_device():
    """The CUDA device for tests marked ``cuda``; skips (inside the test,
    never at collection) where no card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest "
                    "-m cuda tests/test_torch_cuda.py` on a machine with one")
    return torch.device("cuda")


@pytest.fixture
def jax_packed_oracles(monkeypatch):
    """Route the JAX package's packed kernel backend through its jnp
    oracles.  ``packed_hist_2d``/``packed_apply_2d`` call ``pl.load``/
    ``pl.store``, which the installed jax no longer has, so they cannot
    run in interpret mode here; ``packed_hist_ref``/``packed_apply_ef_ref``
    (and its single-stream form ``packed_mask_apply_ref``, FedAdam-Top's)
    replay the kernels' block order exactly (the JAX package's own parity
    tests hold them bitwise equal)."""
    import repro.core.sparsify as JS
    from repro.kernels.packed_topk import ref as jpref

    def apply_ef(taus2, seg_ids, ks, ns, dw, dm, dv, score=None, *,
                 with_residual=True, value_dtype=None):
        return jpref.packed_apply_ef_ref(
            taus2, seg_ids, ks, ns, (dw, dm, dv), score,
            with_residual=with_residual, value_dtype=value_dtype)

    monkeypatch.setattr(JS, "packed_hist_kernel", jpref.packed_hist_ref)
    monkeypatch.setattr(JS, "packed_apply_ef", apply_ef)
    monkeypatch.setattr(JS, "packed_mask_apply", jpref.packed_mask_apply_ref)


# ---------------------------------------------------------------------------
# Edge cases of the 32-candidate count (count_ge)
# ---------------------------------------------------------------------------

#: Names of :func:`count_edge_cases`, for ``parametrize``.
COUNT_CASES = ("log2", "equal", "zero", "nan_x", "nan_taus", "unsorted",
               "signed_zero", "subnormal_x", "subnormal_taus", "ties")

_TINY = float(np.finfo(np.float32).tiny)   # the smallest normal float32


def count_edge_cases(n: int, dtype: torch.dtype, seed: int = 0) -> dict:
    """name -> (taus, x, xla_exact): float32[32] candidates and a leaf of
    ``dtype`` (float32 or bfloat16), both on the CPU.  ``xla_exact`` is
    False where the candidates are subnormal: XLA (on the CPU, as on the
    TPU) flushes subnormal operands to zero, so there the JAX package's
    count is not the IEEE count that PyTorch and the card take."""
    from repro_torch.kernels.topk_mask.ref import linear_taus, log2_taus
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(n).astype(np.float32)
    leaf = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(dtype)
    x = leaf(base)
    a = x.float().abs()
    am = a.max()
    log2 = log2_taus(am)
    nan, inf = float("nan"), float("inf")

    x_nan = x.clone()
    x_nan[::97] = nan
    x_nan[5], x_nan[6] = inf, -inf
    t_nan = log2.clone()
    t_nan[5] = nan
    x_zero = x.clone()
    x_zero[::3], x_zero[1::3] = 0.0, -0.0
    t_zero = linear_taus(torch.tensor(0.0), am)
    t_zero[-2:] = torch.tensor([0.0, -0.0])
    # subnormal and small normal elements against normal candidates and 0
    x_sub = leaf(base * np.where(np.arange(n) % 2, 0.5, 8.0) * _TINY)
    t_sub = torch.tensor([_TINY * 2.0 ** ((31 - j) / 2) for j in range(31)]
                         + [0.0], dtype=torch.float32)
    # subnormal candidates (down to 0) over subnormal elements
    x_subt = leaf(base * 0.25 * _TINY)
    t_subt = log2_taus(x_subt.float().abs().max())
    # candidates drawn from the leaf's own values: elements tie with them
    vals = torch.unique(a)
    t_ties = vals[torch.linspace(0, vals.numel() - 1, 32).long()].flip(0)
    return {
        "log2": (log2, x, True),
        "equal": (torch.full((32,), float(a.median())), x, True),
        "zero": (torch.zeros(32), x, True),
        "nan_x": (log2, x_nan, True),
        "nan_taus": (t_nan, x, True),
        "unsorted": (log2[torch.from_numpy(rng.permutation(32))], x, True),
        "signed_zero": (t_zero, x_zero, True),
        "subnormal_x": (t_sub, x_sub, True),
        "subnormal_taus": (t_subt, x_subt, False),
        "ties": (t_ties.contiguous(), x, True),
    }


def taus_sorted(taus: torch.Tensor) -> bool:
    """Non-increasing and NaN-free: the count kernel's rank path."""
    return bool((taus == taus).all() and (taus[:-1] >= taus[1:]).all())


# ---------------------------------------------------------------------------
# The same edge cases as one packed cohort (packed_hist, packed_apply)
# ---------------------------------------------------------------------------


def packed_edge_cases(n: int = 5000):
    """One packed cohort on the CPU with a segment for each edge case of
    :func:`count_edge_cases` (its float32 leaf as the segment's data, its
    candidates as the segment's edges), a refine row on the log2 case's
    leaf, a single-element and an all-zero segment.  Returns ``(xp,
    seg_ids, edges, xla_exact)``, ``xla_exact`` a numpy bool per segment
    (False where XLA flushes the subnormal edges)."""
    from repro_torch.core import sparsify as S
    from repro_torch.kernels.packed_topk import ops as P
    from repro_torch.kernels.packed_topk.ref import refine_taus
    from repro_torch.kernels.topk_mask.ref import log2_taus
    cases = count_edge_cases(n, torch.float32)
    leaves, rows, exact = [], [], []
    for name in COUNT_CASES:
        taus, x, ok = cases[name]
        leaves.append(x)
        rows.append(taus)
        exact.append(ok)
    log2, x, _ = cases["log2"]
    xp1 = S.plan_packed_layout([x]).pack([x])
    c1 = P.packed_hist_plain(
        xp1, torch.zeros(xp1.shape[0] // 8, dtype=torch.int32), log2[None])
    k = torch.tensor([float(S.k_for(n, 0.05))])
    leaves.append(x)
    rows.append(refine_taus(c1, log2[None], x.abs().max()[None], k)[0])
    one, zero = torch.tensor([0.7]), torch.zeros(50)
    leaves += [one, zero]
    rows += [log2_taus(one.abs().max()), log2_taus(zero.abs().max())]
    exact += [True] * 3
    layout = S.plan_packed_layout(leaves)
    return (layout.pack(leaves), layout.seg_ids, torch.stack(rows),
            np.array(exact))


def shuffle_blocks(xp, seg_ids, seed):
    """The same (8, 128) blocks in a shuffled order: segments change at
    almost every block, and one segment's blocks fall into many chunks."""
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        seg_ids.numel())).to(xp.device)
    blocks = xp.reshape(-1, 1024)[perm]
    return blocks.reshape(-1, 128).contiguous(), seg_ids[perm].contiguous()


class ThreadGroup:
    """``n`` ranks of one process, each a thread, and their collectives
    (``launch.mesh.ModelGroup``'s ``all_reduce`` and ``all_gather``) by
    exchange through a barrier: the split-KV combine on one device, card
    or CPU, without a process group.  :meth:`run` calls ``fn(member)`` on
    every member at once."""

    def __init__(self, n: int):
        import threading
        self.n = n
        self._barrier = threading.Barrier(n, timeout=60)
        self._slots = [None] * n

    def run(self, fn):
        import threading
        out, errors = [None] * self.n, []

        def one(i):
            try:
                out[i] = fn(_ThreadMember(self, i))
            except BaseException as e:      # re-raised below
                errors.append(e)
                self._barrier.abort()

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


class _ThreadMember:
    def __init__(self, group: ThreadGroup, index: int):
        self._g, self.size, self.index = group, group.n, index

    def chunk(self, n: int):
        return (self.index * n) // self.size, \
            ((self.index + 1) * n) // self.size

    def _exchange(self, x):
        g = self._g
        g._slots[self.index] = x
        g._barrier.wait()
        vals = list(g._slots)
        g._barrier.wait()
        return vals

    def all_reduce(self, x, op: str = "sum"):
        vals = self._exchange(x)
        out = vals[0]
        for v in vals[1:]:
            out = out + v if op == "sum" else torch.maximum(out, v)
        return out.clone()

    def all_gather(self, x, dim: int):
        return torch.cat(self._exchange(x), dim=dim)
