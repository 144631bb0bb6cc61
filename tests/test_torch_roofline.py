"""The port's roofline (``repro_torch/roofline.py``) and the dry run's
abstract trees against the JAX package on the CPU.

* The byte models of the compress path and ``BISECT_ITERS`` equal
  ``repro.roofline``'s (which imports no jax) on a grid of sizes and
  carrier widths; ``analytic_model_flops``, ``param_count`` and
  ``active_param_count`` equal JAX's for every assigned arch and shape
  kind, and ``steps.skip_reason`` JAX's for every arch and shape.
* ``Roofline``'s terms and bottleneck under the H100's constants, as
  ``tests/test_roofline.py`` holds the JAX ones, and the link of a group
  by its span (NVLink inside an 8-card node, InfiniBand across).
* On the production mesh (data 16, model 16), rank 0's fake parameter
  shards (``models/params.abstract_shards``) hold exactly the bytes of
  JAX's shards under ``repro.models.params.pspecs`` for every arch, by
  both rule sets, and allocate nothing.
"""
import math

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

import _torch_parity  # noqa: F401  (one torch thread)
from repro import roofline as JRL
from repro.configs import get_config as jget_config
from repro.launch import steps as JST
from repro.models import model as JM
from repro.models import params as JP
from repro_torch import roofline as RL
from repro_torch import sharding as shd
from repro_torch import tree as T
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import mesh as MM
from repro_torch.launch import steps as ST
from repro_torch.models import model as TM
from repro_torch.models import params as PM

BYTE_MODELS = ("selection_bytes", "fused_apply_bytes", "packed_select_bytes",
               "packed_apply_bytes", "composed_compress_bytes",
               "fused_compress_bytes", "packed_compress_bytes")
SIZES = (0, 1, 2, 1023, 8192, 2 ** 20 + 3, 2 ** 31)


def test_assigned_archs_are_jax_order():
    from repro.configs import ASSIGNED_ARCHS as JARCHS
    assert ASSIGNED_ARCHS == JARCHS


@pytest.mark.parametrize("name", BYTE_MODELS)
def test_byte_models_equal_jax(name):
    assert RL.BISECT_ITERS == JRL.BISECT_ITERS
    ours, theirs = getattr(RL, name), getattr(JRL, name)
    for n in SIZES:
        for itemsize in (1, 2, 4):
            assert ours(n, itemsize) == theirs(n, itemsize), (n, itemsize)
        assert ours(n) == theirs(n)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_counts_and_skips_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for kind in ("train", "prefill", "decode"):
        for epochs, virtual in ((1, 1), (2, 2)):
            args = (kind, 4096, 256, epochs, virtual)
            assert RL.analytic_model_flops(cfg, *args) == \
                JRL.analytic_model_flops(jcfg, *args), args
    for shape_name, shape in ST.SHAPES.items():
        assert ST.skip_reason(cfg, shape) == \
            JST.skip_reason(jcfg, JST.SHAPES[shape_name]), shape_name


def test_roofline_terms_and_bottleneck():
    """One rank's terms: 1 s of bf16 compute, 2 s of HBM, 0.5 s over a
    16-rank group that spans two nodes (InfiniBand)."""
    ranks = tuple(range(16))
    rl = RL.Roofline(arch="a", shape="s", mesh="m", chips=256,
                     flops=RL.BF16_FLOPS, mem_bytes=2 * RL.HBM_BW,
                     coll_groups={"model": (0.5 * RL.IB_BW, ranks)},
                     model_flops=128 * RL.BF16_FLOPS, dtype="bfloat16")
    assert abs(rl.t_compute - 1.0) < 1e-9
    assert abs(rl.t_memory - 2.0) < 1e-9
    assert abs(rl.t_collective - 0.5) < 1e-9
    assert rl.bottleneck == "memory"
    assert abs(rl.useful_ratio - 0.5) < 1e-9
    row = rl.row()
    assert row["bottleneck"] == "memory"
    assert row["coll_links"] == {"model": "infiniband"}
    f32 = RL.Roofline("a", "s", "m", 1, RL.F32_FLOPS, 0.0, {}, 0.0,
                      dtype="float32")
    assert abs(f32.t_compute - 1.0) < 1e-9 and f32.bottleneck == "compute"


def test_group_link_by_span():
    """NVLink for a group inside one 8-card node, InfiniBand for any
    group that spans two; the terms add over groups."""
    assert RL.group_rate(range(8)) == RL.NVLINK_BW
    assert RL.group_rate((8, 9, 15)) == RL.NVLINK_BW
    assert RL.group_rate((7, 8)) == RL.IB_BW
    assert RL.group_rate(range(0, 256, 16)) == RL.IB_BW
    rl = RL.Roofline("a", "s", "m", 16, 0.0, 0.0, {
        "model": (RL.NVLINK_BW, (0, 1, 2, 3)),
        "data": (3 * RL.IB_BW, (0, 4, 8, 12))}, 0.0)
    assert abs(rl.t_collective - 4.0) < 1e-9
    assert rl.bottleneck == "collective"
    assert rl.coll_bytes == RL.NVLINK_BW + 3 * RL.IB_BW
    assert (RL.HBM_BW, RL.F32_FLOPS, RL.BF16_FLOPS) == (3.35e12, 67e12,
                                                        989e12)


class _Shape:
    """A mesh stand-in for JAX's ``pspecs``: its ``shape`` alone."""

    def __init__(self, shape):
        self.shape = shape


def _jax_shard_bytes(jcfg, rules, shape) -> int:
    """Rank 0's bytes of JAX's shards: each dim over the product of its
    spec entry's axes."""
    import jax
    from jax.sharding import PartitionSpec
    specs = JP.pspecs(JM.abstract_params(jcfg), rules, _Shape(shape))
    sds = JP.abstract(JM.abstract_params(jcfg), jcfg.dtype)
    total = 0
    for sp, sd in zip(jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, PartitionSpec)),
            jax.tree_util.tree_leaves(sds)):
        dims = list(sd.shape)
        for d, e in enumerate(tuple(sp) + (None,) * (len(dims) - len(sp))):
            for a in (() if e is None else (e,) if isinstance(e, str)
                      else e):
                dims[d] //= shape[a]
        total += math.prod(dims) * sd.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_fake_shards_hold_jax_shard_bytes(arch):
    shape = MM.make_production_mesh()
    mesh = MM.ClientMesh(shape=shape, client_axes=(), rank=0,
                         device=torch.device("cpu"))
    cfg, jcfg = get_config(arch), jget_config(arch)
    meta = TM.abstract_params(cfg)
    mode = FakeTensorMode()
    for kind in ("tp", "fsdp"):
        rules = shd.param_rules(kind, False)
        shards = PM.abstract_shards(meta, PM.pspecs(meta, rules, mesh),
                                    mesh, cfg.dtype, mode=mode,
                                    device="cpu")
        leaves = T.leaves(shards)
        assert all(isinstance(x, FakeTensor) for x in leaves)
        got = sum(x.numel() * x.element_size() for x in leaves)
        assert got == _jax_shard_bytes(jcfg, rules, shape), (arch, kind)
    whole = TM.abstract_params_sds(cfg, mode=mode, device="cpu")
    assert all(isinstance(x, FakeTensor) for x in T.leaves(whole))
    assert sum(x.numel() for x in T.leaves(whole)) == PM.count_params(meta)
