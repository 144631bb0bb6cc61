"""Roofline model of one device's step: three terms on the H100.

    compute    = FLOPs / peak of the step's dtype
    memory     = bytes read and written / HBM bandwidth
    collective = sum over process groups of the group's bytes / its link

Counterpart of ``repro/roofline.py``.  The JAX module reads the whole
program's FLOPs and bytes from XLA's ``cost_analysis`` and divides them by
the chip count, and parses the collectives out of the optimized HLO.  The
port counts one rank's step where it runs (``launch/dryrun.py``):
``FlopCounterMode``'s FLOPs, the bytes of every device operation, and the
bytes of every collective, by process group, where ``launch/mesh.py``
moves them.  Under SPMD every rank does the same work, so these are the
per-device terms the JAX rows give.  The HLO parsing is not ported.

The link of a group is decided by its span: a group whose ranks all lie
in one node of :data:`NODE_CARDS` cards (rank // NODE_CARDS equal) moves
over NVLink, any other over InfiniBand (:func:`group_rate`).  That is the
data sheet's rate for each, not a measurement: a fake world moves
nothing.

The byte models of the compression hot path and
:func:`analytic_model_flops` are the JAX module's, copied.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM5 80GB (the H100 Tensor Core GPU data sheet), per card.
#: HBM3 bandwidth, bytes/s.
HBM_BW = 3.35e12
#: Dense tensor-core peaks (no structured sparsity), FLOP/s.
BF16_FLOPS = 989e12
#: float32 outside the tensor cores: the port multiplies float32 without
#: TF32 (``device.exact_float32``).
F32_FLOPS = 67e12
#: Peak FLOP/s by the step's dtype.
PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS,
              "float32": F32_FLOPS}
#: NVLink 4 (900 GB/s bidirectional per card): bytes/s per direction
#: between the cards of one node.
NVLINK_BW = 450e9
#: Cards per NVLink node (an HGX H100 8-GPU board).
NODE_CARDS = 8
#: InfiniBand NDR, 400 Gb/s, one adapter per card (DGX H100): bytes/s per
#: direction across nodes.
IB_BW = 50e9

# ---------------------------------------------------------------------------
# Analytic HBM byte models of the compression hot path (JAX's, copied).
# ``n`` is elements, ``itemsize`` the carrier width (4 = f32 wire).
# ---------------------------------------------------------------------------

#: Bisection iterations of core/sparsify.topk_mask_threshold (reference).
BISECT_ITERS = 24


def selection_bytes(n: int, itemsize: int = 4) -> int:
    """Per-leaf 3-pass streaming tau selection (kernels/topk_mask):
    absmax + two count passes, each ONE read of x."""
    return 3 * n * itemsize


def fused_apply_bytes(n: int, itemsize: int = 4) -> int:
    """Fused ssm_apply_ef: read dW/dM/dV once, write sW/sM/sV + residual
    (4th output) once — 3 reads + 4 writes."""
    return 7 * n * itemsize


def packed_select_bytes(n: int, itemsize: int = 4) -> int:
    """Packed cohort selection (kernels/packed_topk): the absmax
    reduction (1 read) + the segmented-histogram launch (1 read); the
    refine counts ride in the apply launch, so selection's own traffic
    drops from 3 passes to 2."""
    return 2 * n * itemsize


def packed_apply_bytes(n: int, itemsize: int = 4) -> int:
    """Packed two-sweep apply launch: sweep 0 re-reads the score stream
    for the refine counts (1 read), sweep 1 streams dW/dM/dV (3 reads)
    and writes sW/sM/sV + residual (4 writes)."""
    return 8 * n * itemsize


def composed_compress_bytes(n: int, itemsize: int = 4,
                            bisect_iters: int = BISECT_ITERS) -> int:
    """Reference threshold compress: absmax + ``bisect_iters`` bisection
    count passes (1 read each), 3 mask-apply rounds (read + write), EF
    residual subtract (2 reads + 1 write)."""
    return (1 + bisect_iters + 6 + 3) * n * itemsize


def fused_compress_bytes(n: int, itemsize: int = 4) -> int:
    """Per-leaf kernel pipeline end to end: 3-pass selection + one fused
    apply/cast/residual pass."""
    return selection_bytes(n, itemsize) + fused_apply_bytes(n, itemsize)


def packed_compress_bytes(n: int, itemsize: int = 4) -> int:
    """Packed pipeline end to end (2 launches): histogram selection +
    two-sweep apply.  Deliberately the SAME 10n total as
    :func:`fused_compress_bytes` — the packed win is launch count
    (2 per cohort vs 4 per leaf) and pass fusion, not HBM traffic."""
    return packed_select_bytes(n, itemsize) + packed_apply_bytes(n, itemsize)


def group_rate(ranks: Sequence[int]) -> float:
    """Bytes/s of a group's link: NVLink if every rank of ``ranks`` lies
    in one node of :data:`NODE_CARDS` cards, InfiniBand otherwise."""
    return NVLINK_BW if len({r // NODE_CARDS for r in ranks}) <= 1 \
        else IB_BW


@dataclasses.dataclass
class Roofline:
    """One rank's step: ``flops`` and ``mem_bytes`` as counted on it,
    ``coll_groups`` each process group's bytes and global ranks,
    ``model_flops`` the analytic whole-program count
    (:func:`analytic_model_flops`), ``dtype`` the step's (its peak)."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float
    mem_bytes: float
    coll_groups: Dict[str, Tuple[float, Tuple[int, ...]]]
    model_flops: float
    dtype: str = "bfloat16"

    @property
    def coll_bytes(self) -> float:
        return float(sum(b for b, _ in self.coll_groups.values()))

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS[self.dtype]

    @property
    def t_memory(self) -> float:
        return self.mem_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return sum(b / group_rate(ranks)
                   for b, ranks in self.coll_groups.values())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """The analytic model FLOPs over every rank's counted FLOPs."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def row(self) -> Dict:
        return dict(
            arch=self.arch, shape=self.shape, mesh=self.mesh,
            chips=self.chips, dtype=self.dtype,
            flops=self.flops, mem_bytes=self.mem_bytes,
            coll_bytes=self.coll_bytes, model_flops=self.model_flops,
            coll_links={g: "nvlink" if group_rate(r) == NVLINK_BW
                        else "infiniband"
                        for g, (_, r) in self.coll_groups.items()},
            t_compute=self.t_compute, t_memory=self.t_memory,
            t_collective=self.t_collective, bottleneck=self.bottleneck,
            useful_ratio=self.useful_ratio,
        )


def analytic_model_flops(cfg, shape_kind: str, seq_len: int,
                         global_batch: int, local_epochs: int = 1,
                         n_virtual_clients: int = 1) -> float:
    """6*N_active*tokens for a train round (fwd+bwd over L epochs and
    virtual clients), 2*N_active per generated token for decode."""
    n_active = cfg.active_param_count()
    if shape_kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n_active * tokens * local_epochs * n_virtual_clients
    if shape_kind == "prefill":
        return 2.0 * n_active * seq_len * global_batch
    # decode: one token per sequence in the batch
    return 2.0 * n_active * global_batch
