"""Top-k compressors: FedAdam-SSM, its mask-rule baselines and FedAdam-Top.

Counterpart of ``repro/core/compressors/topk.py``.
``SharedTopKCompressor`` applies ONE boolean mask (rule ``ssm_w``:
Top_k(|dW|), Eq. 28) to all three deltas; ``IndependentTopKCompressor``
(FedAdam-Top, the paper's baseline) gives each delta its own Top_k mask.
Both carry an optional error-feedback residual on dW across rounds.

Hot path: with threshold masks (``exact_topk=False``) and the kernel
backend (auto for CUDA tensors), ``compress`` runs the packed pipeline of
``core/sparsify`` (``tree_shared_compress_packed`` /
``tree_independent_compress_packed``) on a uniform-dtype tree, and on a
mixed-dtype one the per-leaf kernels (the fused compress, or FedAdam-Top's
threshold masks); the wire payload packs its bitmaps with the ``wirepack``
kernel.

On a model axis or FSDP axes (``split``, a ``sparsify.LeafSplit`` that
the spatial and the virtual clients' rounds set) each leaf is this rank's
shard: the masks keep the whole leaf's per-tensor threshold, always per
leaf, and the diagnostics' norms are the whole tree's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import tree as T
from repro_torch.core import comm, masks, wire
from repro_torch.core import sparsify as S
from repro_torch.core.compressors.base import (
    Compressor, Deltas, Packed, register, tree_add, tree_size, tree_sub)

_VALUE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _cast_values(value_dtype, tree):
    """Beyond-paper low-precision value transport (cast + cast back)."""
    if value_dtype is None:
        return tree
    dt = _VALUE_DTYPES[value_dtype]
    return T.tree_map(lambda x: x.to(dt).to(x.dtype), tree)


@dataclasses.dataclass(frozen=True)
class _TopKBase(Compressor):
    alpha: float = 0.05
    mask_scope: str = "per_tensor"        # per_tensor | global
    exact_topk: bool = True
    error_feedback: bool = False
    value_dtype: Optional[str] = None
    q_bits: int = 32
    sparsify_backend: str = "auto"        # auto | kernel | reference
    split: Optional[S.LeafSplit] = None   # leaves split over a model axis

    def init_state(self, params):
        if not self.error_feedback:
            return None
        return {"err": T.tree_map(torch.zeros_like, params)}

    def _masks(self, dW, dM, dV):
        raise NotImplementedError

    def _kernel_path(self, device=None) -> bool:
        return (not self.exact_topk) and \
            S.use_kernel_path(self.sparsify_backend, device)

    def _fused_compress(self, dW, dM, dV, with_residual):
        return None

    def _wire_ok(self) -> bool:
        # wire value streams ship as float32: exact only at q = 32
        return self.q_bits == wire.VALUE_BITS

    def _mask_capacity(self, sizes) -> int:
        return wire.mask_value_capacity(sizes, self.alpha,
                                        self.mask_scope, self.exact_topk)

    def _pack_wire(self, sW, sM, sV, sizes):
        raise NotImplementedError

    def compress(self, deltas: Deltas, state, *, emit_wire: bool = True):
        dW, dM, dV = deltas
        if state is not None:
            dW = tree_add(dW, state["err"])
        device = T.leaves(dW)[0].device
        fused = self._fused_compress(dW, dM, dV, state is not None) \
            if self._kernel_path(device) else None
        if fused is not None:
            # independent compressors return a (mW, mM, mV) tuple, shared
            # ones one mask for all three
            sW, sM, sV, err, m = fused
            mW, mM, mV = m if isinstance(m, tuple) else (m, m, m)
            new_state = {"err": err} if state is not None else None
        else:
            mW, mM, mV = self._masks(dW, dM, dV)
            sW = _cast_values(self.value_dtype, S.tree_sparsify(dW, mW))
            sM = _cast_values(self.value_dtype, S.tree_sparsify(dM, mM))
            sV = _cast_values(self.value_dtype, S.tree_sparsify(dV, mV))
            new_state = {"err": tree_sub(dW, sW)} \
                if state is not None else None
        sp = self.split
        diag = {
            "err_w": S.tree_sparsity_error(dW, mW, sp),
            "err_m": S.tree_sparsity_error(dM, mM, sp),
            "err_v": S.tree_sparsity_error(dV, mV, sp),
            "norm_dw": S.tree_norm(dW, sp),
            "norm_dm": S.tree_norm(dM, sp),
            "norm_dv": S.tree_norm(dV, sp),
        }
        packed = Packed(sW, sM, sV, diag,
                        self.pack_wire(Deltas(sW, sM, sV)) if emit_wire
                        else None)
        d = tree_size(deltas.W) if sp is None else sum(sp.sizes(deltas.W))
        return packed, new_state, self.bits_per_client(d)

    def pack_wire(self, carriers: Deltas):
        if not self._wire_ok():
            return None
        sizes = tuple(x.numel() for x in T.leaves(carriers.W))
        return self._pack_wire(carriers.W, carriers.M, carriers.V, sizes)


@dataclasses.dataclass(frozen=True)
class SharedTopKCompressor(_TopKBase):
    """One shared mask for all three tensors (FedAdam-SSM family)."""

    name: str = "fedadam_ssm"
    rule: str = "ssm_w"                   # ssm_w | ssm_m | ssm_v | fairness_top

    transport = "shared_sparse"
    wire_layout = "mask_shared"

    def _masks(self, dW, dM, dV):
        m = masks.shared_mask(self.rule, dW, dM, dV, self.alpha,
                              self.mask_scope, self.exact_topk,
                              backend=self.sparsify_backend,
                              split=self.split)
        return m, m, m

    def _fused_compress(self, dW, dM, dV, with_residual):
        score = masks.shared_score_tree(self.rule, dW, dM, dV)
        return S.tree_shared_compress_fused(
            score, dW, dM, dV, self.alpha, self.mask_scope,
            value_dtype=self.value_dtype, with_residual=with_residual,
            split=self.split)

    def _pack_wire(self, sW, sM, sV, sizes):
        return wire.pack_shared_mask(sW, sM, sV, self._mask_capacity(sizes))

    def unpack_wire(self, payload, like) -> Deltas:
        return Deltas(*wire.unpack_shared_mask(payload, like))

    def bits_per_client(self, d: int) -> int:
        return comm.bits_fedadam_ssm(d, S.k_for(d, self.alpha), 1,
                                     self.q_bits)

    def wire_bits_per_client(self, sizes):
        if not self._wire_ok():
            return None
        return wire.mask_wire_bits(sizes, self.alpha, self.mask_scope,
                                   self.exact_topk, shared=True)


@dataclasses.dataclass(frozen=True)
class IndependentTopKCompressor(_TopKBase):
    """Three independent Top_k masks (FedAdam-Top)."""

    name: str = "fedadam_top"

    transport = "independent_sparse"
    wire_layout = "mask_independent"

    def _masks(self, dW, dM, dV):
        return masks.independent_masks(dW, dM, dV, self.alpha,
                                       self.mask_scope, self.exact_topk,
                                       backend=self.sparsify_backend,
                                       split=self.split)

    def _fused_compress(self, dW, dM, dV, with_residual):
        # mixed dtypes defeat the packed layout, and split leaves need
        # their counts reduced between the passes: compress() then takes
        # the per-leaf threshold masks of _masks
        if self.split is not None or not S._uniform_dtype(dW, dM, dV):
            return None
        return S.tree_independent_compress_packed(
            dW, dM, dV, self.alpha, self.mask_scope,
            value_dtype=self.value_dtype, with_residual=with_residual)

    def _pack_wire(self, sW, sM, sV, sizes):
        return wire.pack_independent_mask(sW, sM, sV,
                                          self._mask_capacity(sizes))

    def unpack_wire(self, payload, like) -> Deltas:
        return Deltas(*wire.unpack_independent_mask(payload, like))

    def bits_per_client(self, d: int) -> int:
        return comm.bits_fedadam_top(d, S.k_for(d, self.alpha), 1,
                                     self.q_bits)

    def wire_bits_per_client(self, sizes):
        if not self._wire_ok():
            return None
        return wire.mask_wire_bits(sizes, self.alpha, self.mask_scope,
                                   self.exact_topk, shared=False)


def _shared_factory(rule):
    def factory(fed) -> SharedTopKCompressor:
        return SharedTopKCompressor(
            name=fed.algorithm, rule=rule, alpha=fed.alpha,
            mask_scope=fed.mask_scope, exact_topk=fed.exact_topk,
            error_feedback=fed.error_feedback, value_dtype=fed.value_dtype,
            q_bits=fed.q_bits, sparsify_backend=fed.sparsify_backend)
    return factory


register("fedadam_ssm")(_shared_factory("ssm_w"))
register("ssm_m")(_shared_factory("ssm_m"))
register("ssm_v")(_shared_factory("ssm_v"))
register("fairness_top")(_shared_factory("fairness_top"))


@register("fedadam_top")
def _fedadam_top(fed) -> IndependentTopKCompressor:
    return IndependentTopKCompressor(
        name="fedadam_top", alpha=fed.alpha, mask_scope=fed.mask_scope,
        exact_topk=fed.exact_topk, error_feedback=fed.error_feedback,
        value_dtype=fed.value_dtype, q_bits=fed.q_bits,
        sparsify_backend=fed.sparsify_backend)
