"""Architecture config system.

A copy of ``repro/configs/base.py`` (plain dataclasses): the port imports
nothing of the JAX package.  Every architecture is an :class:`ArchConfig`,
a declarative description of a (possibly heterogeneous) decoder stack that
:mod:`repro_torch.models.model` turns into parameters and a forward
function.  Layer heterogeneity is a repeating ``layer_pattern`` of
:class:`LayerSpec` entries; parameters are stacked over pattern repeats.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Layer-level spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Self-attention flavour for one layer."""

    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: Optional[int] = None          # sliding-window size; None = full
    # DeepSeek-style Multi-head Latent Attention (low-rank joint KV).
    kv_lora_rank: Optional[int] = None
    q_lora_rank: Optional[int] = None
    causal: bool = True

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank is not None


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """Mixture-of-experts FFN flavour."""

    num_experts: int
    top_k: int
    d_ff: int                              # per-expert hidden width
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    """Mamba-2 (SSD) mixer flavour."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def num_heads(self, d_model: int) -> int:
        return (self.expand * d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer in the repeating pattern."""

    kind: str                              # "attn" | "ssm"
    attention: Optional[AttentionSpec] = None
    ssm: Optional[SSMSpec] = None
    # FFN: exactly one of d_ff (dense) / moe is set; both None => no FFN
    # (Mamba-2 blocks are mixer-only).
    d_ff: Optional[int] = None
    moe: Optional[MoESpec] = None
    gated_mlp: bool = True                 # SwiGLU (3 mats) vs GELU (2 mats)


# ---------------------------------------------------------------------------
# Architecture-level config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Optional encoder stack (Whisper).  Frontend is a stub: inputs are
    precomputed frame embeddings of shape (batch, src_len, d_model)."""

    num_layers: int
    num_heads: int
    src_len: int                          # fixed source length (1500 for whisper)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                            # dense|moe|ssm|hybrid|vlm|audio
    d_model: int
    vocab_size: int
    layer_pattern: Tuple[LayerSpec, ...]   # repeated pattern_repeats times
    pattern_repeats: int
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    encoder: Optional[EncoderSpec] = None  # enc-dec archs (whisper)
    # VLM/audio frontends are stubs: when True, the model consumes
    # precomputed embeddings for a prefix of the sequence.
    stub_frontend: bool = False
    stub_frontend_tokens: int = 0          # e.g. image patch tokens
    max_seq_len: int = 131072
    dtype: str = "bfloat16"
    # citation for the source of the numbers
    source: str = ""
    # set for archs whose *default* is full attention but which we also ship
    # as a sliding-window variant for long-context serving
    long_context_window: Optional[int] = None
    # long_500k strategy: "window_all" rings every full-attention layer at
    # long_context_window; "mixed" keeps native-window layers ringed but
    # serves no-window (global) layers with a full sequence-sharded cache
    # (split-KV decode).
    long_strategy: str = "window_all"

    # ------------------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return len(self.layer_pattern) * self.pattern_repeats

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding table
        shards evenly on any mesh axis (standard production padding; the
        analytic param_count stays source-faithful and unpadded)."""
        return -(-self.vocab_size // 256) * 256

    def supports_long_decode(self) -> bool:
        """True if a 500k-token decode is meaningful for this config:
        every attention layer must be windowed/MLA-free-running or the
        arch declares a long-context window variant, or it is SSM-only."""
        if self.encoder is not None:
            return False                  # whisper: decoder capped by design
        for spec in self.layer_pattern:
            if spec.kind == "attn":
                a = spec.attention
                if a.window is None and self.long_context_window is None:
                    return False
        return True

    # -- parameter counting (analytic; used by roofline + tests) -------
    def param_count(self) -> int:
        d = self.d_model
        total = self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                 # lm head
        for spec in self.layer_pattern:
            total += self._layer_params(spec) * self.pattern_repeats
        total += d                                       # final norm
        if self.encoder is not None:
            e = self.encoder
            # encoder self-attn + ffn (d_ff = 4d convention for whisper)
            enc_layer = 4 * d * d + 2 * d * (4 * d) + 4 * d
            total += e.num_layers * enc_layer + d
            # decoder cross-attention adds 4 d^2 per decoder layer,
            # counted in _layer_params via has-encoder flag handled here:
            total += self.num_layers * 4 * d * d
        return total

    def _layer_params(self, spec: LayerSpec) -> int:
        d = self.d_model
        n = 0
        if spec.kind == "attn":
            a = spec.attention
            if a.is_mla:
                if a.q_lora_rank:
                    n += d * a.q_lora_rank
                    n += a.q_lora_rank * a.num_heads * a.head_dim
                else:
                    n += d * a.num_heads * a.head_dim
                n += d * a.kv_lora_rank                       # kv down-proj
                n += a.kv_lora_rank * a.num_heads * 2 * a.head_dim  # up-proj
                n += a.num_heads * a.head_dim * d             # o
            else:
                n += d * a.num_heads * a.head_dim          # q
                n += 2 * d * a.num_kv_heads * a.head_dim   # k,v
                n += a.num_heads * a.head_dim * d          # o
            n += 2 * d                                     # norms
        elif spec.kind == "ssm":
            s = spec.ssm
            d_inner = s.expand * d
            nheads = s.num_heads(d)
            n += d * (2 * d_inner + 2 * s.d_state + nheads)   # in_proj (zxbcdt)
            n += s.d_conv * (d_inner + 2 * s.d_state)         # conv
            n += d_inner * d                                  # out_proj
            n += 3 * nheads + d_inner                         # A, D, dt_bias, norm-ish
            n += d                                            # pre-norm
        if spec.d_ff:
            mats = 3 if spec.gated_mlp else 2
            n += mats * d * spec.d_ff + d                     # mlp + norm
        if spec.moe:
            m = spec.moe
            n += d * m.num_experts                            # router
            n += m.num_experts * 3 * d * m.d_ff
            if m.num_shared_experts:
                n += m.num_shared_experts * 3 * d * m.shared_d_ff
            n += d
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE top-k routing)."""
        d = self.d_model
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for spec in self.layer_pattern:
            n = self._layer_params(spec)
            if spec.moe:
                m = spec.moe
                n -= m.num_experts * 3 * d * m.d_ff
                n += (m.top_k + m.num_shared_experts) * 3 * d * m.d_ff
            total += n * self.pattern_repeats
        return total


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY = {}


def register(fn):
    """Decorator: register a zero-arg config factory under its module name."""
    name = fn.__module__.rsplit(".", 1)[-1].replace("_", "-")
    _REGISTRY[name] = fn
    return fn


def get_config(name: str) -> ArchConfig:
    # configs register on import; import the package lazily to avoid cycles
    from repro_torch import configs as _pkg  # noqa: F401
    key = name.replace("_", "-")
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]()


def available_archs() -> Sequence[str]:
    from repro_torch import configs as _pkg  # noqa: F401
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Reduced ("smoke") variants: same family, tiny dims, runnable on CPU.
# ---------------------------------------------------------------------------


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """2 pattern repeats max, d_model<=256, <=4 experts, tiny vocab."""

    def shrink_layer(spec: LayerSpec) -> LayerSpec:
        attn = spec.attention
        if attn is not None:
            heads = min(4, attn.num_heads)
            kv = max(1, min(attn.num_kv_heads, heads))
            while heads % kv:
                kv -= 1
            attn = dataclasses.replace(
                attn,
                num_heads=heads,
                num_kv_heads=kv,
                head_dim=32,
                kv_lora_rank=32 if attn.kv_lora_rank else None,
                q_lora_rank=32 if attn.q_lora_rank else None,
                window=min(attn.window, 64) if attn.window else None,
            )
        ssm = spec.ssm
        if ssm is not None:
            ssm = dataclasses.replace(
                ssm, d_state=16, head_dim=32, chunk_size=32)
        moe = spec.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe,
                num_experts=min(4, moe.num_experts),
                top_k=min(2, moe.top_k),
                d_ff=128,
                num_shared_experts=min(1, moe.num_shared_experts),
                shared_d_ff=128 if moe.num_shared_experts else 0,
            )
        return LayerSpec(
            kind=spec.kind,
            attention=attn,
            ssm=ssm,
            d_ff=256 if spec.d_ff else None,
            moe=moe,
        )

    pattern = tuple(shrink_layer(s) for s in cfg.layer_pattern)
    # keep the pattern (it IS the family) but only repeat once/twice
    repeats = 1 if len(pattern) > 2 else min(2, cfg.pattern_repeats)
    enc = cfg.encoder
    if enc is not None:
        enc = EncoderSpec(num_layers=2, num_heads=4, src_len=64)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=128,
        vocab_size=512,
        layer_pattern=pattern,
        pattern_repeats=repeats,
        encoder=enc,
        stub_frontend_tokens=min(cfg.stub_frontend_tokens, 16),
        max_seq_len=512,
    )
