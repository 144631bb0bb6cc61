"""Gemma-3 27B — dense, 5:1 local:global attention interleave, 128k context.
[hf:google/gemma-3-1b-pt family card, scaled per assignment]

Assigned spec: 62L, d_model=5376, 32 heads (GQA kv=16), d_ff=21504,
vocab=262144.  Pattern: 5 sliding-window (1024) layers per 1 global layer.
62 = 31 × 2: we express the pattern as 31 specs (5×[local,]+[global]
repeated 5 times, + 1 trailing local) repeated twice.
A copy of ``repro/configs/gemma3_27b.py``.
"""
from repro_torch.configs.base import ArchConfig, AttentionSpec, LayerSpec, register

_LOCAL = AttentionSpec(num_heads=32, num_kv_heads=16, head_dim=128,
                       window=1024, rope_theta=10000.0)
_GLOBAL = AttentionSpec(num_heads=32, num_kv_heads=16, head_dim=128,
                        rope_theta=1_000_000.0)


@register
def config() -> ArchConfig:
    d_ff = 21504
    local = LayerSpec(kind="attn", attention=_LOCAL, d_ff=d_ff)
    glob = LayerSpec(kind="attn", attention=_GLOBAL, d_ff=d_ff)
    pattern = (([local] * 5 + [glob]) * 5 + [local])
    return ArchConfig(
        name="gemma3-27b",
        family="dense",
        d_model=5376,
        vocab_size=262144,
        layer_pattern=tuple(pattern),
        pattern_repeats=2,
        tie_embeddings=True,
        max_seq_len=131072,
        source="hf:google/gemma-3 family",
        # global layers fall back to split-KV for long_500k; local layers
        # already windowed → long-decode supported via window on globals
        long_context_window=4096,
        long_strategy="mixed",
    )
