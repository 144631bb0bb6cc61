"""Mistral-Large-2 123B — dense GQA.
[hf:mistralai/Mistral-Large-Instruct-2407]

Assigned spec: 88L, d_model=12288, 96 heads (GQA kv=8), d_ff=28672,
vocab=32768.  head_dim=128.  Full attention by default; the Mistral lineage
sliding-window (4096) is exposed as the long-context variant.
A copy of ``repro/configs/mistral_large_123b.py``.
"""
from repro_torch.configs.base import ArchConfig, AttentionSpec, LayerSpec, register


@register
def config() -> ArchConfig:
    attn = AttentionSpec(num_heads=96, num_kv_heads=8, head_dim=128,
                         rope_theta=1_000_000.0)
    layer = LayerSpec(kind="attn", attention=attn, d_ff=28672)
    return ArchConfig(
        name="mistral-large-123b",
        family="dense",
        d_model=12288,
        vocab_size=32768,
        layer_pattern=(layer,),
        pattern_repeats=88,
        source="hf:mistralai/Mistral-Large-Instruct-2407",
        long_context_window=4096,
    )
