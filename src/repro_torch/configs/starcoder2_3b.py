"""StarCoder2-3B — dense GQA code model.  [arXiv:2402.19173]

Assigned spec: 30L, d_model=3072, 24 heads (GQA kv=2), d_ff=12288,
vocab=49152.  RoPE; window=4096 long-context variant as for the 7B.
A copy of ``repro/configs/starcoder2_3b.py``.
"""
from repro_torch.configs.base import ArchConfig, AttentionSpec, LayerSpec, register


@register
def config() -> ArchConfig:
    attn = AttentionSpec(num_heads=24, num_kv_heads=2, head_dim=128,
                         rope_theta=1_000_000.0)
    layer = LayerSpec(kind="attn", attention=attn, d_ff=12288, gated_mlp=False)
    return ArchConfig(
        name="starcoder2-3b",
        family="dense",
        d_model=3072,
        vocab_size=49152,
        layer_pattern=(layer,),
        pattern_repeats=30,
        source="arXiv:2402.19173 (StarCoder2)",
        long_context_window=4096,
    )
