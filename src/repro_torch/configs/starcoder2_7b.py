"""StarCoder2-7B — dense GQA code model.  [arXiv:2402.19173]

Assigned spec: 32L, d_model=4608, 36 heads (GQA kv=4), d_ff=18432,
vocab=49152.  RoPE.  The released family trains with a 4k sliding window —
we keep full attention as the default and expose window=4096 as the
long-context variant.
A copy of ``repro/configs/starcoder2_7b.py``.
"""
from repro_torch.configs.base import ArchConfig, AttentionSpec, LayerSpec, register


@register
def config() -> ArchConfig:
    attn = AttentionSpec(num_heads=36, num_kv_heads=4, head_dim=128,
                         rope_theta=1_000_000.0)
    layer = LayerSpec(kind="attn", attention=attn, d_ff=18432, gated_mlp=False)
    return ArchConfig(
        name="starcoder2-7b",
        family="dense",
        d_model=4608,
        vocab_size=49152,
        layer_pattern=(layer,),
        pattern_repeats=32,
        source="arXiv:2402.19173 (StarCoder2)",
        long_context_window=4096,
    )
