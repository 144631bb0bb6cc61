"""Kimi K2 — trillion-param MoE (paper-table entry).  [arXiv:2501.kimi2]

Assigned spec: 61L, d_model=7168, 64 heads (GQA kv=8), expert d_ff=2048,
vocab=163840, MoE 384 experts top-8.  We add the family's customary single
shared expert.  head_dim=128 (64×112 would be MXU-unaligned; 128 matches the
released model family convention).
A copy of ``repro/configs/kimi_k2_1t_a32b.py``.
"""
from repro_torch.configs.base import ArchConfig, AttentionSpec, LayerSpec, MoESpec, register


@register
def config() -> ArchConfig:
    attn = AttentionSpec(num_heads=64, num_kv_heads=8, head_dim=128,
                         rope_theta=50000.0)
    moe = MoESpec(num_experts=384, top_k=8, d_ff=2048,
                  num_shared_experts=1, shared_d_ff=2048)
    layer = LayerSpec(kind="attn", attention=attn, moe=moe)
    return ArchConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        d_model=7168,
        vocab_size=163840,
        layer_pattern=(layer,),
        pattern_repeats=61,
        source="arXiv:2501.kimi2 (Kimi K2)",
    )
