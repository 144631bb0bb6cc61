"""DeepSeek-V2-Lite 16B — MoE with Multi-head Latent Attention.
[arXiv:2405.04434]

Assigned spec: 27L, d_model=2048, 16 heads, MLA kv_lora_rank=512,
64 routed experts top-6 + 2 shared experts, expert d_ff=1408,
vocab=102400.  (The released model's first layer is a dense FFN; we model
all 27 layers as MoE for a homogeneous scan — noted deviation, <0.5% of
params.)
A copy of ``repro/configs/deepseek_v2_lite_16b.py``.
"""
from repro_torch.configs.base import ArchConfig, AttentionSpec, LayerSpec, MoESpec, register


@register
def config() -> ArchConfig:
    attn = AttentionSpec(num_heads=16, num_kv_heads=16, head_dim=128,
                         kv_lora_rank=512, rope_theta=10000.0)
    moe = MoESpec(num_experts=64, top_k=6, d_ff=1408,
                  num_shared_experts=2, shared_d_ff=1408)
    layer = LayerSpec(kind="attn", attention=attn, moe=moe)
    return ArchConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        d_model=2048,
        vocab_size=102400,
        layer_pattern=(layer,),
        pattern_repeats=27,
        source="arXiv:2405.04434 (DeepSeek-V2)",
    )
