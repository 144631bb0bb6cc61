"""Jamba-1.5-Large 398B — hybrid Mamba+attention MoE.  [arXiv:2403.19887]

Assigned spec: 72L, d_model=8192, 64 heads (GQA kv=8), expert d_ff=24576,
vocab=65536, MoE 16 experts top-2, attention:mamba interleave 1:7, MoE every
other layer.  Pattern of 8 layers (attention at index 4, MoE on odd
indices), repeated 9x.  The released model uses Mamba-1 mixers; we implement
the Mamba-2/SSD formulation throughout (TPU-friendly chunked matmul scan) —
noted hardware adaptation.
A copy of ``repro/configs/jamba_1_5_large_398b.py``.
"""
from repro_torch.configs.base import (
    ArchConfig, AttentionSpec, LayerSpec, MoESpec, SSMSpec, register,
)


@register
def config() -> ArchConfig:
    attn = AttentionSpec(num_heads=64, num_kv_heads=8, head_dim=128,
                         rope_theta=10000.0)
    ssm = SSMSpec(d_state=128, d_conv=4, expand=2, head_dim=128,
                  chunk_size=256)
    moe = MoESpec(num_experts=16, top_k=2, d_ff=24576)
    d_ff_dense = 24576

    def layer(i: int) -> LayerSpec:
        kind = "attn" if i == 4 else "ssm"
        if i % 2 == 1:
            return LayerSpec(kind=kind,
                             attention=attn if kind == "attn" else None,
                             ssm=ssm if kind == "ssm" else None,
                             moe=moe)
        return LayerSpec(kind=kind,
                         attention=attn if kind == "attn" else None,
                         ssm=ssm if kind == "ssm" else None,
                         d_ff=d_ff_dense)

    pattern = tuple(layer(i) for i in range(8))
    return ArchConfig(
        name="jamba-1-5-large-398b",
        family="hybrid",
        d_model=8192,
        vocab_size=65536,
        layer_pattern=pattern,
        pattern_repeats=9,
        max_seq_len=262144,
        source="arXiv:2403.19887 (Jamba)",
        long_context_window=4096,   # the lone attention layer windows at 500k
    )
