"""Mamba2-1.3B — attention-free SSM with state-space duality (SSD).
[arXiv:2405.21060]

Assigned spec: 48L, d_model=2048, attn-free, d_ff=0 (mixer-only blocks),
vocab=50280, ssm_state=128.  expand=2, head_dim=64 per the released family.
A copy of ``repro/configs/mamba2_1_3b.py``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, SSMSpec, register


@register
def config() -> ArchConfig:
    ssm = SSMSpec(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256)
    layer = LayerSpec(kind="ssm", ssm=ssm)   # no FFN: mixer-only
    return ArchConfig(
        name="mamba2-1-3b",
        family="ssm",
        d_model=2048,
        vocab_size=50280,
        layer_pattern=(layer,),
        pattern_repeats=48,
        tie_embeddings=True,
        max_seq_len=1_048_576,
        source="arXiv:2405.21060 (Mamba-2 / SSD)",
    )
