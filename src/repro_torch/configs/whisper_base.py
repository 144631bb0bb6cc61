"""Whisper-base — encoder-decoder speech model.  [arXiv:2212.04356]

Assigned spec: 6L (x2: 6 encoder + 6 decoder), d_model=512, 8 heads,
d_ff=2048, vocab=51865.  The mel-spectrogram + conv frontend is a STUB per
the brief: ``input_specs()`` provides precomputed frame embeddings
(batch, 1500, 512).  Decoder layers carry cross-attention to the encoder
output.  long_500k decode is architecturally meaningless for this family
(learned positions capped at 448) and is skipped — see
docs/ARCHITECTURE.md §6.
"""
from repro_torch.configs.base import (
    ArchConfig, AttentionSpec, EncoderSpec, LayerSpec, register,
)


@register
def config() -> ArchConfig:
    attn = AttentionSpec(num_heads=8, num_kv_heads=8, head_dim=64,
                         rope_theta=10000.0)
    layer = LayerSpec(kind="attn", attention=attn, d_ff=2048, gated_mlp=False)
    return ArchConfig(
        name="whisper-base",
        family="audio",
        d_model=512,
        vocab_size=51865,
        layer_pattern=(layer,),
        pattern_repeats=6,
        encoder=EncoderSpec(num_layers=6, num_heads=8, src_len=1500),
        stub_frontend=True,
        max_seq_len=448,
        source="arXiv:2212.04356 (Whisper)",
    )
