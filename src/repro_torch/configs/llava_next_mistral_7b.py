"""LLaVA-NeXT (Mistral-7B backbone) — VLM.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

Assigned spec: 32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336,
vocab=32000.  The vision tower (CLIP/SigLIP + anyres tiling projector) is a
STUB per the brief: ``input_specs()`` provides precomputed patch embeddings
(up to 2880 anyres patch tokens) that the backbone consumes as a sequence
prefix.  Mistral lineage ships sliding-window attention; window=4096 is the
long-context variant.
"""
from repro_torch.configs.base import ArchConfig, AttentionSpec, LayerSpec, register


@register
def config() -> ArchConfig:
    attn = AttentionSpec(num_heads=32, num_kv_heads=8, head_dim=128,
                         rope_theta=1_000_000.0)
    layer = LayerSpec(kind="attn", attention=attn, d_ff=14336)
    return ArchConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        d_model=4096,
        vocab_size=32000,
        layer_pattern=(layer,),
        pattern_repeats=32,
        stub_frontend=True,
        stub_frontend_tokens=2880,   # anyres: up to 5 tiles x 576 patches
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
        long_context_window=4096,
    )
