"""Architecture configs of the port (one module per architecture).

Importing this package registers every config of the JAX package's zoo.
"""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    AttentionSpec,
    EncoderSpec,
    LayerSpec,
    MoESpec,
    SSMSpec,
    available_archs,
    get_config,
    reduce_for_smoke,
    register,
)

from repro_torch.configs import (  # noqa: F401,E402
    deepseek_v2_lite_16b,
    gemma3_27b,
    jamba_1_5_large_398b,
    kimi_k2_1t_a32b,
    llava_next_mistral_7b,
    mamba2_1_3b,
    mistral_large_123b,
    starcoder2_3b,
    starcoder2_7b,
    whisper_base,
)

#: The architectures every (arch x shape x mesh) dry run covers, in the
#: JAX package's order.
ASSIGNED_ARCHS = (
    "kimi-k2-1t-a32b",
    "deepseek-v2-lite-16b",
    "gemma3-27b",
    "starcoder2-7b",
    "llava-next-mistral-7b",
    "jamba-1-5-large-398b",
    "mamba2-1-3b",
    "whisper-base",
    "mistral-large-123b",
    "starcoder2-3b",
)
