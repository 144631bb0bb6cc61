"""Architecture configs of the port (one module per architecture).

Importing this package registers every config the port has: the JAX
package's zoo but for the two whose encoder or stub frontend is not ported
yet (``whisper-base``, ``llava-next-mistral-7b``: ROADMAP §1.13), for which
``get_config`` raises ``NotImplementedError``.
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
    mamba2_1_3b,
    mistral_large_123b,
    starcoder2_3b,
    starcoder2_7b,
)
