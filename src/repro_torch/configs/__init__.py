"""Architecture configs of the port (one module per architecture).

Importing this package registers every config the port has: the dense GQA
family's ``starcoder2-3b``.  The rest of the JAX package's zoo is ROADMAP
§1.13; ``get_config`` of such a name raises ``NotImplementedError``.
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

from repro_torch.configs import starcoder2_3b  # noqa: F401,E402
