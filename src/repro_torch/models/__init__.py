from repro_torch.models.vision import (  # noqa: F401
    build_vision,
    init_params,
    params_from_jax,
)
