from repro_torch.checkpoint.io import (  # noqa: F401
    load_fed_state,
    load_pytree,
    save_fed_state,
    save_pytree,
)
