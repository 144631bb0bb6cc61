from repro_torch.optim.adam import (  # noqa: F401
    AdamHyper,
    AdamState,
    adam_init,
    adam_step,
    sgd_step,
)
