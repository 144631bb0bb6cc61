from repro_torch.core.fed import (  # noqa: F401
    FedConfig,
    FedState,
    active_client_count,
    fed_init,
    make_client_step,
    make_fl_round,
    make_server_apply,
)
