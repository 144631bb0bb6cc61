from repro_torch.core.fed import (  # noqa: F401
    ALGORITHMS,
    FedConfig,
    FedState,
    active_client_count,
    fed_init,
    make_client_step,
    make_fl_round,
    make_server_apply,
)
from repro_torch.core.async_fed import (  # noqa: F401
    AsyncConfig,
    make_async_round,
    staleness_scale,
    staleness_weights,
)
from repro_torch.core import (  # noqa: F401
    aggregate,
    comm,
    compressors,
    masks,
    quantize,
    sparsify,
    theory,
    wire,
)
from repro_torch.core.compressors import (  # noqa: F401
    Compressor,
    Deltas,
    Packed,
    make_compressor,
)
