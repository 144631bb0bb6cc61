from repro_torch.data.federated import (  # noqa: F401
    client_batches,
    dirichlet_partition,
    iid_partition,
)
from repro_torch.data.churn import (  # noqa: F401
    ChurnConfig,
    ChurnModel,
    ClientFate,
)
from repro_torch.data.synthetic import (  # noqa: F401
    synthetic_frontend_embeds,
    synthetic_image_dataset,
    synthetic_tokens,
)
