"""Stateful uplink compressors and their registry.  Importing this package
registers every compressor; the import order fixes the ``available()``
order, which is the JAX package's."""
from repro_torch.core.compressors.base import (  # noqa: F401
    DIAG_KEYS,
    Compressor,
    Deltas,
    Packed,
    available,
    check_algorithm,
    diag_metrics,
    make_compressor,
    register,
    transport_of,
    tree_add,
    tree_size,
    tree_sub,
    tree_zeros_like,
)
from repro_torch.core.compressors.topk import (  # noqa: F401
    IndependentTopKCompressor,
    SharedTopKCompressor,
)
from repro_torch.core.compressors.dense import DenseCompressor  # noqa: F401
from repro_torch.core.compressors.quantized import (  # noqa: F401
    EfficientAdamCompressor,
    OneBitAdamCompressor,
)
