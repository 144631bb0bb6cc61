"""Stateful uplink compressors and their registry.  Importing this package
registers every compressor the port has; the import order fixes the
``available()`` order."""
from repro_torch.core.compressors.base import (  # noqa: F401
    DIAG_KEYS,
    NOT_PORTED,
    Compressor,
    Deltas,
    Packed,
    available,
    check_algorithm,
    make_compressor,
    register,
    tree_add,
    tree_size,
    tree_sub,
)
from repro_torch.core.compressors.topk import (  # noqa: F401
    IndependentTopKCompressor,
    SharedTopKCompressor,
)
