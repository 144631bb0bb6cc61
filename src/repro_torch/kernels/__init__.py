"""Hand-written Hopper kernels of the port, one family per subpackage.

Each family's ``ops.py`` holds the wrappers and, beside every kernel, its
plain PyTorch version.  A wrapper given a CPU tensor runs the plain
version; given a CUDA tensor it launches the kernel (built on first use
by :mod:`repro_torch.kernels._lib`) or raises.  ``LAUNCHES`` counts the
kernel launches per kernel, so a run can show which kernels it went
through; plain versions never touch it.
"""
from __future__ import annotations

#: Kernel launches since the last :func:`reset_launches`, by kernel name.
LAUNCHES = {"packed_hist": 0, "packed_apply": 0,
            "pack_words": 0, "unpack_words": 0,
            "fused_adam": 0, "absmax": 0, "count_ge": 0, "apply_mask": 0,
            "ssm_apply_ef": 0, "ssm_apply": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
