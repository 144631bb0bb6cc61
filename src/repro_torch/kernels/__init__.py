"""Hand-written Hopper kernels of the port, one family per subpackage.

Each family's ``ops.py`` holds the wrappers and, beside every kernel, its
plain PyTorch version.  A wrapper given a CPU tensor runs the plain
version; given a CUDA tensor it launches the kernel (built on first use
by :mod:`repro_torch.kernels._lib`) or raises.  ``LAUNCHES`` counts the
kernel launches per kernel, so a run can show which kernels it went
through; plain versions never touch it.  A fake tensor on the card
(``_check.py``: the dry run's) launches nothing: its call adds to
``PREDICTED`` instead, and the bytes the launch would read and write to
``PREDICTED_BYTES``.
"""
from __future__ import annotations

#: Kernel launches since the last :func:`reset_launches`, by kernel name.
LAUNCHES = {"packed_hist": 0, "packed_apply": 0,
            "pack_words": 0, "unpack_words": 0,
            "fused_adam": 0, "absmax": 0, "count_ge": 0, "apply_mask": 0,
            "ssm_apply_ef": 0, "ssm_apply": 0}
#: The launches that fake tensors' calls stood for, by kernel name.
PREDICTED = dict.fromkeys(LAUNCHES, 0)
#: Bytes those launches would move: each input read once, each output
#: written once.
PREDICTED_BYTES = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    """Zero :data:`LAUNCHES`, :data:`PREDICTED` and
    :data:`PREDICTED_BYTES`."""
    for name in LAUNCHES:
        LAUNCHES[name] = PREDICTED[name] = PREDICTED_BYTES[name] = 0


def predict(name: str, reads, writes) -> None:
    """Count a launch of ``name`` that a fake call stood for, with the
    bytes of the tensors it reads and writes (``None`` skipped)."""
    PREDICTED[name] += 1
    PREDICTED_BYTES[name] += sum(t.numel() * t.element_size()
                                 for t in (*reads, *writes)
                                 if t is not None)
