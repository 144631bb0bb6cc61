"""Build and load the port's hand-written CUDA kernels.

Every ``*.cu`` under ``src/repro_torch/csrc/`` (with the shared device
helpers of ``common.cuh``) is compiled for Hopper (``sm_90a``) on first
use: one ``nvcc -c`` per source, all started together, then one link
into a single shared library with a plain C interface, loaded with
:mod:`ctypes`.  The library lands in
``build/repro_torch/<hash>/`` at the root of the checkout, keyed on a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parents[1] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64

#: C signature of every exported function: (argtypes), all return an int,
#: the launchers a ``cudaError_t`` from ``cudaGetLastError()``.  Pointer
#: arguments take Python ints (``Tensor.data_ptr()``) or None.
SIGNATURES = {
    "repro_packed_hist": (_P,) * 9 + (_I, _I, _P),
    "repro_packed_apply": (_P,) * 10 + (_I, _I, _I, _P),
    "repro_packed_launch_shape": (_I, _I, _P),
    "repro_empty_launch": (_P,),
    "repro_pack_words": (_P, _P, _I64, _I, _P),
    "repro_unpack_words": (_P, _P, _I64, _I, _P),
    "repro_fused_adam": (_P,) * 8 + (_I64, _I, _P),
    "repro_absmax": (_P, _P, _P, _I64, _I, _P),
    "repro_count_ge": (_P, _P, _P, _P, _I64, _I, _I, _P),
    "repro_topk_workspace_words": (),
    "repro_apply_mask": (_P, _P, _P, _I64, _I, _P),
    "repro_ssm_apply_ef": (_P,) * 9 + (_I64, _I, _I, _I, _P),
    "repro_ssm_apply": (_P,) * 7 + (_I64, _I, _I, _I, _P),
}

_lib: Optional[ctypes.CDLL] = None
#: The library's functions by name, once it is loaded.
_fns: dict = {}
#: Seconds the last build took (0.0 when the library was already built).
build_seconds = 0.0


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from "
            f"{CSRC} with the CUDA toolkit")
    return found


def _run_all(cmds) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def build(out_dir: Path) -> Path:
    """Compile every source in parallel and link one shared library into
    ``out_dir``; the library appears there atomically."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(sources(), objs)])
        lib = Path(tmp) / LIB_NAME
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                   "-o", str(lib)]])
        os.replace(lib, out_dir / LIB_NAME)
    return out_dir / LIB_NAME


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet."""
    global _lib, build_seconds
    if _lib is None:
        path = BUILD_ROOT / _digest() / LIB_NAME
        if not path.exists():
            t0 = time.perf_counter()
            build(path.parent)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[name] = fn
        _lib = lib
    return _lib


def call(name: str, *args) -> int:
    """Call the library's function ``name`` (loading the library first)."""
    fn = _fns.get(name)
    if fn is None:
        library()
        fn = _fns[name]
    return fn(*args)


def launch(name: str, *args) -> None:
    """Call launcher ``name`` and raise if the launch was refused."""
    rc = call(name, *args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
