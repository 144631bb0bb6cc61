"""The client group of the multi-GPU (spatial) FL driver.

Counterpart of ``repro/launch/mesh.py`` and of the mesh half of
``repro/compat.py``.  The JAX package lays the clients on the data (and
pod) axes of a device mesh and runs each client's step under shard_map;
here each spatial client is one ``torch.distributed`` rank, and a
:class:`ClientMesh` (the process group, the client-axis names and sizes,
the rank, the device) is what the aggregate, the round and the async
cohort take in place of a mesh.  The client index is the rank: the
row-major linearization of the client axes that JAX's all-gather over
those axes (``aggregate._gather_clients``) gives.

Every rank holds whole leaves: the model axis is 1 in the port.  A mesh
with a model axis above 1 (tensor or FSDP sharding of the leaves) raises
``NotImplementedError`` naming ROADMAP §1.10.

:func:`init` joins a group over a ``file://`` store (no network);
:func:`make_test_group` is the CPU tests' gloo group, and
:func:`run_ranks` runs a function on every rank of such a group, each in
a process of its own.  CUDA tensors take NCCL unless the caller names
another backend, CPU tensors gloo; a failed collective raises.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing
import os
import queue as queue_mod
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

#: The ROADMAP item of what the port does not run: a model axis above 1.
TENSOR_FSDP_ITEM = "ROADMAP §1.10"

# gloo refuses uint32, int16 and bfloat16 ("Invalid scalar type"): the
# gather moves uint32 as int32 and the 2-byte and bool types as bytes,
# bitwise copies either way
_GATHER_VIEWS = {torch.uint32: torch.int32, torch.bfloat16: torch.uint8,
                 torch.float16: torch.uint8, torch.bool: torch.uint8}


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """One rank's view of the spatial clients' process group.

    ``shape``: mesh axis -> size, in mesh order (JAX's ``mesh.shape``);
    the client axes' sizes multiply to the world size, every other axis
    (a model axis) must be 1.  ``group``: the ``torch.distributed``
    process group (``None``: the default group)."""
    shape: Dict[str, int]
    client_axes: Tuple[str, ...]
    rank: int
    device: torch.device
    group: Any = None

    @property
    def world_size(self) -> int:
        return math.prod(self.shape[a] for a in self.client_axes)

    def check(self) -> None:
        """Raise for a mesh the port does not run: client axes that are
        not axes of the mesh, or a model axis above 1."""
        missing = [a for a in self.client_axes if a not in self.shape]
        if missing:
            raise ValueError(f"client axes {missing} are not axes of the "
                             f"mesh {self.shape}")
        model = {a: n for a, n in self.shape.items()
                 if a not in self.client_axes and n > 1}
        if model:
            raise NotImplementedError(
                f"mesh axes {model} beyond the client axes "
                f"{self.client_axes}: tensor and FSDP sharding of the "
                f"leaves is not ported yet: {TENSOR_FSDP_ITEM}")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(C, *x.shape)``: every rank's ``x``, in rank (client) order."""
        view = _GATHER_VIEWS.get(x.dtype)
        src = x.contiguous() if view is None else \
            x.reshape(-1).view(view)
        out = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(out, src, group=self.group)
        g = torch.stack(out)
        if view is None:
            return g
        return g.view(x.dtype).reshape((self.world_size,) + tuple(x.shape))

    def close(self) -> None:
        """Leave the group (the default group: destroy it)."""
        if dist.is_initialized():
            dist.destroy_process_group(self.group)


def init(world_size: int, rank: int, *, store: str,
         device: DeviceLike = None, backend: Optional[str] = None,
         client_axes: Sequence[str] = ("data",),
         shape: Optional[Dict[str, int]] = None,
         timeout_s: float = 300.0) -> ClientMesh:
    """Join the default process group as ``rank`` of ``world_size`` over
    the ``file://`` store at path ``store`` (every rank names the same
    file; it must not be left over from another group) and return this
    rank's :class:`ClientMesh`.  ``backend``: NCCL for a CUDA device,
    gloo for the CPU, unless named.  ``shape`` defaults to one client
    axis of ``world_size``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    axes = tuple(client_axes)
    mesh = ClientMesh(shape=dict(shape or {axes[0]: world_size}),
                      client_axes=axes, rank=rank, device=dev)
    mesh.check()
    if mesh.world_size != world_size:
        raise ValueError(f"mesh {mesh.shape} has {mesh.world_size} clients "
                         f"for a world of {world_size}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.abspath(store)}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return mesh


def make_test_group(world_size: int, rank: int, store: str) -> ClientMesh:
    """The CPU tests' group: gloo over ``store``, one client axis
    ``("data",)``, a minute's timeout on every collective."""
    return init(world_size, rank, store=store, device="cpu", timeout_s=60.0)


def _rank_main(fn, rank, world_size, store, args, results):
    try:
        results.put((rank, True, fn(rank, world_size, store, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world_size: int, *, store: str,
              args: tuple = (), timeout_s: float = 120.0) -> list:
    """``[fn(rank, world_size, store, *args) for rank in ranks]``, each
    rank in a process of its own (``spawn``), which joins the group over
    ``store`` itself.  ``fn`` must be importable by name and return
    something picklable.  Raises with a rank's traceback if it fails, and
    after ``timeout_s`` if a rank has not answered; every process is
    ended before it returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, store, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, failure = {}, None
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=timeout_s)
    try:
        # drain the queue before joining: a child blocks on exit until
        # its put has been read
        while len(out) < world_size and failure is None:
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                rank, ok, res = results.get(timeout=max(left, 0.01))
            except queue_mod.Empty:
                failure = f"ranks {sorted(set(range(world_size)) - set(out))}"\
                          f" did not answer within {timeout_s} s"
                break
            if ok:
                out[rank] = res
            else:
                failure = f"rank {rank} failed:\n{res}"
        for p in procs:
            p.join(timeout=10 if failure is None else 1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world_size)]
