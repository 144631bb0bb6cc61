"""The client group of the multi-GPU (spatial) FL driver.

Counterpart of ``repro/launch/mesh.py`` and of the mesh half of
``repro/compat.py``.  The JAX package lays the clients on the data (and
pod) axes of a device mesh, and a client's leaves on its "model" axis,
and runs each client's step under shard_map; here every device of that
mesh is one ``torch.distributed`` rank, and a :class:`ClientMesh` (the
mesh's axes and sizes, the rank, the device, the process groups) is what
the aggregate, the round and the async cohort take in place of a mesh.

The ranks follow JAX's row-major device order: on a ``(data, model)``
mesh (``(pod, data, model)`` alike) rank ``r`` is client ``r // M`` and
model index ``r % M``, ``M`` the model axis's size.  So the client index
is the row-major linearization of the client axes that JAX's all-gather
over those axes (``aggregate._gather_clients``) gives.  Every rank makes
two sub-groups (:func:`init`): the **client group** of its model index,
over which the uplink and the metrics are all-gathered
(:meth:`ClientMesh.all_gather`), and the **model group** of its client
(:class:`ModelGroup`), which carries the tensor-parallel collectives.
With a model axis of 1 the client group is the whole group and there is
no model group.

The ``virtual`` clients of the ``fsdp`` plans run on a mesh with no
client axes: every client, one after another, on the whole mesh, its
leaves split over "model" and, along their ``embed`` dim, over the data
(and pod) axes (:attr:`ClientMesh.fsdp_axes`).  The groups are the same
ranks: the group of a model index, over the data axes, is then the
**data group** (:attr:`ClientMesh.data`, which carries the FSDP
all-gathers and reduce-scatters), and the whole world is the **leaf
group** (:attr:`ClientMesh.leaf`) of a leaf split over both.  Any other
axis, and FSDP axes beside client axes, raise ``NotImplementedError``
naming ``FSDP_ITEM_REMAINDER``.

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

#: The ROADMAP item of the tensor-parallel half: a model axis above 1.
TENSOR_ITEM = "ROADMAP §1.10(a)"
#: What the port does not run of ROADMAP §1.10(b), the ``virtual``
#: clients and the ``fsdp`` plans: FSDP leaves beside client axes (the
#: spatial round), the async driver on an FSDP mesh, and the compressors
#: whose scales, norms or sorts span a split leaf.
FSDP_ITEM_REMAINDER = "ROADMAP §1.10(b) remainder"
#: The axes the ``fsdp`` rules split a leaf's ``embed`` dim over, in
#: their order there (``sharding.fsdp_axes``: data before pod).
FSDP_AXES = ("data", "pod")
#: The mesh axis the leaves are split on.
MODEL_AXIS = "model"


def make_test_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """JAX's ``make_test_mesh`` as a shape (axis -> size, in mesh order):
    (data 2, model 2), a pod axis of 2 in front with ``multi_pod``."""
    return ({"pod": 2} if multi_pod else {}) | {"data": 2, "model": 2}


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """JAX's ``make_production_mesh`` as a shape: (data 16, model 16), a
    pod axis of 2 in front with ``multi_pod``."""
    return ({"pod": 2} if multi_pod else {}) | {"data": 16, "model": 16}


# gloo refuses uint32, int16 and bfloat16 ("Invalid scalar type"): the
# gather moves uint32 as int32 and the 2-byte and bool types as bytes,
# bitwise copies either way
_GATHER_VIEWS = {torch.uint32: torch.int32, torch.bfloat16: torch.uint8,
                 torch.float16: torch.uint8, torch.bool: torch.uint8}
# the types an all-reduce takes in float32 (gloo refuses bfloat16)
_REDUCE_IN_F32 = (torch.bfloat16, torch.float16)
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _gather_list(x: torch.Tensor, n: int, group) -> list:
    """Every rank's ``x`` of ``group`` (``n`` ranks), in rank order, as
    tensors of ``x``'s dtype and shape (moved through ``_GATHER_VIEWS``)."""
    view = _GATHER_VIEWS.get(x.dtype)
    src = x.contiguous() if view is None else \
        x.contiguous().reshape(-1).view(view)
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    if view is None:
        return out
    return [o.view(x.dtype).reshape(x.shape) for o in out]


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """The ranks that hold one client's leaves split on the model axis:
    this rank is ``index`` of ``size``.  The collectives here are plain
    (no autograd); ``models/tensor.py`` wraps them for the layers.  The
    data and leaf groups of the FSDP plans are of this class too: there
    ``index`` is this rank's shard along the split dim and ``order`` the
    group's ranks in shard order (``None``: their rank order).

    A bfloat16 or float16 all-reduce runs in float32 and is cast back, on
    gloo (which refuses bfloat16) and on NCCL alike, so that the two
    backends compute the same bits: the partial sums are added in float32
    and rounded once."""
    size: int
    index: int
    group: Any = None
    order: Optional[Tuple[int, ...]] = None

    def chunk(self, n: int) -> Tuple[int, int]:
        """``[lo, hi)``: this rank's contiguous share of ``n`` items (as
        JAX splits a dim the axis divides; an uneven ``n`` gives the
        first ranks one more)."""
        return (self.index * n) // self.size, \
            ((self.index + 1) * n) // self.size

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: ``x`` reduced (``"sum"`` or ``"max"``) over the
        group."""
        y = x.to(torch.float32) if x.dtype in _REDUCE_IN_F32 \
            else x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=_OPS[op], group=self.group)
        return y.to(x.dtype)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The group's ``x`` concatenated along ``dim`` in shard order."""
        parts = _gather_list(x, self.size, self.group)
        if self.order is not None:
            parts = [parts[j] for j in self.order]
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's chunk along ``dim`` of ``x`` summed over the group:
        an all-reduce, then the chunk (gloo has no reduce-scatter; the
        same bits on NCCL)."""
        lo, hi = self.chunk(x.shape[dim])
        return self.all_reduce(x).narrow(dim, lo, hi - lo).contiguous()


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """One rank's view of the clients' mesh.

    ``shape``: mesh axis -> size, in mesh order (JAX's ``mesh.shape``);
    the client axes' sizes multiply to the number of clients, and a
    "model" axis splits each client's leaves.  ``client_axes`` empty (the
    virtual clients) makes the data[, pod] axes FSDP axes.  ``group``: the
    ranks of this rank's model index across the rows (the client group
    the uplink is all-gathered over, or the data group; ``None``: the
    default group, when the model axis is 1); ``model_group``: the
    process group of this rank's row's model ranks (``None`` with a model
    axis of 1)."""
    shape: Dict[str, int]
    client_axes: Tuple[str, ...]
    rank: int
    device: torch.device
    group: Any = None
    model_group: Any = None

    @property
    def n_clients(self) -> int:
        """The clients: the product of the client axes' sizes."""
        return math.prod(self.shape[a] for a in self.client_axes)

    @property
    def model_size(self) -> int:
        return self.shape.get(MODEL_AXIS, 1)

    @property
    def world_size(self) -> int:
        """The ranks: every axis's size multiplied."""
        return math.prod(self.shape.values())

    @property
    def client_index(self) -> int:
        """This rank's row: its client (row-major over the client axes),
        or on a virtual mesh its slice of each client's batch."""
        return self.rank // self.model_size

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size

    @property
    def model(self) -> Optional[ModelGroup]:
        """This rank's :class:`ModelGroup`, or ``None`` with a model axis
        of 1."""
        if self.model_size == 1:
            return None
        return ModelGroup(self.model_size, self.model_index,
                          self.model_group)

    @property
    def fsdp_axes(self) -> Tuple[str, ...]:
        """The axes the ``fsdp`` rules split a leaf's ``embed`` dim over
        here, in their order there: the data[, pod] axes of a mesh with
        no client axes, else none."""
        if self.client_axes:
            return ()
        return tuple(a for a in FSDP_AXES if a in self.shape)

    @property
    def data(self) -> Optional[ModelGroup]:
        """The data group: the ranks of this rank's model index over the
        FSDP axes, ``index`` this rank's shard of a dim split over them
        (row-major in :attr:`fsdp_axes`' order, JAX's ``("data", "pod")``,
        not the mesh's), ``order`` the group's ranks in that order.
        ``None`` without FSDP axes above 1."""
        axes = self.fsdp_axes
        size = math.prod(self.shape[a] for a in axes)
        if size == 1:
            return None
        rows = [a for a in self.shape if a != MODEL_AXIS]

        def shard_of(row: int) -> int:
            c = {}
            for a in reversed(rows):
                c[a], row = row % self.shape[a], row // self.shape[a]
            s = 0
            for a in axes:
                s = s * self.shape[a] + c[a]
            return s

        # the group's rank j is row j (the ranks ascend with the row)
        shards = [shard_of(j) for j in range(size)]
        order = tuple(sorted(range(size), key=shards.__getitem__))
        return ModelGroup(size, shard_of(self.client_index), self.group,
                          None if order == tuple(range(size)) else order)

    @property
    def leaf(self) -> Optional[ModelGroup]:
        """The leaf group: every rank of the mesh (the default group),
        which holds a shard of a leaf split over the data and the model
        axes; index 0 is the rank at 0 along every axis.  Only its
        reductions are used.  ``None`` on one rank."""
        if self.world_size == 1:
            return None
        return ModelGroup(self.world_size, self.rank, None)

    def check(self) -> None:
        """Raise for a mesh the port does not run: client axes that are
        not axes of the mesh, or the model axis in front of one; an axis
        beyond them and "model", other than the FSDP axes of a mesh with
        no client axes (``FSDP_ITEM_REMAINDER``)."""
        missing = [a for a in self.client_axes if a not in self.shape]
        if missing:
            raise ValueError(f"client axes {missing} are not axes of the "
                             f"mesh {self.shape}")
        other = {a: n for a, n in self.shape.items()
                 if a not in self.client_axes and a != MODEL_AXIS
                 and a not in self.fsdp_axes and n > 1}
        if other:
            raise NotImplementedError(
                f"mesh axes {other} beyond the client axes "
                f"{self.client_axes} and {MODEL_AXIS!r}: the leaves split "
                f"over them (FSDP beside client axes, or another axis) are "
                f"not ported: {FSDP_ITEM_REMAINDER}")
        axes = list(self.shape)
        if MODEL_AXIS in self.shape and self.model_size > 1 and \
                axes[-1] != MODEL_AXIS:
            raise ValueError(f"the {MODEL_AXIS!r} axis must be the mesh's "
                             f"last, got {axes}")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(C, *x.shape)``: every client's ``x`` over this rank's client
        group, in client order."""
        return torch.stack(_gather_list(x, self.n_clients, self.group))

    def close(self) -> None:
        """Leave the group (every process group of this process)."""
        if dist.is_initialized():
            dist.destroy_process_group()


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
    axis of ``world_size``; ``client_axes=()`` is the virtual clients'
    mesh, its data[, pod] axes FSDP axes.  With a model axis above 1
    every rank then makes the groups of each model index across the rows
    (client or data groups) and the model groups (one per row) in the
    same order, and keeps its own two."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    axes = tuple(client_axes)
    if shape is None and not axes:
        raise ValueError("a mesh with no client axes needs its shape")
    mesh = ClientMesh(shape=dict(shape or {axes[0]: world_size}),
                      client_axes=axes, rank=rank, device=dev)
    mesh.check()
    if mesh.world_size != world_size:
        raise ValueError(f"mesh {mesh.shape} has {mesh.world_size} ranks "
                         f"for a world of {world_size}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.abspath(store)}",
        world_size=world_size, rank=rank, timeout=timeout)
    M = mesh.model_size
    if M == 1:
        return mesh
    rows = world_size // M
    client_group = model_group = None
    for m in range(M):
        g = dist.new_group([c * M + m for c in range(rows)], timeout=timeout)
        if m == mesh.model_index:
            client_group = g
    for c in range(rows):
        g = dist.new_group([c * M + m for m in range(M)], timeout=timeout)
        if c == mesh.client_index:
            model_group = g
    return dataclasses.replace(mesh, group=client_group,
                               model_group=model_group)


def make_test_group(world_size: int, rank: int, store: str, *,
                    shape: Optional[Dict[str, int]] = None,
                    client_axes: Sequence[str] = ("data",)) -> ClientMesh:
    """The CPU tests' group: gloo over ``store``, the client axis
    ``("data",)`` (and a "model" axis where ``shape`` has one; e.g.
    :func:`make_test_mesh`; ``client_axes=()`` for the virtual clients),
    a minute's timeout on every collective."""
    return init(world_size, rank, store=store, device="cpu", shape=shape,
                client_axes=client_axes, timeout_s=60.0)


#: How often :func:`run_ranks` looks for a rank that ended without an
#: answer, and how long it then waits for an answer still in the pipe (a
#: process that has exited has written its answer there: a put into a
#: full pipe keeps it from exiting).
_POLL_S = 1.0
_LAST_WORD_S = 1.0


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
    something picklable.  Raises with a rank's traceback if it fails, at
    once when a rank's process ends without answering (killed, or a
    native abort: its exit code named), and after ``timeout_s`` if a rank
    has not answered; every process is ended before it returns."""
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
            if left <= 0:
                failure = f"ranks {sorted(set(range(world_size)) - set(out))}"\
                          f" did not answer within {timeout_s} s"
                break
            try:
                rank, ok, res = results.get(timeout=min(left, _POLL_S))
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if not dead:
                    continue
                # an answer may still be on its way through the pipe
                try:
                    rank, ok, res = results.get(timeout=_LAST_WORD_S)
                except queue_mod.Empty:
                    r, code = dead[0]
                    failure = f"rank {r} exited with code {code} without " \
                              "answering"
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
