"""Multi-process meshes and the multi-host (DCN) tier.

PyTorch-port counterpart of ``stencil_tpu/parallel/multihost.py``. The
reference runs one MPI rank per GPU and groups ranks by shared-memory
node (include/stencil/mpi_topology.hpp:18-36 ``MPI_Comm_split_type``);
``NodePartition`` splits the grid over nodes, then over the GPUs of a
node (partition.hpp:120-256). Here a rank is a ``torch.distributed``
process (one per card, or several on one card where the caller asks),
a host is a node, and the DCN tier of the JAX package — one grid axis
blocked across slices so that only its halo sweep crosses the slow
network — is one axis blocked across hosts.

Control plane: ``initialize_distributed`` wraps
``torch.distributed.init_process_group``; ``global_devices`` gathers
every rank's devices (through the process group's store, before any
collective runs); ``slice_groups``, ``multihost_device_order`` and
``make_multihost_mesh`` lay a mesh over them. Data plane:
``RankMessages`` is one batch of point-to-point messages, what the
exchange engines (``parallel/exchange.py``) send where a slab crosses
between two ranks, and ``broadcast_blocks`` the collective that hands
every rank a global array.

The transport is the caller's backend, never swapped behind their back:
``nccl`` sends CUDA tensors rank to rank and needs a card per rank;
``gloo`` moves CPU tensors and, for a CUDA tensor, stages every message
through host memory by an explicit copy (the reference's staged MPI
transport), the only way to put two ranks on one card.
``spawn_ranks`` starts a world of processes on one machine.
"""

from __future__ import annotations

import json
import os
import socket
import tempfile
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..geometry import Dim3, Dim3Like
from .mesh import GlobalDevice, Mesh, as_global, device_sorted, this_rank

#: the torchrun variables that name a process group
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")

#: calls of ``global_devices`` made by this process: every rank calls it
#: collectively, so the count names the same gather on every rank
_GATHERS = [0]


def initialize_distributed(init_method: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: Optional[float] = None) -> int:
    """Bring up the process group (JAX: ``jax.distributed.initialize``)
    and return this process's rank. A no-op when a group is up already,
    and when nothing names one (no ``init_method`` and no torchrun
    environment: one process, rank 0).

    With no arguments under ``python -m torch.distributed.run`` it reads
    torchrun's environment (``env://``). ``backend``: ``"nccl"`` or
    ``"gloo"`` as the caller says; None takes ``nccl`` on a machine with
    a CUDA device and ``gloo`` on one without, and nothing changes it
    afterwards (``check_transport``). With ``nccl`` the current CUDA
    device becomes this rank's ``local_device()``."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank()
    if init_method is None:
        if not all(k in os.environ for k in _TORCHRUN_ENV):
            return 0
        init_method = "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError(
            "backend 'nccl' was asked for, but this PyTorch build has no "
            "NCCL; pass backend='gloo' (host-staged messages) explicitly")
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = timedelta(seconds=timeout_s)
    if init_method != "env://":
        if num_processes is None or process_id is None:
            raise ValueError("init_method needs num_processes and "
                             "process_id")
        kw.update(world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, init_method=init_method, **kw)
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    return dist.get_rank()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return this_rank()


def process_count() -> int:
    """The number of ranks (1 without a process group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def backend() -> Optional[str]:
    """The process group's backend name, None without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return str(dist.get_backend())
    return None


def local_device() -> torch.device:
    """The card this rank drives by default: ``cuda:(LOCAL_RANK %
    count)`` (torchrun's local rank, else the rank). Raises without a
    CUDA device: the port never picks the CPU by itself."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass the devices (for instance "
            "global_devices(['cpu'])) to run a mesh on the host")
    local = int(os.environ.get("LOCAL_RANK", this_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def check_transport(backend_name: Optional[str],
                    devices: Sequence[GlobalDevice]) -> None:
    """Refuse a mesh its backend cannot carry: ``nccl`` moves CUDA
    tensors only, and one card per rank (two ranks on one card need
    ``gloo``'s host staging). Raises ``ValueError`` naming both."""
    if backend_name != "nccl":
        return
    owner: Dict[tuple, int] = {}
    for g in devices:
        if g.device.type != "cuda":
            raise ValueError(
                f"backend 'nccl' moves CUDA tensors only, but rank "
                f"{g.rank} holds {g.device}; use backend='gloo'")
        key = (g.host, g.device.index)
        if owner.setdefault(key, g.rank) != g.rank:
            raise ValueError(
                f"backend 'nccl' needs a card per rank, but ranks "
                f"{owner[key]} and {g.rank} share {g.device} on "
                f"{g.host}; use backend='gloo', which stages every "
                f"message through host memory")


def _store():
    from torch.distributed import distributed_c10d as c10d

    return c10d._get_default_store()


def global_devices(local: Optional[Sequence] = None) -> List[GlobalDevice]:
    """Every rank's devices, in rank order: the multi-process
    counterpart of ``jax.devices()``. A collective: every rank calls it,
    naming its own devices in ``local`` (default ``[local_device()]``);
    the lists are gathered once, through the process group's store, so
    that ``check_transport`` refuses a mesh the group's backend cannot
    carry before any message is sent. With ``nccl``
    a warm-up all-reduce then involves every rank, so that no rank's
    first point-to-point batch is its first NCCL call. Without a
    process group, this process's devices."""
    devs = [torch.device(d) for d in (local if local is not None
                                      else [local_device()])]
    host = socket.gethostname()
    if process_count() == 1:
        return [GlobalDevice(0, host, d) for d in devs]
    import torch.distributed as dist

    seq = _GATHERS[0]
    _GATHERS[0] += 1
    store = _store()
    rank, world = dist.get_rank(), dist.get_world_size()
    prefix = f"stencil_tpu_torch/global_devices/{seq}"
    store.set(f"{prefix}/{rank}", json.dumps(
        {"host": host, "devices": [str(d) for d in devs]}))
    out = []
    for r in range(world):
        got = json.loads(store.get(f"{prefix}/{r}").decode())
        out += [GlobalDevice(r, got["host"], torch.device(d))
                for d in got["devices"]]
    name = backend()
    check_transport(name, out)
    if name == "nccl":
        dist.all_reduce(torch.zeros(1, device=devs[0]))
    return out


def slice_groups(devices: Optional[Sequence] = None) -> List[List]:
    """Group devices by host, the reference's shared-memory split
    (``MpiTopology.colocated``; JAX groups TPU devices by slice): one
    group per host, groups ordered by their lowest rank, each group by
    rank then device index. On one host this is one group; tests inject
    groups instead."""
    if devices is None:
        from .mesh import resolve_devices

        devices = resolve_devices()
    groups: Dict[str, List] = {}
    for d in devices:
        groups.setdefault(as_global(d).host, []).append(d)
    ordered = sorted(groups.values(),
                     key=lambda g: min(as_global(d).rank for d in g))
    return [device_sorted(g) for g in ordered]


def multihost_device_order(mesh_shape: Dim3Like, dcn_axis: int = 2,
                           devices: Optional[Sequence] = None,
                           groups: Optional[List[List]] = None) -> List:
    """Device order (subdomain linear index, x fastest) for a 3D mesh
    with ``dcn_axis`` blocked across hosts: subdomains whose
    ``dcn_axis`` index falls in host ``s``'s block are placed on host
    ``s``'s devices, so that only that axis's halo sweep crosses between
    hosts (NodePartition's two-level split, reference:
    partition.hpp:120-256, as device order; JAX
    ``parallel/multihost.py:60-98``). ``groups`` injects an explicit
    grouping (tests; otherwise ``slice_groups``)."""
    shape = Dim3.of(mesh_shape)
    if groups is None:
        groups = slice_groups(devices)
    n_slices = len(groups)
    if shape[dcn_axis] % n_slices != 0:
        raise ValueError(f"mesh axis {dcn_axis} ({shape[dcn_axis]}) not "
                         f"divisible by {n_slices} slices")
    per_block = shape[dcn_axis] // n_slices
    sizes = {len(g) for g in groups}
    if len(sizes) != 1:
        raise ValueError(f"uneven slice sizes {sizes}")
    per_slice = shape.flatten() // n_slices
    if per_slice != sizes.pop():
        raise ValueError(f"mesh {shape} needs {per_slice} devices per "
                         f"slice, groups have {[len(g) for g in groups]}")
    ordered = [device_sorted(g) for g in groups]
    taken = [0] * n_slices
    out = []
    for iz in range(shape.z):
        for iy in range(shape.y):
            for ix in range(shape.x):
                g = (ix, iy, iz)[dcn_axis] // per_block
                out.append(ordered[g][taken[g]])
                taken[g] += 1
    return out


def make_multihost_mesh(mesh_shape: Dim3Like, dcn_axis: int = 2,
                        devices: Optional[Sequence] = None,
                        groups: Optional[List[List]] = None) -> Mesh:
    """A ``Mesh`` over ``multihost_device_order`` — see there for the
    host-blocking rule."""
    shape = Dim3.of(mesh_shape)
    return Mesh(shape, multihost_device_order(shape, dcn_axis,
                                              devices=devices,
                                              groups=groups))


def dcn_bytes_per_exchange(dd, dcn_axis: int = 2) -> int:
    """Bytes one shard sends per exchange along the DCN axis (the
    reference's inter-node byte counters, stencil.hpp:86-93)."""
    return dd.exchange_bytes_per_axis().get("xyz"[dcn_axis], 0)


#: messages and bytes ``RankMessages`` has queued in this process, sent
#: and received (what a run can read to show that a path moved nothing
#: through the process group)
MESSAGES = {"sent": 0, "received": 0, "bytes": 0}


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 tensor (every
    backend carries uint8, whatever the element type)."""
    return t.reshape(-1).view(torch.uint8)


class RankMessages:
    """One batch of point-to-point messages between the ranks of the
    process group: what one direction of an exchange sweep sends and
    receives. ``send`` and ``recv`` queue; ``start`` posts the batch in
    one ``batch_isend_irecv`` and returns at once; ``wait`` finishes
    every message, then hands each arrival, on its destination device,
    to its ``land`` callback. ``run`` is ``start`` then ``wait``.

    NCCL matches the messages of a pair of ranks in the order they are
    posted and ignores tags, so every rank must queue them in one global
    order (the engines go by destination position); gloo matches by tag,
    which the engines set to the same key. Under gloo a CUDA tensor
    crosses through host memory: copied to the host before the send,
    received into host memory and copied to its device."""

    def __init__(self) -> None:
        self._staged = backend() == "gloo"
        self._ops: list = []
        self._arrivals: list = []
        self._works: list = []
        self._posted: list = []

    def send(self, t: torch.Tensor, to: int, tag: int) -> None:
        import torch.distributed as dist

        t = (t.to("cpu") if self._staged else t).contiguous()
        self._ops.append(dist.P2POp(dist.isend, _bytes(t), to, tag=tag))
        MESSAGES["sent"] += 1
        MESSAGES["bytes"] += t.numel() * t.element_size()

    def recv(self, shape, dtype: torch.dtype, device: torch.device,
             frm: int, tag: int,
             land: Callable[[torch.Tensor], None]) -> None:
        import torch.distributed as dist

        buf = torch.empty(tuple(shape), dtype=dtype,
                          device="cpu" if self._staged else device)
        self._ops.append(dist.P2POp(dist.irecv, _bytes(buf), frm, tag=tag))
        self._arrivals.append((buf, device, land))
        MESSAGES["received"] += 1

    def start(self) -> None:
        """Post the queued messages (one ``batch_isend_irecv``); the
        buffers stay referenced here until ``wait``."""
        import torch.distributed as dist

        if self._ops:
            self._works = dist.batch_isend_irecv(self._ops)
        self._posted, self._ops = self._ops, []

    def wait(self) -> None:
        """Finish the posted messages and land every arrival."""
        for work in self._works:
            work.wait()
        for buf, device, land in self._arrivals:
            land(buf.to(device))
        self._works, self._posted, self._arrivals = [], [], []

    def run(self) -> None:
        self.start()
        self.wait()


def all_gather_objects(obj) -> list:
    """Every rank's ``obj`` (picklable), in rank order: a collective
    (``all_gather_object`` of the default group)."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_blocks(blocks: Sequence[Optional[torch.Tensor]],
                     shapes: Sequence, dtype: torch.dtype,
                     ranks: Sequence[int],
                     device: torch.device) -> List[torch.Tensor]:
    """Every position's block on every rank: ``blocks[i]`` is given by
    its owner ``ranks[i]`` (None elsewhere) and broadcast from there, as
    raw bytes, in position order (a collective). Returns host tensors
    of ``shapes[i]`` and ``dtype``; ``device`` is where a receiver takes
    the broadcast under ``nccl`` (under gloo, host memory)."""
    import torch.distributed as dist

    staged = backend() == "gloo"
    out = []
    for blk, shape, r in zip(blocks, shapes, ranks):
        if r == this_rank():
            buf = blk.contiguous()
            buf = buf.to("cpu") if staged else buf
        else:
            buf = torch.empty(tuple(shape), dtype=dtype,
                              device="cpu" if staged else device)
        dist.broadcast(_bytes(buf), src=r)
        out.append(buf.cpu())
    return out


def _rank_main(rank: int, fn: Callable, nprocs: int, init_method: str,
               backend_name: str, timeout_s: float, args: tuple) -> None:
    import torch.distributed as dist

    initialize_distributed(init_method, nprocs, rank, backend_name,
                           timeout_s)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, nprocs: int, args: tuple = (),
                backend_name: str = "gloo",
                rendezvous_dir: Optional[str] = None,
                timeout_s: float = 300.0) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes (the
    ``spawn`` start method), each rank ``rank`` of one process group of
    ``backend_name`` that meets at a ``file://`` rendezvous in
    ``rendezvous_dir`` (default: a temporary directory). ``fn`` must be
    importable by name (a module-level function). Returns when every
    rank has returned; a rank that raises ends the others and raises
    here. ``timeout_s`` bounds every message and collective."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as d:
        init = "file://" + os.path.join(d, "rendezvous")
        mp.spawn(_rank_main, args=(fn, nprocs, init, backend_name,
                                   timeout_s, tuple(args)),
                 nprocs=nprocs, join=True)
