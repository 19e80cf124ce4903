"""The mesh of shards: which device, of which process, holds each
subdomain.

PyTorch-port counterpart of ``stencil_tpu/parallel/mesh.py``. The JAX
package runs one process over a ``jax.sharding.Mesh`` of devices. The
port holds one shard tensor per mesh position, each on its own
``torch.device``, and moves slabs between them by device-to-device
copies (the reference's same-rank transport, ``cudaMemcpyPeerAsync``).
Mesh positions are ordered x fastest, as the JAX mesh's device list is.

A mesh may span processes (one ``torch.distributed`` rank per card, the
reference's one MPI rank per GPU): each position then has an owner rank
(``GlobalDevice``), a process allocates only the shards it owns
(``Mesh.local_positions``), and the exchange engines move a slab between
two ranks as a message (``parallel/multihost.py``). Plain devices are
owned by the process that names them.

A device may repeat: several shards then share one card (the reference's
own test strategy, ``test/test_exchange.cu:52`` ``dd.set_gpus({0,0})``),
and ``devices=["cpu"] * n`` runs a mesh on the host.
"""

from __future__ import annotations

import socket
from typing import List, NamedTuple, Optional, Sequence, Union

import torch

from ..geometry import Dim3, Dim3Like
from ..numerics import prime_factors

DeviceLike = Union[str, torch.device, None]


class GlobalDevice(NamedTuple):
    """A device of a multi-process mesh: the rank that drives it, that
    rank's host and the ``torch.device`` on that host
    (``multihost.global_devices``)."""

    rank: int
    host: str
    device: torch.device


def this_rank() -> int:
    """This process's ``torch.distributed`` rank (0 when no process
    group is up)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def as_global(d) -> GlobalDevice:
    """``d`` as a ``GlobalDevice``: a plain device belongs to this
    process."""
    if isinstance(d, GlobalDevice):
        return d
    return GlobalDevice(this_rank(), socket.gethostname(), torch.device(d))


def device_sorted(devices: Sequence) -> List:
    """Devices ordered by rank, then device index: the counterpart of
    JAX's ``_torus_sorted`` (``stencil_tpu/parallel/mesh.py:33``), whose
    physical torus coordinates a GPU host does not have (every card of
    an NVSwitch host is one hop from every other). Stable, so equal
    devices keep their order."""
    def key(d):
        g = as_global(d)
        return (g.rank, g.device.type, -1 if g.device.index is None
                else g.device.index)

    return sorted(devices, key=key)


def resolve_devices(devices: Optional[Sequence] = None,
                    device: DeviceLike = None) -> List:
    """The device list a domain runs on. ``devices`` is taken verbatim
    (repeats allowed; ``GlobalDevice`` entries, a mesh over processes,
    are kept as they are); else ``device`` alone; else, in a process
    group of more than one rank, every rank's devices
    (``multihost.global_devices``); else every visible CUDA device, the
    counterpart of ``jax.devices()`` — and with no card that raises: the
    port never falls back to the CPU by itself."""
    if devices is not None and device is not None:
        raise ValueError("pass device= (one device) or devices= (a mesh), "
                         "not both")
    if devices is not None:
        out = [d if isinstance(d, GlobalDevice) else torch.device(d)
               for d in devices]
        if not out:
            raise ValueError("devices= is empty")
        if any(isinstance(d, GlobalDevice) for d in out):
            return [as_global(d) for d in out]
    elif device is not None:
        out = [torch.device(device)]
    else:
        from .multihost import global_devices, process_count

        if process_count() > 1:
            return global_devices()
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (or "
                "devices=['cpu'] * n for a mesh) to run the plain PyTorch "
                "paths on the host")
        out = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    out = [torch.device("cuda", torch.cuda.current_device())
           if d.type == "cuda" and d.index is None
           and torch.cuda.is_available() else d for d in out]
    if any(d.type == "cuda" for d in out) and not torch.cuda.is_available():
        raise RuntimeError(f"devices {[str(d) for d in out]} requested but "
                           f"CUDA is not available")
    return out


def mesh_index(i: int, counts: Dim3) -> Dim3:
    """Mesh position (x, y, z) of linear position ``i`` (x fastest)."""
    return Dim3(i % counts.x, (i // counts.x) % counts.y,
                i // (counts.x * counts.y))


def mesh_linear(idx: Dim3Like, counts: Dim3) -> int:
    """Linear position of mesh position ``idx`` (x fastest)."""
    idx = Dim3.of(idx)
    return idx.x + counts.x * (idx.y + counts.y * idx.z)


def mesh_neighbor(i: int, counts: Dim3, axis: int, step: int) -> int:
    """Linear position of the periodic neighbour ``step`` (+-1) of
    position ``i`` along grid ``axis`` (0 x, 1 y, 2 z)."""
    idx = list(mesh_index(i, counts))
    idx[axis] = (idx[axis] + step) % counts[axis]
    return mesh_linear(Dim3(*idx), counts)


class Mesh:
    """A (x, y, z) grid of mesh positions, each with its device and the
    rank that owns it: ``devices[i]`` holds the shard at linear position
    ``i`` (x fastest, ``mesh_index``) in process ``ranks[i]``. ``devices``
    may mix plain devices (this process's) and ``GlobalDevice``s."""

    def __init__(self, shape: Dim3Like, devices: Sequence) -> None:
        self.shape = Dim3.of(shape)
        slots = [as_global(d) for d in devices]
        self.devices = [g.device for g in slots]
        if self.shape.flatten() != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} needs "
                             f"{self.shape.flatten()} devices, have "
                             f"{len(self.devices)}")
        #: the owner rank of each position, and this process's rank
        self.ranks = tuple(g.rank for g in slots)
        self.rank = this_rank()
        #: the positions whose shards this process holds
        self.local_positions = [i for i, r in enumerate(self.ranks)
                                if r == self.rank]
        #: does any position belong to another process?
        self.spans_ranks = len(self.local_positions) != len(self.ranks)

    @property
    def peers(self) -> Optional[tuple]:
        """What the exchange engines take as ``ranks=``: the owner of
        each position on a mesh that spans processes, None on one whose
        shards this process holds all of."""
        return self.ranks if self.spans_ranks else None


def make_mesh(mesh_shape: Optional[Dim3Like] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``mesh_shape`` (default: near-cubic over the devices)
    over ``devices`` (default: every visible CUDA device; see
    ``resolve_devices``), in the order given."""
    devs = resolve_devices(devices)
    shape = (default_mesh_shape(len(devs)) if mesh_shape is None
             else Dim3.of(mesh_shape))
    return Mesh(shape, devs)


def default_mesh_shape(n: int) -> Dim3:
    """Near-cubic factorization of ``n`` (prime factors round-robined
    onto axes, largest first)."""
    dims = [1, 1, 1]
    for f in prime_factors(n):
        if f < 2:
            continue
        dims[dims.index(min(dims))] *= f
    dims.sort(reverse=True)
    return Dim3(*dims)


def default_mesh_shape_xfree(n: int) -> Dim3:
    """Near-square (1, dy, dz) factorization of ``n`` — the x-unsharded
    decomposition the halo kernels want."""
    dims = [1, 1]
    for f in prime_factors(n):
        if f < 2:
            continue
        dims[dims.index(min(dims))] *= f
    dims.sort(reverse=True)
    return Dim3(1, dims[1], dims[0])


def default_mesh_shape_dcn(n: int, n_slices: int, axis: int = 2,
                           xfree: bool = False) -> Dim3:
    """Mesh shape whose ``axis`` is divisible by ``n_slices`` (the
    constraint the slice-blocked DCN tier needs): the slice factor goes
    on ``axis`` and the per-slice remainder is factored near-cubic (or
    x-unsharded when ``xfree``) — JAX ``parallel/mesh.py:108-121``."""
    if n % n_slices:
        raise ValueError(f"{n} devices not divisible into {n_slices} "
                         f"slices")
    base = (default_mesh_shape_xfree(n // n_slices) if xfree
            else default_mesh_shape(n // n_slices))
    dims = [base.x, base.y, base.z]
    dims[axis] *= n_slices
    return Dim3(*dims)


def mesh_dim(mesh: Mesh) -> Dim3:
    """Subdomain-grid shape (x, y, z) of a mesh."""
    return mesh.shape
