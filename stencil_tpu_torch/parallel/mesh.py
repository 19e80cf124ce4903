"""The mesh of shards: which device holds each subdomain.

PyTorch-port counterpart of ``stencil_tpu/parallel/mesh.py``. The JAX
package runs one process over a ``jax.sharding.Mesh`` of devices; the
port does the same with one Python process that holds one shard tensor
per mesh position, each on its own ``torch.device``, and moves slabs
between them by device-to-device copies (the reference's same-rank
transport, ``cudaMemcpyPeerAsync``). Mesh positions are ordered x
fastest, as the JAX mesh's device list is.

A device may repeat: several shards then share one card (the reference's
own test strategy, ``test/test_exchange.cu:52`` ``dd.set_gpus({0,0})``),
and ``devices=["cpu"] * n`` runs a mesh on the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ..geometry import Dim3, Dim3Like
from ..numerics import prime_factors

DeviceLike = Union[str, torch.device, None]


def resolve_devices(devices: Optional[Sequence] = None,
                    device: DeviceLike = None) -> List[torch.device]:
    """The device list a domain runs on. ``devices`` is taken verbatim
    (repeats allowed); else ``device`` alone; else every visible CUDA
    device, the counterpart of ``jax.devices()`` — and with no card that
    raises: the port never falls back to the CPU by itself."""
    if devices is not None and device is not None:
        raise ValueError("pass device= (one device) or devices= (a mesh), "
                         "not both")
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if not out:
            raise ValueError("devices= is empty")
    elif device is not None:
        out = [torch.device(device)]
    else:
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
    """A (x, y, z) grid of mesh positions, each with its device:
    ``devices[i]`` holds the shard at linear position ``i`` (x fastest,
    ``mesh_index``)."""

    def __init__(self, shape: Dim3Like, devices: Sequence) -> None:
        self.shape = Dim3.of(shape)
        self.devices = [torch.device(d) for d in devices]
        if self.shape.flatten() != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} needs "
                             f"{self.shape.flatten()} devices, have "
                             f"{len(self.devices)}")


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


def mesh_dim(mesh: Mesh) -> Dim3:
    """Subdomain-grid shape (x, y, z) of a mesh."""
    return mesh.shape
