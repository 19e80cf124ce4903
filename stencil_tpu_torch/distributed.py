"""DistributedDomain: the public orchestrator over a mesh of shards.

PyTorch-port counterpart of ``stencil_tpu/distributed.py`` (reference:
include/stencil/stencil.hpp:33-225, src/stencil.cu): configure with
``add_data`` / ``set_radius`` / ``set_methods`` / ``set_boundary`` /
``set_mesh_shape``, ``realize()`` partitions the grid, places one
halo-padded shard per mesh position on its device, then ``exchange()``
fills the halos by the chosen method (``parallel/exchange.py``
``dispatch_exchange``) and ``swap()`` flips the double buffer.

The mesh is single-controller, as the JAX package's is: one process
holds every shard (``curr[q]`` is a list of padded tensors, x fastest)
and the exchange copies slabs between them (``parallel/exchange.py``).
``devices`` lists one device per mesh position and may repeat one
(shards sharing a card; ``["cpu"] * n`` on the host); ``device`` is the
one-device shorthand; with neither, every visible CUDA device is used,
and with no card that raises — the port never falls back to the CPU by
itself.

Not in this slice: the DCN tier, the exchange autotuner, narrowing wire
formats, the irredundant wire layout, temporal blocking (ROADMAP A7),
and QAP placement (``set_placement("qap")`` raises at realize(): A5).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .geometry import Dim3, Dim3Like, Radius
from .local_domain import interior_slices, raw_size, zyx_shape
from .numerics import div_ceil
from .parallel.exchange import dispatch_exchange, exchanged_bytes_per_sweep
from .parallel.mesh import Mesh, mesh_index, resolve_devices
from .parallel.methods import Method, pick_method
from .partition import RankPartition, partition_dims_even
from .placement import Placement, make_placement, normalize_placement_mode
from .topology import Boundary, Topology
from .utils.logging import LOG_INFO

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With no card and no explicit device this raises."""
    if device is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return resolve_devices(None, device)[0]


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    return {"float32": torch.float32, "float64": torch.float64,
            "bfloat16": torch.bfloat16, "float16": torch.float16}[name]


class DistributedDomain:
    """Global 3D grid of quantities over a mesh of shards."""

    def __init__(self, x: int, y: int, z: int, device: DeviceLike = None,
                 devices: Optional[Sequence] = None) -> None:
        self.size = Dim3(x, y, z)
        self._devices = resolve_devices(devices, device)
        self.device = self._devices[0]
        self.radius = Radius.constant(0)
        self.alloc_radius = self.radius
        self._names: List[str] = []
        self._dtypes: Dict[str, torch.dtype] = {}
        self.methods = Method.Default
        self.boundary = Boundary.PERIODIC
        self.placement_mode = "auto"
        self._mesh_shape: Optional[Dim3] = None
        self.mesh: Optional[Mesh] = None
        self.placement: Optional[Placement] = None
        self.mesh_counts = Dim3(1, 1, 1)
        self.local_size: Optional[Dim3] = None
        self.rem = Dim3(0, 0, 0)
        self.topology: Optional[Topology] = None
        self.curr: Dict[str, List[torch.Tensor]] = {}
        self.next_: Dict[str, List[torch.Tensor]] = {}
        self._bytes_per_axis: Dict[str, int] = {}
        self._on_interior_write: List[Callable[[str], None]] = []

    # -- configuration (reference: stencil.hpp:134-158) ----------------
    def add_data(self, name: str, dtype=torch.float32) -> str:
        """Register a quantity (reference: stencil.hpp add_data<T>)."""
        if self.local_size is not None:
            raise RuntimeError("add_data before realize()")
        if name in self._dtypes:
            raise ValueError(f"duplicate quantity {name}")
        self._names.append(name)
        self._dtypes[name] = torch_dtype(dtype)
        return name

    def set_radius(self, r: Union[int, Radius]) -> None:
        self.radius = Radius.constant(r) if isinstance(r, int) else r

    def set_methods(self, m: Method) -> None:
        """The exchange strategies allowed (``Method`` flags); realize()
        and exchange() run the one ``pick_method`` chooses."""
        self.methods = m

    def set_boundary(self, b: Boundary) -> None:
        self.boundary = b

    def set_mesh_shape(self, shape: Dim3Like) -> None:
        """Explicit subdomain-grid shape (the reference's set_gpus
        analog; a repeated device list plays its set_gpus({0,0}))."""
        self._mesh_shape = Dim3.of(shape)

    def set_placement(self, mode: str) -> None:
        """Placement mode ``"auto"`` | ``"trivial"`` | ``"qap"`` (the
        last raises at realize(): ROADMAP A5)."""
        self.placement_mode = normalize_placement_mode(mode)

    def _choose_partition_dim(self) -> Dim3:
        """The subdomain grid realize() uses: the explicit mesh shape,
        else an exact factorization of the device count, else the
        reference's greedy split with +-1 remainder subdomains."""
        n = len(self._devices)
        if self._mesh_shape is not None:
            if self._mesh_shape.flatten() != n:
                raise ValueError(f"mesh shape {self._mesh_shape} != device "
                                 f"count {n}")
            return self._mesh_shape
        try:
            return partition_dims_even(self.size, n)
        except ValueError:
            return RankPartition(self.size, n).dim()

    def realize(self) -> None:
        """Partition the grid, place the shards and allocate zeroed
        halo-padded ``curr`` shards at capacity on their devices
        (``next_`` allocates on first ``swap``), and price the
        exchange."""
        if not self._names:
            raise ValueError("add_data at least one quantity before "
                             "realize()")
        if self.boundary not in (Boundary.PERIODIC, Boundary.NONE):
            raise NotImplementedError(f"unsupported boundary {self.boundary}")
        method = pick_method(self.methods)
        slab = method in (Method.PpermuteSlab, Method.PpermutePacked)
        if self.boundary == Boundary.NONE and not slab:
            raise NotImplementedError(
                "Boundary.NONE (zero-Dirichlet exterior) is supported by "
                "the PpermuteSlab and PpermutePacked methods only")
        dim = self._choose_partition_dim()
        # per-shard capacity = ceil sizes; uneven shards are one short
        # (reference: partition.hpp:55-69)
        self.local_size = Dim3(*(div_ceil(self.size[a], dim[a])
                                 for a in range(3)))
        self.rem = self.size % dim
        if self.rem != Dim3(0, 0, 0) and not slab:
            raise NotImplementedError(
                f"grid {self.size} over mesh {dim} has uneven (+-1) "
                f"subdomains, supported only by the PpermuteSlab and "
                f"PpermutePacked methods")
        self.alloc_radius = self.radius
        min_local = [self.local_size[a] - (1 if self.rem[a] else 0)
                     for a in range(3)]
        if any(m < 1 for m in min_local):
            raise ValueError(f"zero-extent subdomains: grid {self.size} "
                             f"over mesh {dim}")
        if any(min_local[a] < max(self.radius.face(a, -1),
                                  self.radius.face(a, 1)) for a in range(3)):
            raise ValueError(f"subdomain {min_local} smaller than radius "
                             f"{self.radius}")
        part = RankPartition.from_dim(self.size, dim)
        self.placement = make_placement(part, self._devices,
                                        mode=self.placement_mode)
        self.mesh = Mesh(dim, self.placement.device_order_for_mesh())
        self.mesh_counts = dim
        self.topology = Topology(dim, self.boundary)
        shape = zyx_shape(raw_size(self.local_size, self.alloc_radius))
        for q in self._names:
            self.curr[q] = [torch.zeros(shape, dtype=self._dtypes[q],
                                        device=d)
                            for d in self.mesh.devices]
        self.next_ = {}
        self._bytes_per_axis = {"x": 0, "y": 0, "z": 0}
        for q in self._names:
            b = exchanged_bytes_per_sweep(
                shape, self.alloc_radius, dim,
                self.curr[q][0].element_size())
            for k in b:
                self._bytes_per_axis[k] += b[k]
        LOG_INFO(f"realized {self.size} over mesh {dim} (local "
                 f"{self.local_size}, padded "
                 f"{raw_size(self.local_size, self.alloc_radius)}, method "
                 f"{method}, devices "
                 f"{sorted(set(str(d) for d in self.mesh.devices))})")

    # -- iteration ------------------------------------------------------
    def exchange(self) -> None:
        """Fill all halos of every quantity's ``curr`` shards, in place,
        by the method ``pick_method(self.methods)`` chooses (reference:
        src/stencil.cu:1002-1186)."""
        if self.local_size is None:
            raise RuntimeError("realize() first")
        dispatch_exchange(self.curr, self.radius, self.mesh_counts,
                          pick_method(self.methods), rem=self.rem,
                          nonperiodic=self.boundary == Boundary.NONE)

    def swap(self) -> None:
        """Swap curr/next bindings (reference: src/local_domain.cu:67-84);
        ``next_`` shards are created on first use."""
        if not self.next_:
            self.next_ = {q: [torch.zeros_like(t) for t in v]
                          for q, v in self.curr.items()}
        self.curr, self.next_ = self.next_, self.curr

    # -- geometry -------------------------------------------------------
    def num_subdomains(self) -> int:
        return self.mesh_counts.flatten()

    def shard_index(self, i: int) -> Dim3:
        """Mesh position (x, y, z) of shard ``i`` (x fastest)."""
        return mesh_index(i, self.mesh_counts)

    def shard_size(self, i: int) -> Dim3:
        """The actual interior size of shard ``i`` (its capacity, or one
        less along an uneven axis)."""
        return self.placement.subdomain_size(self.shard_index(i))

    def shard_origin(self, i: int) -> Dim3:
        """The global origin of shard ``i``'s interior."""
        return self.placement.subdomain_origin(self.shard_index(i))

    def interior(self, name: str, i: int = 0) -> torch.Tensor:
        """The interior view (no copy) of shard ``i`` of ``curr[name]``:
        its actual size, without the dead capacity row of a short
        shard."""
        return self.curr[name][i][interior_slices(self.shard_size(i),
                                                  self.alloc_radius)]

    # -- observability (reference: stencil.hpp:86-93) -------------------
    def exchange_bytes_per_axis(self) -> Dict[str, int]:
        """Bytes one shard sends to other shards per exchange, per mesh
        axis: 0 on a one-device axis, whose wraps are local copies."""
        return dict(self._bytes_per_axis)

    def exchange_bytes_total(self) -> int:
        return sum(v * self.mesh_counts.flatten()
                   for v in self._bytes_per_axis.values())

    def exchange_bytes_amortized_per_step(self) -> float:
        return float(self.exchange_bytes_total())

    # -- IO (reference: src/stencil.cu:1188-1264) -----------------------
    def assemble_interior(self, shards: Sequence) -> np.ndarray:
        """The global (z,y,x) interior from padded shards laid out like
        this domain's (tensors or arrays, x fastest), on the host."""
        out = None
        for i, s in enumerate(shards):
            sz = self.shard_size(i)
            org = self.shard_origin(i)
            blk = s[interior_slices(sz, self.alloc_radius)]
            blk = blk.cpu().numpy() if isinstance(blk, torch.Tensor) \
                else np.asarray(blk)
            if out is None:
                out = np.empty(zyx_shape(self.size), dtype=blk.dtype)
            out[org.z:org.z + sz.z, org.y:org.y + sz.y,
                org.x:org.x + sz.x] = blk
        return out

    def interior_to_host(self, name: str) -> np.ndarray:
        """The global interior (z,y,x-ordered) as a numpy array."""
        return self.assemble_interior(self.curr[name])

    def on_interior_write(self, cb: Callable[[str], None]) -> None:
        """Register a callback that ``set_interior`` calls, with the
        field's name, before it writes: the hook a model with state kept
        outside ``curr`` uses to flush it first (stencil_tpu/
        distributed.py:841-845)."""
        self._on_interior_write.append(cb)

    def set_interior(self, name: str, values) -> None:
        """Scatter a global (z,y,x) interior (numpy array or tensor) into
        the shards of ``curr[name]``; halos and dead capacity rows are
        zeroed. The ``on_interior_write`` callbacks run first."""
        for cb in self._on_interior_write:
            cb(name)
        values = values if isinstance(values, torch.Tensor) else \
            torch.as_tensor(np.asarray(values))
        if tuple(values.shape) != zyx_shape(self.size):
            raise ValueError(f"interior shape {tuple(values.shape)} != "
                             f"{zyx_shape(self.size)}")
        if values.dtype != self._dtypes[name]:
            raise TypeError(f"interior dtype {values.dtype} != field "
                            f"dtype {self._dtypes[name]}")
        for i, dst in enumerate(self.curr[name]):
            sz = self.shard_size(i)
            org = self.shard_origin(i)
            dst.zero_()
            dst[interior_slices(sz, self.alloc_radius)].copy_(
                values[org.z:org.z + sz.z, org.y:org.y + sz.y,
                       org.x:org.x + sz.x])
