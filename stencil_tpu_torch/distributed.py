"""DistributedDomain: the public orchestrator over a mesh of shards.

PyTorch-port counterpart of ``stencil_tpu/distributed.py`` (reference:
include/stencil/stencil.hpp:33-225, src/stencil.cu): configure with
``add_data`` / ``set_radius`` / ``set_methods`` / ``set_boundary`` /
``set_mesh_shape``, ``realize()`` partitions the grid, places one
halo-padded shard per mesh position on its device, then ``exchange()``
fills the halos by the chosen method (``parallel/exchange.py``
``dispatch_exchange``) and ``swap()`` flips the double buffer.

``curr[q]`` is a list of padded tensors, one per mesh position (x
fastest), and the exchange copies slabs between them
(``parallel/exchange.py``). ``devices`` lists one device per mesh
position and may repeat one (shards sharing a card; ``["cpu"] * n`` on
the host); ``device`` is the one-device shorthand; with neither, every
visible CUDA device is used, and with no card that raises — the port
never falls back to the CPU by itself.

A mesh may span processes, one ``torch.distributed`` rank per card (or
several on one card): ``devices`` then lists ``GlobalDevice``s
(``parallel/multihost.global_devices``, the default in a process group
of more than one rank). Every rank builds the same domain; ``realize()``
allocates only the shards this rank owns (None at the other positions
of ``curr[q]``), ``exchange()`` sends the slabs that cross between ranks
as messages, ``interior_to_host`` / ``assemble_interior`` are
collectives that hand every rank the global array, and ``set_interior``
writes each rank's own part.

The DCN tier (``set_dcn_axis``; JAX ``distributed.py:223-611``): one
grid axis is blocked across hosts, so that only its halo sweep crosses
the slow inter-host network while the others stay on a host's NVLink.
Without an explicit mesh shape ``realize()`` prices every exact
(mesh shape, host-blocked axis) candidate with the alpha-beta model
(``analysis/costmodel.py``) and keeps the cheapest; the host-blocked
device order is then the placement.

Temporal blocking (``set_exchange_every``): allocations pad to the
deepened radius and ``exchange()`` ships the deep halo once per ``s``
steps (``parallel/temporal.py``).

Halo wire formats and layouts (``set_wire_format``, ``set_wire_layout``):
``realize()`` builds the exchange through ``parallel/exchange.
make_exchange``, which gates a narrowing format behind a precision
certificate (``precision_certificate``), and prices the bytes at the
wire's width and layout.

Not ported: the exchange autotuner (ROADMAP A12), the plan file
(``_write_plan``, A5) and QAP placement (``set_placement("qap")`` raises
at realize(): A5).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .geometry import DepthsLike, Dim3, Dim3Like, Radius, normalize_depths
from .local_domain import interior_slices, raw_size, zyx_shape
from .numerics import div_ceil
from .parallel.exchange import (exchanged_bytes_per_sweep, make_exchange,
                                normalize_wire_format)
from .parallel.mesh import (Mesh, as_global, mesh_index, resolve_devices,
                            this_rank)
from .parallel.methods import WIRE_CAPABLE, Method, pick_method
from .parallel.packing import (irredundant_bytes_per_sweep,
                               normalize_wire_layout)
from .partition import (NodePartition, RankPartition,
                        exact_partition_candidates, partition_dims_even)
from .placement import Placement, make_placement, normalize_placement_mode
from .topology import Boundary, Topology
from .utils.logging import LOG_INFO

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With no card and no explicit device this raises."""
    if device is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return as_global(resolve_devices(None, device)[0]).device


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
        #: every mesh position's device, with its owner rank and host
        self._global = [as_global(d) for d in resolve_devices(devices,
                                                              device)]
        self._devices = [g.device for g in self._global]
        self.device = next((g.device for g in self._global
                            if g.rank == this_rank()), self._devices[0])
        self.radius = Radius.constant(0)
        self.alloc_radius = self.radius
        self.exchange_every = 1
        self.exchange_depths = Dim3(1, 1, 1)
        self._names: List[str] = []
        self._dtypes: Dict[str, torch.dtype] = {}
        self.methods = Method.Default
        self.boundary = Boundary.PERIODIC
        self.wire_format = "f32"
        self.wire_layout = "slab"
        self._exchange_fn = None
        self.placement_mode = "auto"
        self._mesh_shape: Optional[Dim3] = None
        # the DCN tier (set_dcn_axis); resolved by realize()
        self._dcn_requested = False
        self._dcn_axis_req: Optional[int] = None
        self._dcn_axis_planned: Optional[int] = None
        self._dcn_groups = None
        self.dcn_axis: Optional[int] = None
        self.n_slices = 1
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

    def set_exchange_every(self, s: DepthsLike) -> None:
        """Temporal blocking depth (JAX ``distributed.py:162-193``):
        ``exchange()`` ships a depth-``s * r`` halo once per ``s`` steps
        instead of a depth-``r`` halo every step. Allocations pad to the
        deepened radius. The step loop (``Jacobi3D``) owns calling the
        exchange every ``s``-th step and consuming one radius ring per
        sub-step (``parallel/temporal.py``).

        ``s`` may be per-axis (``{"z": 4, "y": 1, "x": 1}``, a 3-tuple
        or a ``Dim3``; ``geometry.normalize_depths``): axis ``a`` is
        exchanged every ``s_a`` sub-steps of the ``max(s)``-step group;
        ``exchange_every`` stays ``max(s)``.

        Allocations deepen (and the minimum-shard check tightens) even
        where a CUDA fast path later takes the depth inside its kernel
        and never runs this deep exchange: ``2*(s-1)*r`` extra halo rows
        per field per axis."""
        if self.mesh is not None:
            raise RuntimeError("set_exchange_every before realize() — the "
                               "allocation pads and the exchange are "
                               "already built")
        if isinstance(s, int) and s < 1:
            raise ValueError(f"exchange_every must be >= 1, got {s}")
        depths = normalize_depths(s)
        self.exchange_depths = depths
        self.exchange_every = max(depths)

    def set_wire_format(self, fmt) -> None:
        """Per-axis halo wire format: ``"f32"`` (identity, the default),
        ``"bf16"``, ``"e4m3"`` or ``"e5m2"`` (float32 halos narrow at the
        send boundary and widen back on arrival; halo math is unchanged,
        every field keeps its storage dtype), or a per-axis dict like
        ``{"y": "bf16"}``. A narrowing format realizes only behind a
        ``safe`` ``PrecisionCertificate`` (``realize()`` raises
        ``PrecisionGateError`` otherwise) and only with the PpermuteSlab
        and PpermutePacked methods. Validated here; after ``realize()``
        it raises ``AssertionError``, as JAX's does."""
        if self.mesh is not None:
            raise AssertionError("set_wire_format before realize()")
        normalize_wire_format(fmt)
        self.wire_format = fmt

    def set_wire_layout(self, layout: str) -> None:
        """Halo message layout: ``"slab"`` (the default — each sweep
        ships the full cross-section of the allocation) or
        ``"irredundant"`` (one box a direction that carries each halo
        cell once, ``parallel/packing.py``). Supported by the
        PpermuteSlab and PpermutePacked methods only. Validated here;
        after ``realize()`` it raises ``AssertionError``, as JAX's
        does."""
        if self.mesh is not None:
            raise AssertionError("set_wire_layout before realize()")
        normalize_wire_layout(layout)
        self.wire_layout = layout

    def set_mesh_shape(self, shape: Dim3Like) -> None:
        """Explicit subdomain-grid shape (the reference's set_gpus
        analog; a repeated device list plays its set_gpus({0,0}))."""
        self._mesh_shape = Dim3.of(shape)

    def set_placement(self, mode: str) -> None:
        """Placement mode ``"auto"`` | ``"trivial"`` | ``"qap"`` (the
        last raises at realize(): ROADMAP A5)."""
        self.placement_mode = normalize_placement_mode(mode)

    def set_dcn_axis(self, axis: Union[int, str, None] = None,
                     groups=None) -> None:
        """Enable the host tier (JAX ``distributed.py:223-239``; the
        reference's NodePartition, partition.hpp:120-256): one grid axis
        is blocked across hosts, so that only its halo sweep crosses
        between them while the others stay on a host's NVLink.

        ``axis``: 0/'x', 1/'y', 2/'z', or None/'auto' to let realize()
        choose it with the mesh shape. ``groups`` injects the device
        grouping (lists of this domain's devices, one per host; tests
        group ranks of one machine so); otherwise
        ``multihost.slice_groups`` groups the devices by host."""
        if self.mesh is not None:
            raise RuntimeError("set_dcn_axis before realize()")
        if isinstance(axis, str):
            axis = {"x": 0, "y": 1, "z": 2, "auto": None}[axis]
        self._dcn_requested = True
        self._dcn_axis_req = axis
        self._dcn_groups = groups

    def _discover_dcn_groups(self):
        """The host groups of the DCN tier (None when none was
        requested); sets ``n_slices``."""
        if not self._dcn_requested:
            return None
        from .parallel.multihost import slice_groups

        groups = self._dcn_groups or slice_groups(self._global)
        self.n_slices = len(groups)
        return groups

    def _choose_partition_dim(self) -> Dim3:
        """The subdomain grid realize() uses: the explicit mesh shape,
        else with the DCN tier the planner's cheapest candidate (or
        NodePartition's two-level split when no exact candidate admits
        the host blocking), else an exact factorization of the device
        count, else the reference's greedy split with +-1 remainder
        subdomains (JAX ``distributed.py:330-368``). Also resolves the
        DCN axis."""
        n = len(self._devices)
        self._discover_dcn_groups()
        if self._mesh_shape is not None:
            dim = self._mesh_shape
            if dim.flatten() != n:
                raise ValueError(f"mesh shape {dim} != device count {n}")
        elif self._dcn_requested and self.n_slices > 1:
            dim = self._plan_dcn_partition(n)
            if dim is None:
                npart = NodePartition(self.size, self.radius,
                                      self.n_slices, n // self.n_slices)
                dim = npart.dim()
                if self.size % dim != Dim3(0, 0, 0):
                    try:
                        dim = partition_dims_even(self.size, n)
                    except ValueError:
                        dim = RankPartition(self.size, n).dim()
        else:
            try:
                dim = partition_dims_even(self.size, n)
            except ValueError:
                dim = RankPartition(self.size, n).dim()
        if self._dcn_requested:
            self.dcn_axis = self._pick_dcn_axis(dim)
        return dim

    def _plan_dcn_partition(self, n: int) -> Optional[Dim3]:
        """The hierarchical partition planner (JAX
        ``distributed.py:370-407``): every exact factorization of the
        device count times every host-admissible axis, priced per step
        by ``costmodel.asymmetric_step_seconds`` (the axis on the
        inter-host link, the temporal depths included), the cheapest
        kept — ties to the most cube-like grid, then the lowest axis.
        None when no exact candidate admits the host blocking
        (``dim[axis] % n_slices == 0``); the axis lands in
        ``_dcn_axis_planned``."""
        from .analysis.costmodel import asymmetric_step_seconds

        elem_sizes = [self._dtypes[q].itemsize for q in self._names] or [4]
        method = pick_method(self.methods).name
        best = None
        for dim in exact_partition_candidates(self.size, n):
            axes = ([self._dcn_axis_req] if self._dcn_axis_req is not None
                    else range(3))
            for a in axes:
                if dim[a] % self.n_slices != 0:
                    continue
                local = self.size // dim
                seconds = asymmetric_step_seconds(
                    method, (local.z, local.y, local.x), self.radius,
                    dim, elem_sizes, self.exchange_depths, dcn_axis=a,
                    wire_format=self.wire_format,
                    wire_layout=self.wire_layout)
                key = (seconds, tuple(sorted(tuple(dim), reverse=True)),
                       tuple(dim), a)
                if best is None or key < best[0]:
                    best = (key, dim, a)
        if best is None:
            return None
        _, dim, axis = best
        self._dcn_axis_planned = axis
        return dim

    def _pick_dcn_axis(self, dim: Dim3) -> int:
        """The mesh axis blocked across hosts: the requested one
        (validated), else the planner's, else the divisible axis of the
        smallest interface area (JAX ``distributed.py:578-609``)."""
        ns = self.n_slices
        if self._dcn_axis_req is not None:
            a = self._dcn_axis_req
            if ns > 1 and dim[a] % ns != 0:
                raise ValueError(f"dcn axis {a} has {dim[a]} mesh rows, "
                                 f"not divisible by {ns} slices")
            return a
        if self._dcn_axis_planned is not None \
                and (ns <= 1 or dim[self._dcn_axis_planned] % ns == 0):
            return self._dcn_axis_planned
        cands = [a for a in range(3) if ns <= 1 or dim[a] % ns == 0]
        if not cands:
            raise ValueError(f"no mesh axis of {dim} divisible by "
                             f"{ns} slices; set_mesh_shape or "
                             f"set_dcn_axis explicitly")
        sizes = [self.size.x, self.size.y, self.size.z]

        def iface(a):
            other = [sizes[b] for b in range(3) if b != a]
            return other[0] * other[1]

        return min(cands, key=iface)

    def _choose_placement(self, dim: Dim3, groups) -> Placement:
        """The placement realize() deploys for ``dim``: with the DCN
        tier the host-blocked device order, which a contradictory
        placement mode cannot override (JAX ``distributed.py:409-437``);
        else ``make_placement``."""
        part = RankPartition.from_dim(self.size, dim)
        if self._dcn_requested and self.n_slices > 1:
            if self.placement_mode != "auto":
                raise ValueError(
                    f"placement mode {self.placement_mode!r} is "
                    f"incompatible with the DCN tier (host blocking "
                    f"determines the placement)")
            from .parallel.multihost import multihost_device_order

            return Placement(part, multihost_device_order(
                dim, self.dcn_axis, groups=groups))
        return make_placement(part, self._global, mode=self.placement_mode)

    def realize(self) -> None:
        """Partition the grid, place the shards and allocate zeroed
        halo-padded ``curr`` shards at capacity on their devices
        (``next_`` allocates on first ``swap``), and price the
        exchange. On a mesh that spans processes only this rank's shards
        are allocated; ``curr[q]`` holds None at the other positions."""
        if not self._names:
            raise ValueError("add_data at least one quantity before "
                             "realize()")
        if self.boundary not in (Boundary.PERIODIC, Boundary.NONE):
            raise NotImplementedError(f"unsupported boundary {self.boundary}")
        method = pick_method(self.methods)
        slab = method in WIRE_CAPABLE
        if self.boundary == Boundary.NONE and not slab:
            raise NotImplementedError(
                "Boundary.NONE (zero-Dirichlet exterior) is supported by "
                "the PpermuteSlab and PpermutePacked methods only")
        wire_narrows = any(v != "f32" for v in
                           normalize_wire_format(self.wire_format).values())
        if wire_narrows and not slab:
            raise NotImplementedError(
                f"wire_format {self.wire_format!r} narrows the halo "
                f"wire, supported only by the PpermuteSlab and "
                f"PpermutePacked methods")
        wire_layout = normalize_wire_layout(self.wire_layout)
        if wire_layout != "slab" and not slab:
            raise NotImplementedError(
                f"wire_layout {self.wire_layout!r} is supported only "
                f"by the PpermuteSlab and PpermutePacked methods")
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
        # temporal blocking: allocations and the exchange depth come
        # from the DEEPENED radius (one depth-(s_a*r) exchange per axis
        # feeds s_a steps); s == 1 collapses to the base radius
        self.alloc_radius = self.radius.deepened(self.exchange_depths)
        if self.exchange_every > 1 and not slab:
            raise NotImplementedError(
                f"exchange_every > 1 is supported by the PpermuteSlab "
                f"and PpermutePacked methods, not {method}")
        d = self.exchange_depths
        if not d.x == d.y == d.z and wire_layout != "slab":
            raise NotImplementedError(
                f"asymmetric temporal depths {tuple(d)} decline "
                f"wire_layout {self.wire_layout!r}: the irredundant "
                f"dedup plan assumes one group-wide exchange (see "
                f"parallel/temporal.py)")
        min_local = [self.local_size[a] - (1 if self.rem[a] else 0)
                     for a in range(3)]
        if any(m < 1 for m in min_local):
            raise ValueError(f"zero-extent subdomains: grid {self.size} "
                             f"over mesh {dim}")
        if any(min_local[a] < self.alloc_radius.face(a, 1) or
               min_local[a] < self.alloc_radius.face(a, -1)
               for a in range(3)):
            raise ValueError(f"subdomain {min_local} smaller than "
                             f"(deepened) radius {self.alloc_radius}")
        self.placement = self._choose_placement(
            dim, self._discover_dcn_groups())
        self.mesh = Mesh(dim, self.placement.slot_order_for_mesh())
        self.mesh_counts = dim
        self.topology = Topology(dim, self.boundary)
        shape = zyx_shape(raw_size(self.local_size, self.alloc_radius))
        own = set(self.mesh.local_positions)
        for q in self._names:
            self.curr[q] = [torch.zeros(shape, dtype=self._dtypes[q],
                                        device=d) if i in own else None
                            for i, d in enumerate(self.mesh.devices)]
        self.next_ = {}
        # the DEEP exchange (wire depth s*r) when exchange_every > 1; a
        # narrowing wire format runs make_exchange's precision gate, a
        # probe exchange on "meta" shards of these specs
        self._exchange_fn = make_exchange(
            self.mesh, self.alloc_radius, self.methods, rem=self.rem,
            nonperiodic=self.boundary == Boundary.NONE,
            wire_format=self.wire_format, wire_layout=wire_layout,
            fields_spec={q: (shape, self._dtypes[q]) for q in self._names})
        self._bytes_per_axis = {"x": 0, "y": 0, "z": 0}
        for q in self._names:
            es = self._dtypes[q].itemsize
            if wire_layout == "irredundant":
                b = irredundant_bytes_per_sweep(
                    shape, self.alloc_radius, dim, es,
                    wire_format=self.wire_format)
            else:
                b = exchanged_bytes_per_sweep(
                    shape, self.alloc_radius, dim, es,
                    wire_format=self.wire_format)
            for k in b:
                self._bytes_per_axis[k] += b[k]
        dcn = (f", dcn axis {'xyz'[self.dcn_axis]}x{self.n_slices}"
               if self.dcn_axis is not None and self.n_slices > 1 else "")
        ranks = (f", ranks {sorted(set(self.mesh.ranks))}"
                 if self.mesh.spans_ranks else "")
        LOG_INFO(f"realized {self.size} over mesh {dim} (local "
                 f"{self.local_size}, padded "
                 f"{raw_size(self.local_size, self.alloc_radius)}, method "
                 f"{method}, devices "
                 f"{sorted(set(str(d) for d in self.mesh.devices))}"
                 f"{ranks}{dcn})")

    # -- iteration ------------------------------------------------------
    def exchange(self) -> None:
        """Fill all halos of every quantity's ``curr`` shards, in place,
        by the method ``pick_method(self.methods)`` chooses, at the wire
        format and layout set (reference: src/stencil.cu:1002-1186): the
        deep halo of the allocation when ``exchange_every > 1``."""
        if self.local_size is None:
            raise RuntimeError("realize() first")
        self._exchange_fn(self.curr)

    def swap(self) -> None:
        """Swap curr/next bindings (reference: src/local_domain.cu:67-84);
        ``next_`` shards are created on first use."""
        if not self.next_:
            self.next_ = {q: [None if t is None else torch.zeros_like(t)
                              for t in v]
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
        shard. Shard ``i`` must be this process's."""
        t = self.curr[name][i]
        if t is None:
            raise ValueError(f"mesh position {i} is owned by rank "
                             f"{self.mesh.ranks[i]}, not this one "
                             f"({self.mesh.rank})")
        return t[interior_slices(self.shard_size(i), self.alloc_radius)]

    @property
    def precision_certificate(self):
        """The realized exchange's ``PrecisionCertificate``
        (``analysis/precision.py``), or None for an all-f32 wire, which
        runs no gate."""
        return getattr(self._exchange_fn, "precision_certificate", None)

    # -- observability (reference: stencil.hpp:86-93) -------------------
    def exchange_bytes_per_axis(self) -> Dict[str, int]:
        """Bytes one shard sends to other shards per exchange, per mesh
        axis: 0 on a one-device axis, whose wraps are local copies."""
        return dict(self._bytes_per_axis)

    def exchange_bytes_total(self) -> int:
        """Bytes per exchange over the whole mesh (the DEEP exchange
        when ``exchange_every > 1``)."""
        return sum(v * self.mesh_counts.flatten()
                   for v in self._bytes_per_axis.values())

    def exchange_bytes_dcn(self) -> int:
        """Bytes per exchange crossing between hosts, whole mesh: along
        the DCN axis, ``n_slices`` of the ``counts[axis]`` periodic shard
        boundaries are inter-host (JAX ``distributed.py:722-732``)."""
        if self.dcn_axis is None or self.n_slices <= 1:
            return 0
        c = self.mesh_counts[self.dcn_axis]
        per_shard = self._bytes_per_axis["xyz"[self.dcn_axis]]
        return per_shard * self.mesh_counts.flatten() * self.n_slices // c

    def exchange_bytes_ici(self) -> int:
        """Bytes per exchange that stay within a host."""
        return self.exchange_bytes_total() - self.exchange_bytes_dcn()

    def exchange_bytes_amortized_per_step(self) -> float:
        """Whole-mesh bytes per STEP under temporal blocking: the deep
        exchange's bytes over the ``exchange_every`` steps it feeds (the
        total when s == 1); per-axis depths amortize each axis over its
        own refresh period ``s_a`` (JAX ``distributed.py:707-720``)."""
        d = self.exchange_depths
        if d.x == d.y == d.z:
            return self.exchange_bytes_total() / self.exchange_every
        n = self.mesh_counts.flatten()
        return sum(self._bytes_per_axis[name] * n / d[a]
                   for a, name in ((0, "x"), (1, "y"), (2, "z")))

    # -- IO (reference: src/stencil.cu:1188-1264) -----------------------
    def assemble_interior(self, shards: Sequence,
                          dtype=None) -> np.ndarray:
        """The global (z,y,x) interior from padded shards laid out like
        this domain's (tensors or arrays, x fastest), on the host;
        bfloat16, which numpy lacks, as float32 of the same values. On a
        mesh that spans processes a collective: ``shards`` holds this
        rank's (None elsewhere), ``dtype`` is theirs (default: that of
        this rank's first), and every rank gets the whole array."""
        return self.gather_blocks(
            [None if s is None else s[interior_slices(self.shard_size(i),
                                                      self.alloc_radius)]
             for i, s in enumerate(shards)], dtype)

    def gather_blocks(self, blocks: Sequence, dtype=None) -> np.ndarray:
        """The global (z,y,x) array from each position's live block
        (``shard_size(i)``, x fastest: tensors or arrays), on the host,
        bfloat16 as float32. A collective on a mesh that spans processes
        (``multihost.broadcast_blocks``): ``blocks`` holds this rank's,
        None elsewhere, and every rank gets the whole array."""
        def host(blk):
            if isinstance(blk, torch.Tensor):
                if blk.dtype == torch.bfloat16:
                    blk = blk.float()
                return blk.cpu().numpy()
            return np.asarray(blk)

        if self.mesh is not None and self.mesh.spans_ranks:
            from .parallel.multihost import broadcast_blocks

            mine = [b for b in blocks if b is not None]
            dt = torch_dtype(dtype) if dtype is not None else mine[0].dtype
            wire = torch.float32 if dt == torch.bfloat16 else dt
            local = [None if b is None else
                     torch.as_tensor(b).to(wire) for b in blocks]
            blocks = broadcast_blocks(
                local, [zyx_shape(self.shard_size(i))
                        for i in range(len(blocks))],
                wire, self.mesh.ranks, self.device)
        out = None
        for i, b in enumerate(blocks):
            sz = self.shard_size(i)
            org = self.shard_origin(i)
            blk = host(b)
            if out is None:
                out = np.empty(zyx_shape(self.size), dtype=blk.dtype)
            out[org.z:org.z + sz.z, org.y:org.y + sz.y,
                org.x:org.x + sz.x] = blk
        return out

    def interior_to_host(self, name: str) -> np.ndarray:
        """The global interior (z,y,x-ordered) as a numpy array (a
        collective on a mesh that spans processes)."""
        return self.assemble_interior(self.curr[name], self._dtypes[name])

    def on_interior_write(self, cb: Callable[[str], None]) -> None:
        """Register a callback that ``set_interior`` calls, with the
        field's name, before it writes: the hook a model with state kept
        outside ``curr`` uses to flush it first (stencil_tpu/
        distributed.py:841-845)."""
        self._on_interior_write.append(cb)

    def set_interior(self, name: str, values) -> None:
        """Scatter a global (z,y,x) interior (numpy array or tensor) into
        the shards of ``curr[name]``; halos and dead capacity rows are
        zeroed. The ``on_interior_write`` callbacks run first. On a mesh
        that spans processes each rank writes its own shards."""
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
            if dst is None:
                continue
            sz = self.shard_size(i)
            org = self.shard_origin(i)
            dst.zero_()
            dst[interior_slices(sz, self.alloc_radius)].copy_(
                values[org.z:org.z + sz.z, org.y:org.y + sz.y,
                       org.x:org.x + sz.x])
