"""Placement: mapping subdomain indices onto devices.

PyTorch-port counterpart of ``stencil_tpu/placement.py`` (reference:
include/stencil/partition.hpp:258-831, placement_intranoderandom.hpp): a
bijection between subdomain index (Dim3) and a device, chosen to put
heavy halo traffic on fast links.

Strategies (``PlacementStrategy``), as in the JAX package:

* ``Trivial`` — subdomain ``i`` (x fastest) on ``devices[i]``;
* ``IntraNodeRandom`` — a seeded shuffle, the experimental control;
* ``NodeAware`` (the default) — the devices sorted
  (``parallel/mesh.device_sorted``, the counterpart of JAX's torus
  sort), then, when the fabric is non-uniform or ``mode="qap"`` asks for
  it, the assignment refined by a QAP solve (``qap.py``) of the
  halo-bytes x distance objective, clamped so that it never costs more
  than the identity.

A CUDA device has no physical torus coordinates, so the distances are
uniform (every card of an NVSwitch host one hop from every other), and
``mode="auto"`` keeps the sorted order there, as JAX's does on a
coordless fabric. ``mode="qap"``, or a DCN-blocked axis, takes the
synthetic lattice distances of ``mesh_distance_matrix``
(``observatory/linkmap.py``: wrapped-torus hops over the shard lattice
plus a penalty across hosts). A device may
be a ``parallel/mesh.GlobalDevice`` (a mesh over processes); the
placement keeps its owner rank.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence

import numpy as np

from . import qap
from .geometry import Dim3, Dim3Like, Radius, all_directions
from .local_domain import halo_bytes
from .observatory.linkmap import mesh_distance_matrix
from .parallel.mesh import GlobalDevice, as_global, device_sorted
from .partition import RankPartition
from .topology import Topology


class PlacementStrategy(enum.Enum):
    """reference: include/stencil/partition.hpp:258-262."""

    NodeAware = "node-aware"
    Trivial = "trivial"
    IntraNodeRandom = "random"


def iter_messages(part: RankPartition, radius: Radius,
                  elem_sizes: Sequence[int],
                  topo: Optional[Topology] = None):
    """Yield every planned cross-subdomain halo message as ``(i, j,
    direction, bytes)`` — the one source of the comm matrix and the plan
    file's per-message lines (reference: src/stencil.cu:523-637 plans
    one message per direction). ``topo`` carries the boundary condition;
    periodic by default."""
    if topo is None:
        topo = Topology(part.dim())
    n = part.dim().flatten()
    for i in range(n):
        idx = part.dimensionize(i)
        for d in all_directions():
            if radius.dir(-d) == 0:
                # no send in d when the opposite radius is zero
                # (reference: src/stencil.cu:344)
                continue
            nbr = topo.get_neighbor(idx, d)
            if not nbr.exists:
                continue
            j = part.linearize(nbr.index)
            if i == j:
                continue  # a wrap onto the same subdomain is local
            dst_size = part.subdomain_size(nbr.index)
            nbytes = sum(halo_bytes(-d, dst_size, radius, es)
                         for es in elem_sizes)
            yield i, j, d, nbytes


def comm_bytes_matrix(part: RankPartition, radius: Radius,
                      elem_sizes: Sequence[int],
                      topo: Optional[Topology] = None) -> np.ndarray:
    """Subdomain-pair halo bytes, the "w" matrix of the QAP (reference:
    partition.hpp:722-752): entry [i, j] = bytes subdomain i sends
    subdomain j per exchange, over every quantity and direction."""
    n = part.dim().flatten()
    w = np.zeros((n, n), dtype=np.float64)
    for i, j, _, nbytes in iter_messages(part, radius, elem_sizes, topo):
        w[i, j] += nbytes
    return w


def torus_distance_matrix(devices: Sequence) -> np.ndarray:
    """Device-pair distance: the L1 hop count over physical torus
    coordinates where every device exposes ``coords``, else uniform
    distance 1 (reference: src/gpu_topology.cpp:17-95,
    bandwidth = 1/distance). Port devices have no coordinates."""
    n = len(devices)
    coords = []
    for d in devices:
        c = getattr(d, "coords", None)
        if c is None or len(c) < 3:
            coords = None
            break
        coords.append(tuple(c))
    dist = np.ones((n, n), dtype=np.float64)
    np.fill_diagonal(dist, 0.0)
    if coords is None:
        return dist
    for i in range(n):
        for j in range(n):
            if i != j:
                dist[i, j] = sum(abs(a - b)
                                 for a, b in zip(coords[i], coords[j]))
    return dist


class Placement:
    """Bijection subdomain index <-> device slot (reference:
    partition.hpp:264-289): subdomain with linear id ``i`` (x fastest,
    ``part.linearize``) runs on ``devices[assignment[i]]``."""

    def __init__(self, part: RankPartition, devices: Sequence,
                 assignment: Optional[List[int]] = None) -> None:
        self.part = part
        self.slots: List[GlobalDevice] = [as_global(d) for d in devices]
        self.devices = [g.device for g in self.slots]
        n = part.dim().flatten()
        if len(self.devices) != n:
            raise ValueError(f"{len(self.devices)} devices for {n} "
                             f"subdomains")
        self.assignment = assignment or list(range(n))

    def dim(self) -> Dim3:
        return self.part.dim()

    def get_device(self, idx: Dim3Like) -> GlobalDevice:
        """The device (with its owner rank) hosting subdomain ``idx``
        (the reference's get_cuda)."""
        i = self.part.linearize(Dim3.of(idx))
        return self.slots[self.assignment[i]]

    def get_idx(self, device) -> Dim3:
        """The subdomain index hosted by ``device`` (the reference's
        get_idx): the first slot that holds it."""
        slot = self.slots.index(as_global(device))
        return self.part.dimensionize(self.assignment.index(slot))

    def subdomain_size(self, idx: Dim3Like) -> Dim3:
        return self.part.subdomain_size(Dim3.of(idx))

    def subdomain_origin(self, idx: Dim3Like) -> Dim3:
        return self.part.subdomain_origin(Dim3.of(idx))

    def slot_order_for_mesh(self) -> List[GlobalDevice]:
        """Devices with their owner ranks, ordered by subdomain linear
        index (x fastest), for ``parallel.mesh.Mesh``."""
        return [self.slots[self.assignment[i]]
                for i in range(len(self.slots))]


#: placement modes of the NodeAware strategy
#: (``DistributedDomain.set_placement`` / ``Jacobi3D(placement=...)``):
#: "auto" deploys the QAP assignment only on a non-uniform fabric,
#: "qap" and "trivial" force one side
PLACEMENT_MODES = ("auto", "qap", "trivial")


def normalize_placement_mode(mode: Optional[str]) -> str:
    m = "auto" if mode is None else str(mode)
    if m not in PLACEMENT_MODES:
        raise ValueError(f"unknown placement mode {mode!r} "
                         f"(expected one of {PLACEMENT_MODES})")
    return m


def make_placement(strategy: PlacementStrategy, part: RankPartition,
                   devices: Sequence, radius: Radius,
                   elem_sizes: Sequence[int], seed: int = 0,
                   qap_timeout_s: float = 2.0, mode: str = "auto",
                   dcn_axis: Optional[int] = None,
                   n_slices: int = 1) -> Placement:
    """Construct a placement (reference: src/stencil.cu:201-239; JAX
    ``placement.py:172-237``).

    * Trivial: subdomain i -> device i in the order given.
    * IntraNodeRandom: a shuffle seeded by ``seed``.
    * NodeAware: the sorted devices, refined by a QAP solve when the
      fabric is non-uniform — a spread in the device distances, or a
      DCN-blocked axis (``dcn_axis``/``n_slices``), where coordless
      devices take ``mesh_distance_matrix``'s synthetic distances — or
      always under ``mode="qap"``; ``mode="trivial"`` keeps the sorted
      order. Up to 8 subdomains the exact solver runs, beyond it the
      hill climb; an order costlier than the identity is never shipped.
    """
    n = part.dim().flatten()
    mode = normalize_placement_mode(mode)
    if strategy == PlacementStrategy.Trivial:
        return Placement(part, list(devices))
    if strategy == PlacementStrategy.IntraNodeRandom:
        rng = np.random.default_rng(seed)
        assignment = list(rng.permutation(n))
        return Placement(part, list(devices), [int(a) for a in assignment])
    devs = device_sorted(devices)
    if n <= 1 or mode == "trivial":
        return Placement(part, devs)
    dist = torus_distance_matrix(devs)
    offdiag = dist[~np.eye(n, dtype=bool)]
    measured_nonuniform = not np.all(offdiag == offdiag[0])
    dcn_blocked = dcn_axis is not None and int(n_slices) > 1
    if not measured_nonuniform and (dcn_blocked or mode == "qap"):
        dist = mesh_distance_matrix(part.dim(), dcn_axis=dcn_axis,
                                    n_slices=n_slices)
        offdiag = dist[~np.eye(n, dtype=bool)]
    nonuniform = not np.all(offdiag == offdiag[0])
    if mode == "auto" and not nonuniform:
        return Placement(part, devs)
    w = comm_bytes_matrix(part, radius, elem_sizes)
    if n <= 8:
        f, _ = qap.solve(w, dist, timeout_s=qap_timeout_s)
    else:
        f, _ = qap.solve_catch(w, dist)
    f = [int(i) for i in f]
    identity = list(range(n))
    if qap.cost(w, dist, f) > qap.cost(w, dist, identity):
        f = identity  # never ship a costlier-than-trivial order
    return Placement(part, devs, f)
