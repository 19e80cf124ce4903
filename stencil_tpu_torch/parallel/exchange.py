"""The halo-exchange engine over a mesh of shards.

PyTorch-port counterpart of ``stencil_tpu/parallel/exchange.py``. The
JAX engine runs inside ``shard_map``: every shard traces the same
program and ``lax.ppermute`` moves a slab from each shard to its
neighbour along one mesh axis. The port holds all shards in one process
(``parallel/mesh.py``), so a shift is a loop over the mesh positions
that copies each neighbour's slab into this shard (a device-to-device
``copy_`` when the two lie on different devices, a local copy when they
share one; on a one-device axis the neighbour is the shard itself).

* ``exchange_shard`` fills the halos of the padded shards in place, by
  three sequential axis sweeps, x, then y, then z; each slab spans the
  full allocation of the other two axes, so edge and corner data ride
  along (reference src/stencil.cu:1002-1186 collapsed as in SURVEY §7).
* ``exchange_interior_slabs`` returns, per shard, the four slab tensors
  the halo kernels read (``ops/cuda_halo.py``), leaving the shards as
  they are.
* ``dispatch_exchange`` routes a multi-quantity exchange by
  ``Method``: ``PallasDMA`` to the remote-write kernel
  (``parallel/cuda_exchange.py``, B4), every other transport to
  ``exchange_shard``'s slab copy.

Both keep the JAX functions' arguments, with the list of shards (x
fastest, the order of ``Mesh.devices``) in place of the one traced
shard, so that tests feed both packages the same values. Unlike the JAX
version, ``exchange_shard`` updates the shards IN PLACE.

Within one sweep every source is interior and every destination halo,
so the copies of one direction may run in any order, on shards that
share a device or not. On distinct CUDA devices a cross-device
``copy_`` is ordered after the work already queued on both devices'
current streams, and every kernel launches on its own shard's device and
current stream (``ops/_build.launch``), so a copy out of a shard waits
for the kernel that wrote it and the next kernel for the copies into
its slabs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..geometry import Dim3, Radius
from .mesh import mesh_index, mesh_neighbor

# grid axis index -> tensor dimension of a (z,y,x)-ordered field
AXIS_TO_DIM = {0: 2, 1: 1, 2: 0}
AXIS_NAME = {0: "x", 1: "y", 2: "z"}


def shard_interior_len(axis: int, capacity: int, rem: Dim3,
                       index: int = 0) -> int:
    """The actual interior extent along ``axis`` of the shard at mesh
    position ``index`` on that axis: the +-1 remainder rule (reference:
    partition.hpp:55-69) — the first ``rem`` shards hold ``capacity``
    points, the rest one fewer. The JAX version reads ``index`` from
    ``lax.axis_index`` inside ``shard_map``; here the caller passes it."""
    r = rem[axis]
    if r == 0:
        return capacity
    return capacity - (1 if index >= r else 0)


def shard_origin(local: Dim3, rem: Dim3,
                 index: Dim3 = Dim3(0, 0, 0)) -> Tuple[int, int, int]:
    """(ox, oy, oz) global origin of the shard at mesh position
    ``index`` (reference: partition.hpp:71-86 _remainder_origin).
    ``local`` is the per-shard capacity (ceil sizes)."""
    out = []
    for a in range(3):
        i = index[a]
        o = i * local[a]
        if rem[a] != 0:
            o -= max(i - rem[a], 0)
        out.append(o)
    return tuple(out)


def _as_list(shards: Sequence[torch.Tensor],
             counts: Dim3) -> List[torch.Tensor]:
    out = list(shards)
    if len(out) != counts.flatten():
        raise ValueError(f"{len(out)} shards for a {tuple(counts)} mesh")
    return out


def exchange_shard(shards: Sequence[torch.Tensor], radius: Radius,
                   mesh_counts: Dim3 = Dim3(1, 1, 1),
                   axis_order: Tuple[int, ...] = (0, 1, 2),
                   rem: Dim3 = Dim3(0, 0, 0),
                   alloc_radius: "Radius | None" = None,
                   nonperiodic: bool = False) -> Sequence[torch.Tensor]:
    """Fill all halo regions of the padded (z,y,x) shards of a mesh (x
    fastest) via sequential axis sweeps, in place; returns ``shards``.
    Per axis the hi-side halo is filled first, then the lo side, as in
    the JAX engine (``stencil_tpu/parallel/exchange.py:288-332``):

    * hi halo ``[p_lo + L, p_lo + L + r_hi)`` <- the +neighbour's
      interior lo edge ``[p_lo, p_lo + r_hi)``;
    * lo halo ``[p_lo - r_lo, p_lo)`` <- the -neighbour's interior hi
      edge ``[p_lo + L' - r_lo, p_lo + L')``,

    where ``L`` is this shard's actual interior length along the axis
    and ``L'`` the neighbour's (``rem``: uneven +-1 shards are allocated
    at capacity, and a short shard's hi halo sits right after its actual
    interior). ``alloc_radius``: the allocation's Radius when it pads
    deeper than this exchange's wire depth (default: ``radius``).
    ``nonperiodic``: zero-fill the halos across the open global boundary
    (``Boundary.NONE``); on a one-device axis every halo is exterior."""
    counts = Dim3.of(mesh_counts)
    arrs = _as_list(shards, counts)
    alloc_r = alloc_radius if alloc_radius is not None else radius
    for a in axis_order:
        r_lo = radius.face(a, -1)
        r_hi = radius.face(a, 1)
        if r_lo == 0 and r_hi == 0:
            continue
        p_lo = alloc_r.face(a, -1)
        p_hi = alloc_r.face(a, 1)
        if p_lo < r_lo or p_hi < r_hi:
            raise ValueError(f"axis {a}: wire depth ({r_lo},{r_hi}) "
                             f"exceeds allocation pads ({p_lo},{p_hi})")
        dim = AXIS_TO_DIM[a]
        n_dev = counts[a]
        cap = arrs[0].shape[dim] - p_lo - p_hi
        lens = [shard_interior_len(a, cap, rem, mesh_index(i, counts)[a])
                for i in range(len(arrs))]
        for side, r in ((1, r_hi), (-1, r_lo)):
            if r == 0:
                continue
            for i, arr in enumerate(arrs):
                start = p_lo + lens[i] if side == 1 else p_lo - r
                dst = arr.narrow(dim, start, r)
                pos = mesh_index(i, counts)[a]
                edge = pos == (n_dev - 1 if side == 1 else 0)
                if nonperiodic and (n_dev == 1 or edge):
                    dst.zero_()
                    continue
                j = mesh_neighbor(i, counts, a, side)
                src_start = p_lo if side == 1 else p_lo + lens[j] - r
                src = arrs[j].narrow(dim, src_start, r)
                dst.copy_(src.clone() if j == i else src)
    return shards


def exchange_interior_slabs(shards: Sequence[torch.Tensor],
                            mesh_counts: Dim3,
                            rz: int, ry: int, radius_rows: int = 0,
                            y_z_extended: bool = False,
                            rem: Dim3 = Dim3(0, 0, 0)
                            ) -> List[Dict[str, torch.Tensor]]:
    """The halo SLABS of the interior-resident (unpadded) shards of a
    mesh: the data plane of the halo kernels (``ops/cuda_halo.py``,
    ``ops/cuda_mhd.py``). Returns, per shard (x fastest), ``{"zlo",
    "zhi", "ylo", "yhi"}`` on that shard's device; the shards are not
    changed. The JAX function's alignment contract, per shard:

    * ``zlo`` (rz, Y, X): the z-minus neighbour's TOP rows, right-
      aligned (the row adjacent to this shard is ``zlo[-1]``);
    * ``zhi`` (rz, Y, X): the z-plus neighbour's BOTTOM rows, left-
      aligned (adjacent row ``zhi[0]``);
    * ``ylo`` / ``yhi``: the y-minus (y-plus) neighbour's LAST (FIRST)
      rows, right-/left-aligned in an ry-row buffer — shape (Z, ry, X),
      or (Z + 2*rz, ry, X) when ``y_z_extended``: the y sources then
      span the z halo too (the neighbour's own interior plus the z slabs
      it received), so yz edge and corner data ride along.

    A shard may carry leading batch dimensions, (..., Z, Y, X), such as
    the 8 fields of an MHD state in one (8, Z, Y, X) tensor; its slabs
    then carry the same ones, and each slice moves every field at once.

    ``radius_rows`` (default ``min(rz, ry)``) rows cross between shards;
    the rest of each buffer is zero filler. On a one-device mesh axis the
    neighbour is the shard itself (periodic). x must not be sharded.
    ``rem``: uneven (+-1) shards are capacity-sized, so the hi-edge sends
    come from each shard's ACTUAL last rows; not with ``y_z_extended``.
    """
    counts = Dim3.of(mesh_counts)
    if counts.x != 1:
        raise ValueError("exchange_interior_slabs: x must not be sharded "
                         f"(mesh {tuple(counts)})")
    arrs = _as_list(shards, counts)
    lead = tuple(arrs[0].shape[:-3])
    Z, Y, X = arrs[0].shape[-3:]
    r = radius_rows or min(rz, ry)
    if not (r <= rz and r <= ry):
        raise ValueError(f"radius_rows {r} exceeds rz={rz} or ry={ry}")
    if rem != Dim3(0, 0, 0) and y_z_extended:
        raise ValueError("uneven shards unsupported with z-extended y slabs")
    n = len(arrs)
    idx = [mesh_index(i, counts) for i in range(n)]
    Lz = [shard_interior_len(2, Z, rem, idx[i].z) for i in range(n)]
    Ly = [shard_interior_len(1, Y, rem, idx[i].y) for i in range(n)]

    def to(t: torch.Tensor, i: int) -> torch.Tensor:
        return t.to(arrs[i].device, copy=True)

    # r-row transfers: zlo from the z-minus neighbour's actual top rows,
    # zhi from the z-plus neighbour's bottom rows
    zlo_r = [to(arrs[j].narrow(-3, Lz[j] - r, r), i) for i, j in
             ((i, mesh_neighbor(i, counts, 2, -1)) for i in range(n))]
    zhi_r = [to(arrs[j].narrow(-3, 0, r), i) for i, j in
             ((i, mesh_neighbor(i, counts, 2, 1)) for i in range(n))]
    if y_z_extended:
        def ysrc(j: int, lo: bool) -> torch.Tensor:
            y0 = 0 if lo else Y - r
            return torch.cat([t.narrow(-2, y0, r) for t in
                              (zlo_r[j], arrs[j], zhi_r[j])], dim=-3)
        zoff = rz - r
    else:
        def ysrc(j: int, lo: bool) -> torch.Tensor:
            return arrs[j].narrow(-2, 0 if lo else Ly[j] - r, r)
        zoff = 0
    ylo_r = [to(ysrc(mesh_neighbor(i, counts, 1, -1), False), i)
             for i in range(n)]
    yhi_r = [to(ysrc(mesh_neighbor(i, counts, 1, 1), True), i)
             for i in range(n)]

    def zembed(recv: torch.Tensor, align_hi: bool) -> torch.Tensor:
        if rz == r:
            return recv
        pad = recv.new_zeros(lead + (rz - r, Y, X))
        return torch.cat([pad, recv] if align_hi else [recv, pad], dim=-3)

    def yembed(recv: torch.Tensor, align_hi: bool) -> torch.Tensor:
        out = recv
        if ry != r:
            pad = out.new_zeros(lead + (out.shape[-3], ry - r, X))
            out = torch.cat([pad, out] if align_hi else [out, pad], dim=-2)
        if zoff:
            zpad = out.new_zeros(lead + (zoff, ry, X))
            out = torch.cat([zpad, out, zpad], dim=-3)
        return out.contiguous()

    return [{"zlo": zembed(zlo_r[i], True), "zhi": zembed(zhi_r[i], False),
             "ylo": yembed(ylo_r[i], True), "yhi": yembed(yhi_r[i], False)}
            for i in range(n)]


def interior_slab_bytes(shard_zyx: Sequence[int], mesh_counts: Dim3,
                        radius_rows: int, elem_size: int,
                        y_z_extended: bool = False) -> int:
    """Bytes ONE shard receives from other shards per
    ``exchange_interior_slabs`` call (the JAX function's count): the
    r-row transfers, not the zero filler; axes with one device are
    wraps and cost nothing."""
    Z, Y, X = shard_zyx
    r = radius_rows
    total = 0
    if mesh_counts.z > 1:
        total += 2 * r * Y * X * elem_size
    if mesh_counts.y > 1:
        zspan = Z + 2 * r if y_z_extended else Z
        total += 2 * r * zspan * X * elem_size
    return total


def exchanged_bytes_per_sweep(shard_padded_shape_zyx, radius: Radius,
                              mesh_counts: Dim3, elem_size: int,
                              axis_order: Tuple[int, ...] = (0, 1, 2)
                              ) -> Dict[str, int]:
    """Per-axis bytes one shard puts on the wire per exchange (reference:
    stencil.hpp:86-93, src/stencil.cu:516-637). Counts only shifts that
    cross shards; one-device axes are wraps of the shard into itself and
    cost 0."""
    out = {"x": 0, "y": 0, "z": 0}
    shape = list(shard_padded_shape_zyx)
    for a in axis_order:
        dim = AXIS_TO_DIM[a]
        if mesh_counts[a] <= 1:
            continue
        other = 1
        for d in range(3):
            if d != dim:
                other *= shape[d]
        out[AXIS_NAME[a]] = radius.wire_rows(a) * other * elem_size
    return out


def _single_axis_radius(radius: Radius, axis: int) -> Radius:
    """``radius`` on the faces of ``axis`` alone, zero elsewhere."""
    r = Radius.constant(0)
    for side in (-1, 1):
        d = [0, 0, 0]
        d[axis] = side
        r.set_dir(tuple(d), radius.face(axis, side))
    return r


class ExchangeInFlight:
    """A started exchange. ``wait()`` makes the cards' current streams
    wait for the side streams it runs on (``join``, an ``ops/
    cuda_exchange.CardJoin``); with none — the slab copy, or any
    exchange on the CPU — it has landed already and ``wait()`` has
    nothing to do."""

    def __init__(self, join=None) -> None:
        self._join = join

    def wait(self) -> None:
        if self._join is not None:
            self._join.exit()
            self._join = None


def start_dispatch_exchange(fields: Dict[str, List[torch.Tensor]],
                            radius: Radius, mesh_counts: Dim3, method,
                            axis_order: Tuple[int, ...] = (0, 1, 2),
                            rem: Dim3 = Dim3(0, 0, 0),
                            alloc_radius: "Radius | None" = None,
                            nonperiodic: bool = False):
    """Start ``dispatch_exchange`` and return a handle whose ``wait()``
    makes the work queued after it on the cards' current streams see
    the filled halos. Between the two, the caller may queue work that
    reads only the shards' interiors, which the exchange does not write
    — the overlap path's inner block. The slab copy runs on the current
    streams and has landed at once; ``PallasDMA`` runs on one side
    stream per card (``parallel/cuda_exchange.py``)."""
    from .methods import Method

    counts = Dim3.of(mesh_counts)
    slab = method in (Method.PpermuteSlab, Method.PpermutePacked)
    if rem != Dim3(0, 0, 0) and not slab:
        raise NotImplementedError(
            f"uneven (+-1 remainder) subdomains are only supported by "
            f"the PpermuteSlab and PpermutePacked methods, not {method}")
    if (alloc_radius is not None or nonperiodic) and not slab:
        raise NotImplementedError(
            f"deep-carry allocations and non-periodic boundaries are only "
            f"supported by the PpermuteSlab and PpermutePacked methods, "
            f"not {method}")
    if method == Method.PallasDMA:
        from .cuda_exchange import start_exchange_shard_cuda

        return start_exchange_shard_cuda(list(fields.values()), radius,
                                         counts, axis_order)
    for shards in fields.values():
        exchange_shard(shards, radius, counts, axis_order, rem,
                       alloc_radius, nonperiodic)
    return ExchangeInFlight()


def dispatch_exchange(fields: Dict[str, List[torch.Tensor]], radius: Radius,
                      mesh_counts: Dim3, method,
                      axis_order: Tuple[int, ...] = (0, 1, 2),
                      rem: Dim3 = Dim3(0, 0, 0),
                      alloc_radius: "Radius | None" = None,
                      nonperiodic: bool = False
                      ) -> Dict[str, List[torch.Tensor]]:
    """Route a multi-quantity exchange (``fields[q]`` is the list of
    padded shards of quantity q, x fastest) to the selected strategy,
    in place; returns ``fields`` (JAX: ``parallel/exchange.py:693-738``,
    with its ``NotImplementedError`` for uneven grids, non-periodic
    boundaries and deep allocations on a non-slab method).
    ``PallasDMA`` is B4's remote-write sweep, on the card and (as its
    plain twin) on the CPU; ``PpermuteSlab``, ``PpermutePacked`` and
    ``AllGather`` are all the slab copy of ``exchange_shard`` (ROADMAP
    A4: the packed and all-gather engines are not ported). The halos
    are the same bits whatever the method."""
    start_dispatch_exchange(fields, radius, mesh_counts, method, axis_order,
                            rem, alloc_radius, nonperiodic).wait()
    return fields
