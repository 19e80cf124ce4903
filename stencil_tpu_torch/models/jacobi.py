"""Jacobi-3D heat solver over a mesh of shards.

PyTorch-port counterpart of ``stencil_tpu/models/jacobi.py`` (reference:
bin/jacobi3d.cu): a 7-point Jacobi relaxation over a periodic global
grid with a hot sphere (T=1) at x/3 and a cold sphere (T=0) at 2x/3,
each of radius x/10, re-imposed every iteration; everything else
starts at the mean temperature 0.5.

The grid is split over a mesh of shards (``mesh_shape``, ``devices``;
see ``distributed.py``). Compute paths (``kernel=``), as in the JAX
model:

* ``wrap`` — the one-shard fast path: the periodic wrap inside the
  kernel, no halo storage, no exchange. Iterations run in groups of N
  through K2 (``jacobi7_wrapn_cuda``) with a single-step tail through K1
  (``jacobi7_wrap_cuda``). Needs a (1,1,1) mesh.
* ``halo`` — the multi-shard fast path on any x-unsharded mesh,
  (1,1,1) included: each shard's interior stays resident, and every
  group of steps first exchanges the interior slabs of all shards
  (``exchange_interior_slabs``), then launches one kernel per shard:
  B6 (``jacobi7_halon_cuda``, N steps on radius-N slabs) for
  ``n // N`` groups and B5 (``jacobi7_halo_cuda``, one step) for the
  tail — or B5 every step where JAX's planner declines the N-step
  blocking (``ops/halo_plan.py``), e.g. on uneven grids.
* ``pallas`` — exchange into the padded shards, then K3
  (``jacobi7_padded_cuda``) per shard, sources, write-back.
* ``xla`` — exchange, the plain PyTorch stencil (``ops/stencil_kernels``),
  sources, write-back: the port's reference path; no kernel.
* ``overlap`` (``overlap=True`` with ``kernel="halo"``, or ``auto`` on
  CUDA devices) — the reference's interior/exchange/exterior overlap
  (bin/jacobi3d.cu:296-377) as B7 (``jacobi7_overlap_cuda``): each
  shard's interior stays resident, and every step each shard sends its
  four face slabs straight into its neighbours' receive slabs while its
  interior is computed, then recomputes its faces from the landed slabs.
  Needs x unsharded, an even grid, local z >= 4 and y >= 2, radius 1,
  periodic boundaries.
* ``xla-overlap`` / ``pallas-overlap`` — ``overlap=True`` elsewhere: the
  padded paths with the deep interior computed while the exchange runs
  (``parallel/overlap.py``).
* ``xla-temporal[s=…]`` (``exchange_every=s`` > 1 off the ``wrap`` and
  ``halo`` paths) — communication-avoiding steps (``parallel/
  temporal.py``): one depth-``s`` exchange, then ``s`` plain 7-point
  sub-steps on the shrinking windows, bitwise equal to step-by-step
  ``xla``; ``-overlap`` with ``overlap=True`` (the deep exchange runs
  while sub-step 0's inner block is computed), and a depth-1 tail for
  ``iters % s``. Per-axis depths (``{"z": 3}``) run only here.
* ``auto`` — on CUDA devices, JAX's on-TPU choice: ``overlap`` when
  overlap is asked for and possible, else ``wrap`` on a (1,1,1) mesh,
  else ``halo`` when x is unsharded, else ``xla`` (a kernel path for
  float32 and bfloat16, whose kernels have bfloat16 instances; float64
  takes ``xla``); on the CPU ``xla``, as the JAX model picks it off-TPU.

The padded paths exchange by ``methods`` (``Method`` flags, JAX's
``DistributedDomain.set_methods``): ``Method.PallasDMA`` is B4's
remote-write sweep, ``PpermutePacked`` the packed engine, ``AllGather``
the all-gather engine and ``PpermuteSlab`` the slab copy.

Halo wire formats and layouts (``wire_format``, ``wire_layout``; JAX
``models/jacobi.py:278-308``): the ``xla`` and ``pallas`` paths (and
``xla-temporal``, the layout only) exchange at the narrowed width or in
the irredundant layout (``parallel/exchange.py``, ``parallel/
packing.py``); the halo and overlap paths, which move their own slabs,
refuse both, and ``xla-overlap`` ships the slab layout at the storage
dtype. ``wrap`` on (1,1,1) has no exchange, so neither setting affects
it.

``exchange_every`` (JAX ``models/jacobi.py:277-299``): None leaves the
``wrap`` and ``halo`` paths at their ``STENCIL_WRAP_STEPS`` depth
(default 2); an explicit ``s`` sets N of K2 and B6 there (``s = 1``
forces single steps) and deepens the allocation as JAX does, and makes
the padded paths temporal.

A mesh may span processes (``devices`` of ``GlobalDevice``s, the
default in a process group of more than one rank; see
``distributed.py``): every rank builds the same model and runs its own
shards; every path runs there. The ``xla``, ``pallas``, ``halo``,
``xla-temporal`` and ``-overlap`` paths move the slabs that cross between
ranks as messages (the overlapped ones post the first direction's before
the inner block and land them after it), ``PallasDMA`` (B4) and
``overlap`` (B7) store into the other ranks' buffers through CUDA IPC on
the card, ordered by device-side flags (``parallel/ipc.py``), and
``temperature()`` is a collective. ``dcn_axis`` / ``dcn_groups`` block one grid axis across hosts
(``DistributedDomain.set_dcn_axis``; JAX ``models/jacobi.py:309-326``).

``make_segment(k)`` (``parallel/megastep.py``) runs ``k`` steps of any
path through the same kernels as ``run(k)``, in the blocked loops'
chunks, with a health-probe row on the device after each chunk.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed import DeviceLike, DistributedDomain, torch_dtype
from ..geometry import DepthsLike, Dim3, Dim3Like, Radius, normalize_depths
from ..ops.cuda_halo import jacobi7_halo_cuda, jacobi7_halon_cuda
from ..ops.cuda_overlap import OverlapRecv, jacobi7_overlap_cuda
from ..ops.cuda_stencil import (COLD_TEMP, HOT_TEMP, KERNEL_DTYPES,
                                impose_spheres, jacobi7_padded_cuda,
                                jacobi7_wrap_cuda, jacobi7_wrapn_cuda,
                                sublane_tile)
from ..ops.halo_plan import pair_halo_refusal
from ..ops.stencil_kernels import global_coords, jacobi7, write_interior
from ..parallel.exchange import (dispatch_exchange, exchange_interior_slabs,
                                 interior_slab_bytes, normalize_wire_format,
                                 shard_interior_len, shard_origin)
from ..parallel.mesh import mesh_index
from ..parallel.methods import Method, pick_method
from ..parallel.overlap import overlapped_update
from ..parallel.packing import normalize_wire_layout
from ..parallel.temporal import temporal_shard_steps, validate_temporal
from ..partition import partition_dims_even_xfree
from ..topology import Boundary
from ..utils.config import wrap2_disabled
from ..utils.logging import LOG_INFO, LOG_WARN
from ..utils.timers import device_sync


def sphere_geometry(gsize: Dim3):
    """Hot/cold Dirichlet sphere centers and radius for a global grid
    (reference: bin/jacobi3d.cu:255-260): hot at x/3, cold at 2x/3,
    both mid-(y,z), radius x/10. Returns (hot_xyz, cold_xyz, r)."""
    hot = Dim3(gsize.x // 3, gsize.y // 2, gsize.z // 2)
    cold = Dim3(gsize.x * 2 // 3, gsize.y // 2, gsize.z // 2)
    return hot, cold, gsize.x // 10


def _apply_sources(new: torch.Tensor, origin_xyz, hot_c: Dim3,
                   cold_c: Dim3, sph_r: int, temps=None) -> torch.Tensor:
    """Re-impose the Dirichlet hot/cold spheres on a shard's interior
    whose global origin is ``origin_xyz`` (reference:
    bin/jacobi3d.cu:40-63); ``temps`` as ``impose_spheres`` takes it."""
    ox, oy, oz = origin_xyz
    return impose_spheres(new, hot_c, cold_c, sph_r, origin_zyx=(oz, oy, ox),
                          temps=temps)


def _apply_sources_windowed(new: torch.Tensor, origin_xyz, dims: Dim3,
                            gsize: Dim3, hot_c: Dim3, cold_c: Dim3,
                            sph_r: int, nonperiodic: bool) -> torch.Tensor:
    """Per-sub-step sources for a temporal-blocking window that may
    reach into the halo ring (JAX ``models/jacobi.py:96-124``): ring
    cells get exactly what their OWNER shard computes, so periodic
    coordinates wrap modulo the global size before the sphere test; with
    the zero-Dirichlet exterior (``Boundary.NONE``) out-of-domain cells
    are forced to zero instead."""
    ox, oy, oz = origin_xyz
    if not nonperiodic:
        return impose_spheres(new, hot_c, cold_c, sph_r,
                              origin_zyx=(oz, oy, ox),
                              period_zyx=(gsize.z, gsize.y, gsize.x))
    new = impose_spheres(new, hot_c, cold_c, sph_r, origin_zyx=(oz, oy, ox))
    gz, gy, gx = global_coords(origin_xyz, dims, device=new.device)
    inside = ((gx >= 0) & (gx < gsize.x) & (gy >= 0) & (gy < gsize.y)
              & (gz >= 0) & (gz < gsize.z))
    return torch.where(inside, new, torch.zeros((), dtype=new.dtype,
                                                device=new.device))


def _update(p: torch.Tensor, radius: Radius, dims: Dim3,
            kernel: str) -> torch.Tensor:
    """The 7-point update of the region ``dims`` of a padded block:
    plain PyTorch ("xla") or K3 ("pallas", ``jacobi7_padded_cuda``,
    which takes a contiguous block on the card)."""
    if kernel == "pallas":
        return jacobi7_padded_cuda(p.contiguous() if p.is_cuda else p,
                                   radius, dims)
    return jacobi7(p, radius, dims)


def jacobi_shard_step(shards: Sequence[torch.Tensor], radius: Radius,
                      counts: Dim3, local: Dim3, gsize: Dim3,
                      kernel: str = "xla", rem: Dim3 = Dim3(0, 0, 0),
                      nonperiodic: bool = False,
                      method: Method = Method.Default,
                      wire_format=None, wire_layout=None,
                      ranks: Optional[Sequence[int]] = None,
                      temps: Optional[Sequence[tuple]] = None) -> None:
    """One Jacobi step on the padded shards of a mesh (x fastest):
    exchange by ``method``, then per shard the 7-point update of its
    capacity interior plus the Dirichlet sphere sources at its own
    origin, written back in place (the JAX version runs one shard under
    ``shard_map`` and returns a new array). ``kernel``: "xla" (plain
    PyTorch) or "pallas" (K3, ``jacobi7_padded_cuda``).
    ``wire_format`` narrows the halo wire only, ``wire_layout`` picks
    the message geometry (``parallel/exchange.py``); the update runs at
    the storage dtype. ``ranks``: each position's owner on a mesh that
    spans processes (None at the positions of ``shards`` other ranks
    own). ``temps``: per shard, the (hot, cold) sphere values as
    ``impose_spheres`` takes them — an ensemble's per-member
    temperatures, whose shards carry a leading member axis."""
    hot_c, cold_c, sph_r = sphere_geometry(gsize)
    dispatch_exchange({"temp": shards}, radius, counts, method, rem=rem,
                      nonperiodic=nonperiodic, wire_format=wire_format,
                      wire_layout=wire_layout, ranks=ranks)
    for i, p in enumerate(shards):
        if p is None:
            continue
        new = _update(p, radius, local, kernel)
        origin = shard_origin(local, rem, mesh_index(i, counts))
        new = _apply_sources(new, origin, hot_c, cold_c, sph_r,
                             None if temps is None else temps[i])
        write_interior(p, new, radius)


def jacobi_shard_step_overlap(shards: Sequence[torch.Tensor],
                              radius: Radius, counts: Dim3, local: Dim3,
                              gsize: Dim3, method: Method,
                              kernel: str = "xla",
                              nonperiodic: bool = False,
                              ranks: Optional[Sequence[int]] = None) -> None:
    """The overlapped variant of ``jacobi_shard_step`` on an evenly
    divided mesh (JAX: models/jacobi.py:125-149): the deep interior of
    every shard is computed while the exchange runs, the thin face
    slabs from the exchanged shards afterwards
    (``parallel/overlap.py``), then the spheres and the write-back.
    ``ranks``: as for ``jacobi_shard_step``."""
    hot_c, cold_c, sph_r = sphere_geometry(gsize)

    def upd(blocks, dims, off, i):
        return {"temp": _update(blocks["temp"], radius, dims, kernel)}

    new = overlapped_update({"temp": list(shards)}, radius, counts, method,
                            upd, nonperiodic=nonperiodic, ranks=ranks)
    for i, p in enumerate(shards):
        if p is None:
            continue
        origin = shard_origin(local, Dim3(0, 0, 0), mesh_index(i, counts))
        out = _apply_sources(new[i]["temp"], origin, hot_c, cold_c, sph_r)
        write_interior(p, out, radius)


def _dcn_request_kwargs(dd) -> dict:
    """The DCN-tier request ``dd`` was configured with, as model
    constructor kwargs (JAX ``models/jacobi.py:152-161``), so that a
    model rebuilt from a domain keeps its host tier (``None`` axis:
    derived, spelled ``"auto"``)."""
    if not dd._dcn_requested:
        return {}
    req = dd._dcn_axis_req
    return {"dcn_axis": "auto" if req is None else req,
            "dcn_groups": dd._dcn_groups}


def _dcn_xfree_shape(size: Dim3, devices, dcn_axis, dcn_groups, kernel,
                     align: int = 1, on_gpu: bool = False):
    """A host-compatible x-unsharded mesh shape when the DCN tier is
    asked for together with a halo path (``kernel="halo"``, or ``auto``
    on a card, ``on_gpu``), since NodePartition's split may shard x,
    which the slab kernels cannot take (JAX ``models/jacobi.py:
    229-263``). None — realize()'s planner then decides — for other
    kernels, an x-axis tier, a device count the host groups do not
    divide, or a shape the grid cannot host (every axis dividing evenly,
    local z and y multiples of ``align``)."""
    from ..parallel.mesh import default_mesh_shape_dcn
    from ..parallel.multihost import slice_groups

    if not (kernel == "halo" or (kernel == "auto" and on_gpu)):
        return None
    axis = dcn_axis
    if isinstance(axis, str):
        axis = {"x": 0, "y": 1, "z": 2, "auto": None}[axis]
    if axis == 0:
        return None
    groups = dcn_groups or slice_groups(devices)
    if len(groups) <= 1 or len(devices) % len(groups):
        return None
    shape = default_mesh_shape_dcn(len(devices), len(groups),
                                   axis=2 if axis is None else axis,
                                   xfree=True)
    for a in range(3):
        if size[a] % shape[a]:
            return None
    if (size.z // shape.z) % align or (size.y // shape.y) % align:
        return None
    return shape


def select_kernel_path(kernel: str, overlap: bool, counts: Dim3, rem: Dim3,
                       local: Dim3, radius_ok: bool, nonperiodic: bool,
                       on_gpu: bool, kernel_dtype: bool,
                       depths: Dim3 = Dim3(1, 1, 1),
                       wire_narrows: bool = False,
                       irredundant: bool = False) -> str:
    """The compute path ``Jacobi3D`` builds: JAX's selection rules
    (models/jacobi.py:460-575) with its on-TPU choice taken on CUDA
    devices, where the port's kernels run (and, as they take float32 and
    bfloat16, for a domain of those: ``kernel_dtype``). ``depths``: the
    domain's temporal depths (``exchange_depths``); above 1 the padded
    paths become ``xla-temporal[s=…]`` (``-overlap``). ``wire_narrows``
    (a narrowing wire format) and ``irredundant`` (the irredundant wire
    layout) rule out the halo and overlap paths, which move their own
    slabs; a narrowing format also refuses ``exchange_every > 1`` and
    overlap.
    Raises as JAX does for an explicit kernel its conditions exclude."""
    if overlap and rem != Dim3(0, 0, 0):
        raise NotImplementedError("overlap mode requires an evenly "
                                  "divisible grid")
    s_every = max(depths)
    asym = not depths.x == depths.y == depths.z
    if asym and overlap:
        raise NotImplementedError(
            "asymmetric temporal depths (per-axis exchange_every) are not "
            "supported with overlap=True — the overlap composition assumes "
            "one symmetric deep exchange per group (parallel/temporal.py "
            "declines it too)")
    if asym and kernel in ("wrap", "halo", "pallas"):
        raise NotImplementedError(
            f"asymmetric temporal depths (exchange_every={tuple(depths)}) "
            f"are not supported with kernel={kernel!r} — the in-kernel "
            f"multi-step paths have one step count, not one per axis; use "
            f"kernel='xla' or 'auto'")
    accel = on_gpu and kernel_dtype
    wrap_ok = (counts == Dim3(1, 1, 1) and rem == Dim3(0, 0, 0)
               and not overlap and radius_ok and not nonperiodic
               and not asym)
    halo_ok = (counts.x == 1 and not overlap and radius_ok
               and not nonperiodic and not wire_narrows and not irredundant
               and not asym)
    overlap_ok = (overlap and counts.x == 1 and radius_ok
                  and local.z >= 4 and local.y >= 2 and not nonperiodic
                  and s_every == 1 and not wire_narrows and not irredundant)
    if overlap_ok and (kernel == "halo" or (kernel == "auto" and accel)):
        return "overlap"
    if kernel == "auto":
        kernel = ("xla" if not accel else "wrap" if wrap_ok
                  else "halo" if halo_ok else "xla")
    if kernel == "wrap" and not wrap_ok:
        raise ValueError("kernel='wrap' needs a (1,1,1) mesh, radius 1, "
                         "periodic boundaries, overlap off")
    if kernel == "halo" and not halo_ok:
        raise ValueError("kernel='halo' needs an x-unsharded mesh, radius "
                         "1, periodic boundaries, overlap off (or overlap "
                         "with local z >= 4 and y >= 2)")
    if kernel in ("wrap", "halo"):
        return kernel
    if s_every > 1:
        if kernel == "pallas":
            raise ValueError("exchange_every > 1 is not supported with "
                             "kernel='pallas' (use xla, wrap or halo)")
        if wire_narrows:
            raise NotImplementedError(
                "a narrowing wire_format is not supported with "
                "exchange_every > 1 (the temporal deep exchange has no "
                "wire-narrowing variant yet)")
        tag = (f"s={depths.x}.{depths.y}.{depths.z}" if asym
               else f"s={s_every}")
        return f"xla-temporal[{tag}]" + ("-overlap" if overlap else "")
    if wire_narrows and overlap:
        raise NotImplementedError(
            "a narrowing wire_format is not supported with overlap=True "
            "(overlapped_update has no wire-narrowing variant yet)")
    return f"{kernel}-overlap" if overlap else kernel


def _wrap_steps(tile: int, requested: int = 0) -> int:
    """Temporal-blocking depth of the wrap and halo paths, as in the JAX
    model (``models/jacobi.py:164-177``): an explicit ``exchange_every``
    request wins; else STENCIL_WRAP_STEPS (default 2). Clamped to [1,
    tile] — the TPU's sublane tile, kept so that both packages group the
    same steps the same way."""
    if requested:
        return min(max(int(requested), 1), tile)
    try:
        n = int(os.environ.get("STENCIL_WRAP_STEPS", "2") or 2)
    except ValueError:
        LOG_WARN("STENCIL_WRAP_STEPS is not an integer; using 2")
        n = 2
    return min(max(n, 1), tile)


class Jacobi3D:
    """Jacobi-3D solver over a mesh of shards (one device by default:
    ``device=``; a mesh: ``mesh_shape=`` and ``devices=``)."""

    def __init__(self, x: int, y: int, z: int, dtype=torch.float32,
                 kernel: str = "auto", boundary: Optional[Boundary] = None,
                 device: DeviceLike = None,
                 mesh_shape: Optional[Dim3Like] = None,
                 devices: Optional[Sequence] = None,
                 methods: Method = Method.Default,
                 overlap: bool = False,
                 exchange_every: Optional[DepthsLike] = None,
                 wire_format=None, wire_layout=None,
                 dcn_axis=None, dcn_groups=None,
                 placement=None, output_prefix: str = "") -> None:
        if kernel not in ("auto", "wrap", "halo", "xla", "pallas"):
            raise ValueError(
                f"kernel must be auto|wrap|halo|xla|pallas, got {kernel!r}")
        self.dd = DistributedDomain(x, y, z, device=device, devices=devices)
        self.dd.set_radius(1)
        self.dd.set_methods(methods)
        # Method.Auto: the tuner sweeps only the depths the path runs
        # (the pallas and overlap paths refuse exchange_every > 1)
        self.dd._tune_deep = kernel != "pallas" and not overlap
        # temporal blocking: None = unset (the wrap and halo paths keep
        # their STENCIL_WRAP_STEPS default); an explicit s pins the depth
        # — deep allocations and one deep exchange per s steps on the
        # padded paths (parallel/temporal.py), N of K2 and B6 on the wrap
        # and halo paths (s == 1 forces single steps). Per-axis depths
        # ({"z": 4}, (1, 1, 4)) deepen only the named axes, on the
        # temporal path only
        if exchange_every is None:
            self._exchange_every = 0
        elif isinstance(exchange_every, int):
            self._exchange_every = max(int(exchange_every), 1)
        else:
            self._exchange_every = max(normalize_depths(exchange_every))
        if self._exchange_every > 1:
            self.dd.set_exchange_every(exchange_every)
        if boundary is not None:
            self.dd.set_boundary(boundary)
        if wire_format is not None:
            # halo wire narrowing; realize() below runs the precision gate
            self.dd.set_wire_format(wire_format)
        if wire_layout is not None:
            self.dd.set_wire_layout(wire_layout)
        dcn = dcn_axis is not None or dcn_groups is not None
        if dcn:
            self.dd.set_dcn_axis(dcn_axis, dcn_groups)
        if placement is not None:
            # a PlacementStrategy or a NodeAware mode (placement.py)
            self.dd.set_placement(placement)
        if output_prefix:
            self.dd.set_output_prefix(output_prefix)
        devs = self.dd._devices
        on_gpu = all(d.type == "cuda" for d in devs)
        if mesh_shape is not None:
            self.dd.set_mesh_shape(mesh_shape)
        elif dcn:
            # the planner does not know that the halo paths need x
            # unsharded: derive a host-compatible x-free shape here
            shape = _dcn_xfree_shape(Dim3(x, y, z), self.dd._global,
                                     dcn_axis, dcn_groups, kernel,
                                     on_gpu=on_gpu)
            if shape is not None:
                self.dd.set_mesh_shape(shape)
        elif len(devs) > 1 and not overlap and (
                kernel == "halo" or (kernel == "auto" and on_gpu)):
            # prefer an x-unsharded decomposition so the halo path is
            # available (models/jacobi.py:329-341 of the JAX package)
            shape = partition_dims_even_xfree(Dim3(x, y, z), len(devs))
            if shape is not None:
                self.dd.set_mesh_shape(shape)
        self._dtype = torch_dtype(dtype)
        self.dd.add_data("temp", self._dtype)
        self.dd.realize()
        self._kernel = kernel
        self._overlap = bool(overlap)
        self._overlap_recv: Optional[OverlapRecv] = None
        self._build_step()

    # -- initial conditions (reference: bin/jacobi3d.cu:18-27) ---------
    def init(self) -> None:
        for i, p in enumerate(self.dd.curr["temp"]):
            if p is None:
                continue
            p.zero_()
            self.dd.interior("temp", i).fill_((HOT_TEMP + COLD_TEMP) / 2)

    def load_interior(self, values: np.ndarray) -> None:
        """Start from a given global (z,y,x) interior — for instance
        ``interior_to_host`` of a JAX solver (see ``convert.py``) —
        scattered into the shards; halos are zeroed."""
        from ..convert import interior_from_jax

        self.dd.set_interior("temp", interior_from_jax(values, self._dtype))

    # -- path selection -------------------------------------------------
    def _build_step(self) -> None:
        dd = self.dd
        radius = dd.radius
        radius_ok = all(radius.face(a, s) == 1
                        for a in range(3) for s in (-1, 1))
        # the port's kernels take float32 and bfloat16, so ``auto`` picks
        # them only for a domain of those
        kdt = self._dtype in KERNEL_DTYPES
        path = select_kernel_path(
            self._kernel, self._overlap, dd.mesh_counts, dd.rem,
            dd.local_size, radius_ok, dd.boundary == Boundary.NONE,
            all(d.type == "cuda" for d in dd.mesh.devices), kdt,
            dd.exchange_depths,
            wire_narrows=any(v != "f32" for v in
                             normalize_wire_format(dd.wire_format).values()),
            irredundant=normalize_wire_layout(dd.wire_layout)
            == "irredundant")
        if (self._kernel == "auto" or path == "overlap"
                or path.startswith("xla-temporal")):
            LOG_INFO(f"jacobi kernel path: {path}")
        kernel = path.split("-")[0]
        if kernel in ("wrap", "halo", "pallas", "overlap") and not kdt:
            raise TypeError(f"kernel={kernel!r} runs CUDA kernels that take "
                            f"float32 or bfloat16, got {self._dtype}; use "
                            f"kernel='xla'")
        self._method = pick_method(dd.methods)
        tile = sublane_tile(self._dtype)
        if path.startswith("xla-temporal"):
            validate_temporal(radius, dd.local_size, dd.exchange_depths,
                              dd.rem)
        if kernel == "wrap":
            self._wrap_n = _wrap_steps(tile, self._exchange_every)
            self._pair_ok = (dd.size.y % tile == 0 and self._wrap_n > 1
                             and not wrap2_disabled())
        if kernel == "halo":
            self._build_halo_step(tile)
        if kernel == "overlap":
            # the kernel moves the same single-row face slabs as a
            # radius-1 slab exchange (JAX models/jacobi.py:927-928)
            self._slab_exchange_cfg = dict(rz=1, ry=1, radius_rows=1,
                                           y_z_extended=False,
                                           per_iter_div=1)
        self._base_kernel = kernel
        self.kernel_path = path
        self._build_segment()

    def _build_halo_step(self, tile: int) -> None:
        """JAX's ``_build_halo_step`` rules (models/jacobi.py:838-878):
        N-step groups when the grid divides evenly, the shard's y extent
        is a multiple of the sublane tile, N > 1 and the JAX planner
        finds a blocking; the single-step kernel otherwise."""
        local = self.dd.local_size
        self._halo_n = N = _wrap_steps(tile, self._exchange_every)
        pair_ok = (self.dd.rem == Dim3(0, 0, 0) and N > 1
                   and local.y % tile == 0 and not wrap2_disabled())
        if pair_ok:
            refusal = pair_halo_refusal(
                local.z, local.y, local.x,
                torch.empty((), dtype=self._dtype).element_size(), N)
            if refusal is not None:
                LOG_WARN(f"halo temporal blocking declined: {refusal}")
                pair_ok = False
        if pair_ok:
            LOG_INFO(f"jacobi halo path: {N}-step temporal blocking")
        self._halo_pair_ok = pair_ok
        # one radius-N z-extended exchange per N iterations, or one
        # radius-1 exchange per iteration. The slabs are exactly the rows
        # that cross (rz = ry = radius_rows): the kernels read no more,
        # and the JAX package's wider y slabs (ry = the sublane tile) are
        # a TPU layout that would only add zero filler here
        self._slab_exchange_cfg = (
            dict(rz=N, ry=N, radius_rows=N, y_z_extended=True,
                 per_iter_div=N) if pair_ok
            else dict(rz=1, ry=1, radius_rows=1, y_z_extended=False,
                      per_iter_div=1))

    # -- megastep: campaign segments ------------------------------------
    def _build_segment(self) -> None:
        """The segment builder of the built path (JAX's registrations,
        models/jacobi.py:588, :662, :731, :812, :908). A chunk of ``c``
        steps is one ``run(c)``, which at the path's stride is one group
        and at 1 a single tail step: a padded path's step,
        ``xla-temporal[s=…]``'s group of ``s`` or depth-1 step, one K2/B6
        launch (a shard) or K1/B5 step on ``wrap``/``halo``, the interior
        sliced out and written back per chunk so that every probe row
        reads current state. ``overlap``: a B7 step a chunk, all in one
        session of its receive slabs. JAX gates that path on its schedule
        certificate; the port has no certifier yet (ROADMAP A14), so it
        builds the segment directly."""
        path = self.kernel_path
        if path == "overlap":
            self._overlap_recv_for()
            self._set_segment_builder(
                self._overlap_chunk,
                session=lambda: self._overlap_recv.session())
            return
        stride = (self._wrap_n if path == "wrap" and self._pair_ok
                  else self._halo_n if path == "halo" and self._halo_pair_ok
                  else self.dd.exchange_every
                  if path.startswith("xla-temporal") else 1)
        self._set_segment_builder(self.run, stride)

    def _set_segment_builder(self, advance, stride: int = 1,
                             session=None) -> None:
        """Register the segment factory of the built path:
        ``advance(steps)`` moves every shard ``steps`` steps in place
        (``steps`` is the path's stride or a single tail step). The carry
        is the padded field's shards; ``make_segment`` builds segments
        through ``parallel/megastep.SegmentCompiler``."""
        from ..parallel import megastep as ms

        def adopt(out):
            self.dd.curr["temp"] = out

        def step(p, c, i):
            advance(c)
            return p

        self._segment_decline = None
        self._segment_builder = ms.SegmentCompiler(
            self.dd.mesh,
            ms.CarryContract(probe_view=lambda p: {"temp": p},
                             stride=stride),
            step, lambda: self.dd.curr["temp"], adopt, session=session)

    def _set_segment_decline(self, reason: str,
                             code: Optional[str] = None) -> None:
        """The built path cannot run segments: record why (prose and a
        ``megastep.DECLINE_*`` code) for ``make_segment``."""
        self._segment_builder = None
        self._segment_decline = reason
        self._segment_decline_code = code

    def make_segment(self, check_every: int, probe_every: int = 1,
                     metrics=None):
        """A ``Segment`` advancing ``check_every`` iterations with the
        health probe kept on the device every ``probe_every`` steps
        (``parallel/megastep.py``): ``seg.run(base_step)`` advances the
        field in place through the same kernels as ``run`` and returns
        the probe trace; ``metrics`` (``telemetry.probe.StepMetrics``)
        adds the step-metric columns. A path that cannot run segments
        returns a falsy ``SegmentDecline`` with the reason."""
        builder = getattr(self, "_segment_builder", None)
        if builder is None:
            from ..parallel import megastep as ms
            reason = (getattr(self, "_segment_decline", None)
                      or "no fused-segment builder for this path")
            code = (getattr(self, "_segment_decline_code", None)
                    or ms.DECLINE_NO_BUILDER)
            return ms.decline("jacobi", self.kernel_path, reason,
                              code=code)
        return builder(int(check_every), max(int(probe_every), 1),
                       metrics)

    # -- stepping -------------------------------------------------------
    def step(self) -> None:
        """One iteration."""
        self.run(1)

    def run(self, iters: int) -> None:
        """``iters`` iterations. On the wrap and halo paths: ``iters //
        N`` N-step launches, then ``iters % N`` single-step launches (the
        JAX model's grouping, models/jacobi.py:688-709, :880-903)."""
        iters = int(iters)
        if iters <= 0:
            return
        if self.kernel_path == "wrap":
            self._run_wrap(iters)
            return
        if self.kernel_path == "halo":
            self._run_halo(iters)
            return
        if self.kernel_path == "overlap":
            self._run_overlap(iters)
            return
        if self.kernel_path.startswith("xla-temporal"):
            self._run_temporal(iters)
            return
        dd = self.dd
        nonper = dd.boundary == Boundary.NONE
        for _ in range(iters):
            if self._overlap:
                jacobi_shard_step_overlap(
                    dd.curr["temp"], dd.radius, dd.mesh_counts,
                    dd.local_size, dd.size, self._method,
                    kernel=self._base_kernel, nonperiodic=nonper,
                    ranks=dd.mesh.peers)
            else:
                jacobi_shard_step(dd.curr["temp"], dd.radius,
                                  dd.mesh_counts, dd.local_size, dd.size,
                                  kernel=self._base_kernel, rem=dd.rem,
                                  nonperiodic=nonper, method=self._method,
                                  wire_format=dd.wire_format,
                                  wire_layout=dd.wire_layout,
                                  ranks=dd.mesh.peers)

    def _run_temporal(self, n: int) -> None:
        """JAX's ``_build_temporal_step`` (models/jacobi.py:590-662):
        ``n // s`` groups through ``temporal_shard_steps`` — one deep
        exchange, then ``s`` plain 7-point sub-steps on the shrinking
        windows with the sources re-imposed on each window, ring cells
        included —, then ``n % s`` depth-1 groups on the same deep
        buffers. With ``overlap=True`` the deep exchange runs while
        sub-step 0's inner block is computed."""
        dd = self.dd
        radius, counts, local, rem = (dd.radius, dd.mesh_counts,
                                      dd.local_size, dd.rem)
        gsize, depths = dd.size, dd.exchange_depths
        nonper = dd.boundary == Boundary.NONE
        hot_c, cold_c, sph_r = sphere_geometry(gsize)
        origins = [shard_origin(local, rem, mesh_index(i, counts))
                   for i in range(counts.flatten())]

        def update_fn(blocks, dims, off, k, i):
            blk = blocks["temp"]
            new = jacobi7(blk, radius, dims)
            ox, oy, oz = origins[i]
            org = (ox + off[0], oy + off[1], oz + off[2])
            new = _apply_sources_windowed(new, org, dims, gsize, hot_c,
                                          cold_c, sph_r, nonper)
            return {"temp": new.to(blk.dtype)}

        def group(depth, ovl):
            temporal_shard_steps({"temp": dd.curr["temp"]}, radius, counts,
                                 self._method, update_fn, depth,
                                 alloc_steps=depths, rem=rem, overlap=ovl,
                                 nonperiodic=nonper,
                                 wire_layout=dd.wire_layout,
                                 ranks=dd.mesh.peers)

        s = dd.exchange_every
        for _ in range(n // s):
            group(depths, self._overlap)
        for _ in range(n % s):
            group(1, False)

    def _run_wrap(self, n: int) -> None:
        """Slice the interior into a contiguous tensor once, ping-pong it
        with a second unpadded buffer through the kernels, and write it
        back once; the halos go stale (nothing reads them on this path,
        and ``temperature()`` reads the interior only). The padded field
        is updated in place."""
        hot, cold, sph_r = sphere_geometry(self.dd.size)
        a = self.dd.interior("temp").contiguous()
        b = torch.empty_like(a)
        N = self._wrap_n
        if self._pair_ok:
            for _ in range(n // N):
                jacobi7_wrapn_cuda(a, hot, cold, sph_r, steps=N, out=b)
                a, b = b, a
            tail = n % N
        else:
            tail = n
        for _ in range(tail):
            jacobi7_wrap_cuda(a, hot, cold, sph_r, out=b)
            a, b = b, a
        self.dd.interior("temp").copy_(a)

    def _capacity_slices(self) -> Tuple[slice, slice, slice]:
        lo = self.dd.alloc_radius.pad_lo()
        c = self.dd.local_size
        return (slice(lo.z, lo.z + c.z), slice(lo.y, lo.y + c.y),
                slice(lo.x, lo.x + c.x))

    def _run_halo(self, n: int) -> None:
        """Slice each shard's capacity interior (a short shard's dead
        row and column included, as JAX keeps them) into a contiguous
        tensor once, run the groups — every group exchanges the slabs of
        ALL shards before any kernel writes, and the kernels write into
        the second buffer of each ping-pong pair —, and write each
        interior back once; the halos go stale."""
        dd = self.dd
        counts, rem, local = dd.mesh_counts, dd.rem, dd.local_size
        hot, cold, sph_r = sphere_geometry(dd.size)
        gsize = (dd.size.z, dd.size.y, dd.size.x)
        cap = self._capacity_slices()
        own = dd.mesh.local_positions
        ranks = dd.mesh.peers
        a = [None if p is None else p[cap].contiguous()
             for p in dd.curr["temp"]]
        b = [None if t is None else torch.empty_like(t) for t in a]
        orgs, lens = {}, {}
        for i in own:
            idx = dd.shard_index(i)
            ox, oy, oz = shard_origin(local, rem, idx)
            orgs[i] = (oz, oy, ox)
            lens[i] = (shard_interior_len(2, local.z, rem, idx.z),
                       shard_interior_len(1, local.y, rem, idx.y))
        N = self._halo_n
        tail = n
        if self._halo_pair_ok:
            for _ in range(n // N):
                slabs = exchange_interior_slabs(a, counts, rz=N, ry=N,
                                                y_z_extended=True,
                                                ranks=ranks)
                for i in own:
                    jacobi7_halon_cuda(a[i], slabs[i], orgs[i], gsize, hot,
                                       cold, sph_r, steps=N, out=b[i])
                a, b = b, a
            tail = n % N
        for _ in range(tail):
            slabs = exchange_interior_slabs(a, counts, rz=1, ry=1, rem=rem,
                                            ranks=ranks)
            for i in own:
                jacobi7_halo_cuda(a[i], slabs[i], orgs[i], hot, cold, sph_r,
                                  interior_len_zy=lens[i], out=b[i])
            a, b = b, a
        for i in own:
            dd.curr["temp"][i][cap].copy_(a[i])

    def _run_overlap(self, n: int) -> None:
        """As ``_run_halo``: each shard's capacity interior (the grid is
        even here) sliced into a contiguous tensor once, ping-ponged with
        a second buffer through B7, and written back once; the halos go
        stale. The shards' receive slabs persist across runs. The steps
        run in one ``OverlapRecv.session``: between them only B7's two
        ordering rules join the shards' streams."""
        self._overlap_steps(n, self._overlap_recv_for().session)

    def _overlap_recv_for(self) -> OverlapRecv:
        """The shards' persistent receive slabs and stream ordering,
        made at first use."""
        if self._overlap_recv is None:
            cap = self._capacity_slices()
            self._overlap_recv = OverlapRecv(
                [None if p is None else p[cap].contiguous()
                 for p in self.dd.curr["temp"]],
                self.dd.mesh_counts, self.dd.mesh.peers)
        return self._overlap_recv

    def _overlap_chunk(self, n: int) -> None:
        """A segment's chunk of ``n`` B7 steps inside the segment's one
        session: the shard streams wait for the current streams before
        the steps and the current streams for the shard streams after
        them, since the chunk's write-back and the probe run on the
        current streams."""
        streams = self._overlap_recv.streams

        @contextlib.contextmanager
        def joined():
            if streams is not None:
                streams.enter()
            yield
            if streams is not None:
                streams.exit()

        self._overlap_steps(n, joined)

    def _overlap_steps(self, n: int, around) -> None:
        """Slice the interiors, run ``n`` B7 steps inside the context
        ``around()`` makes (it orders the shard streams after the slices
        and the current streams after the steps), write them back."""
        dd = self.dd
        counts, local = dd.mesh_counts, dd.local_size
        hot, cold, sph_r = sphere_geometry(dd.size)
        cap = self._capacity_slices()
        recv = self._overlap_recv
        a = [None if p is None else p[cap].contiguous()
             for p in dd.curr["temp"]]
        b = [None if t is None else torch.empty_like(t) for t in a]
        orgs = []
        for i in range(len(a)):
            ox, oy, oz = shard_origin(local, dd.rem, dd.shard_index(i))
            orgs.append((oz, oy, ox))
        with around():
            for _ in range(n):
                jacobi7_overlap_cuda(a, orgs, hot, cold, sph_r, counts,
                                     out=b, recv=recv)
                a, b = b, a
        for p, t in zip(dd.curr["temp"], a):
            if p is not None:
                p[cap].copy_(t)

    def block(self) -> None:
        device_sync([t for t in self.dd.curr["temp"] if t is not None])

    # -- resilient run loop (resilience/driver.py) -----------------------
    def run_resilient(self, n_steps: int, policy=None,
                      ckpt_dir: Optional[str] = None, faults=None):
        """``n_steps`` iterations under the checkpoint-rollback recovery
        driver (``resilience.run_resilient``; JAX
        ``models/jacobi.py:1046``): health sentinels every
        ``policy.check_every`` steps, integrity-checked checkpoints every
        ``policy.ckpt_every``, rollback and bounded retry on divergence,
        configuration degradation on repeated failure (the solver is
        rebuilt in place at the softer configuration), and clean SIGTERM
        preemption and resume through ``ckpt_dir``. The state is
        ``dd.curr``, which every path writes back after each run, so a
        restore needs no cache of its own to drop. Returns the
        ``ResilienceReport``."""
        from ..resilience.driver import run_resilient

        def rebuild(cfg):
            size = self.dd.size
            new = Jacobi3D(
                size.x, size.y, size.z,
                mesh_shape=tuple(self.dd.placement.dim()),
                dtype=self._dtype, devices=self.dd._global,
                methods=cfg.method, kernel=self._kernel,
                overlap=self._overlap, exchange_every=cfg.exchange_every,
                boundary=self.dd.boundary, placement=self.dd.strategy,
                output_prefix=self.dd._output_prefix,
                **_dcn_request_kwargs(self.dd))
            # adopt the rebuilt engine in place, so that the caller's
            # handle and the driver's fields_fn stay valid; its segment
            # factory serves from here on
            self.__dict__.update(new.__dict__)
            return self.dd, self.step, self.make_segment

        return run_resilient(self.dd, self.step, n_steps, policy=policy,
                             ckpt_dir=ckpt_dir, faults=faults,
                             rebuild=rebuild,
                             fields_fn=lambda: self.dd.curr,
                             make_segment=self.make_segment,
                             perf_entry="jacobi")

    def temperature(self) -> np.ndarray:
        """Global interior (z,y,x) on the host (a collective on a mesh
        that spans processes: every rank gets the whole array)."""
        return self.dd.interior_to_host("temp")

    def exchange_stats(self) -> dict:
        """Per-iteration exchange accounting of the built path (JAX's,
        models/jacobi.py:950-993): bytes that cross between shards per
        iteration, whole mesh, and exchange rounds per iteration. The
        wrap path has none; the halo path counts its slab transfers
        (``interior_slab_bytes``) over its group length, the overlap path
        its single-row face slabs; the padded paths exchange once a
        step, the temporal path once a group of ``s`` (or, with per-axis
        depths, at sub-step 0 and at every mid-group refresh)."""
        path = self.kernel_path
        if path == "wrap":
            return {"path": path, "bytes_per_iteration": 0,
                    "rounds_per_iteration": 0.0}
        counts = self.dd.mesh_counts
        if path in ("halo", "overlap"):
            cfg = self._slab_exchange_cfg
            local = self.dd.local_size
            per_shard = interior_slab_bytes(
                (local.z, local.y, local.x), counts, cfg["radius_rows"],
                torch.empty((), dtype=self._dtype).element_size(),
                cfg["y_z_extended"])
            return {"path": path,
                    "bytes_per_iteration":
                        per_shard * counts.flatten() / cfg["per_iter_div"],
                    "rounds_per_iteration": 1.0 / cfg["per_iter_div"]}
        d = self.dd.exchange_depths
        s = self.dd.exchange_every
        if d.x == d.y == d.z:
            rounds = 1.0 / s
        else:
            # asymmetric group: the deep exchange at sub-step 0 plus a
            # mid-group refresh at every k where some axis's cadence
            # divides k (parallel.temporal.refresh_axes)
            rounds = (1 + sum(1 for k in range(1, s)
                              if any(k % d[a] == 0
                                     for a in range(3)))) / s
        return {"path": path,
                "bytes_per_iteration":
                    float(self.dd.exchange_bytes_amortized_per_step()),
                "rounds_per_iteration": rounds}

    def measure_exchange_seconds(self, reps: int = 10) -> float:
        """Exchange seconds per ITERATION of the built path: the halo
        path's slab exchange of one group (timed on zero shards) over
        its group length (the overlap path: a round of its single-row
        face slabs), or one ``dd.exchange()`` on the padded paths (the
        deep one over the ``exchange_every`` steps it feeds on the
        temporal path); 0.0 on the wrap path, which has no exchange."""
        path = self.kernel_path
        if path == "wrap":
            return 0.0
        if path in ("halo", "overlap"):
            cfg = self._slab_exchange_cfg
            return self.slab_exchange_seconds(reps) / cfg["per_iter_div"]
        self.dd.exchange()
        self.block()
        t0 = time.perf_counter()
        for _ in range(reps):
            self.dd.exchange()
        self.block()
        # one (possibly deep) exchange feeds exchange_every iterations
        return (time.perf_counter() - t0) / reps / self.dd.exchange_every

    def slab_exchange_seconds(self, reps: int = 10) -> float:
        """Seconds of one ``exchange_interior_slabs`` round of the halo
        (or overlap) path's slab configuration over all shards, on
        capacity-sized zero shards (the state is not touched)."""
        cfg = self._slab_exchange_cfg
        dd = self.dd
        c = dd.local_size
        own = set(dd.mesh.local_positions)
        shards = [torch.zeros((c.z, c.y, c.x), dtype=self._dtype, device=d)
                  if i in own else None
                  for i, d in enumerate(dd.mesh.devices)]
        rem = Dim3(0, 0, 0) if cfg["y_z_extended"] else dd.rem

        def once() -> List:
            return exchange_interior_slabs(
                shards, dd.mesh_counts, rz=cfg["rz"], ry=cfg["ry"],
                radius_rows=cfg["radius_rows"],
                y_z_extended=cfg["y_z_extended"], rem=rem,
                ranks=dd.mesh.peers)

        once()
        device_sync([t for t in shards if t is not None])
        t0 = time.perf_counter()
        for _ in range(reps):
            out = once()
        device_sync([s["yhi"] for s in out if s is not None])
        return (time.perf_counter() - t0) / reps


def dense_reference_step(temp: np.ndarray, hot_c: Tuple[int, int, int],
                         cold_c: Tuple[int, int, int], sph_r: int
                         ) -> np.ndarray:
    """Single-device dense numpy oracle of one Jacobi step on a (z,y,x)
    global array with periodic wrap (a copy of the JAX package's; it
    divides by 6.0 where the kernels multiply by 1/6)."""
    out = np.zeros_like(temp)
    for axis in (0, 1, 2):
        out += np.roll(temp, 1, axis=axis) + np.roll(temp, -1, axis=axis)
    out /= 6.0
    gz, gy, gx = np.meshgrid(np.arange(temp.shape[0]),
                             np.arange(temp.shape[1]),
                             np.arange(temp.shape[2]), indexing="ij")
    hx, hy, hz = hot_c
    cx, cy, cz = cold_c
    d2h = (gx - hx) ** 2 + (gy - hy) ** 2 + (gz - hz) ** 2
    d2c = (gx - cx) ** 2 + (gy - cy) ** 2 + (gz - cz) ** 2
    out = np.where(d2h <= sph_r * sph_r, HOT_TEMP, out)
    out = np.where(d2c <= sph_r * sph_r, COLD_TEMP, out)
    return out.astype(temp.dtype)
