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
* ``auto`` — on CUDA devices, JAX's on-TPU choice: ``overlap`` when
  overlap is asked for and possible, else ``wrap`` on a (1,1,1) mesh,
  else ``halo`` when x is unsharded, else ``xla`` (a kernel path only for
  float32); on the CPU ``xla``, as the JAX model picks it off-TPU.

The padded paths exchange by ``methods`` (``Method`` flags, JAX's
``DistributedDomain.set_methods``): ``Method.PallasDMA`` is B4's
remote-write sweep, the others the slab copy.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed import DeviceLike, DistributedDomain, torch_dtype
from ..geometry import Dim3, Dim3Like, Radius
from ..ops.cuda_halo import jacobi7_halo_cuda, jacobi7_halon_cuda
from ..ops.cuda_overlap import OverlapRecv, jacobi7_overlap_cuda
from ..ops.cuda_stencil import (COLD_TEMP, HOT_TEMP, impose_spheres,
                                jacobi7_padded_cuda, jacobi7_wrap_cuda,
                                jacobi7_wrapn_cuda, sublane_tile)
from ..ops.halo_plan import pair_halo_refusal
from ..ops.stencil_kernels import jacobi7, write_interior
from ..parallel.exchange import (dispatch_exchange, exchange_interior_slabs,
                                 interior_slab_bytes, shard_interior_len,
                                 shard_origin)
from ..parallel.mesh import mesh_index
from ..parallel.methods import Method, pick_method
from ..parallel.overlap import overlapped_update
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
                   cold_c: Dim3, sph_r: int) -> torch.Tensor:
    """Re-impose the Dirichlet hot/cold spheres on a shard's interior
    whose global origin is ``origin_xyz`` (reference:
    bin/jacobi3d.cu:40-63)."""
    ox, oy, oz = origin_xyz
    return impose_spheres(new, hot_c, cold_c, sph_r, origin_zyx=(oz, oy, ox))


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
                      method: Method = Method.Default) -> None:
    """One Jacobi step on the padded shards of a mesh (x fastest):
    exchange by ``method``, then per shard the 7-point update of its
    capacity interior plus the Dirichlet sphere sources at its own
    origin, written back in place (the JAX version runs one shard under
    ``shard_map`` and returns a new array). ``kernel``: "xla" (plain
    PyTorch) or "pallas" (K3, ``jacobi7_padded_cuda``)."""
    hot_c, cold_c, sph_r = sphere_geometry(gsize)
    dispatch_exchange({"temp": shards}, radius, counts, method, rem=rem,
                      nonperiodic=nonperiodic)
    for i, p in enumerate(shards):
        new = _update(p, radius, local, kernel)
        origin = shard_origin(local, rem, mesh_index(i, counts))
        new = _apply_sources(new, origin, hot_c, cold_c, sph_r)
        write_interior(p, new, radius)


def jacobi_shard_step_overlap(shards: Sequence[torch.Tensor],
                              radius: Radius, counts: Dim3, local: Dim3,
                              gsize: Dim3, method: Method,
                              kernel: str = "xla",
                              nonperiodic: bool = False) -> None:
    """The overlapped variant of ``jacobi_shard_step`` on an evenly
    divided mesh (JAX: models/jacobi.py:125-149): the deep interior of
    every shard is computed while the exchange runs, the thin face
    slabs from the exchanged shards afterwards
    (``parallel/overlap.py``), then the spheres and the write-back."""
    hot_c, cold_c, sph_r = sphere_geometry(gsize)

    def upd(blocks, dims, off, i):
        return {"temp": _update(blocks["temp"], radius, dims, kernel)}

    new = overlapped_update({"temp": list(shards)}, radius, counts, method,
                            upd, nonperiodic=nonperiodic)
    for i, p in enumerate(shards):
        origin = shard_origin(local, Dim3(0, 0, 0), mesh_index(i, counts))
        out = _apply_sources(new[i]["temp"], origin, hot_c, cold_c, sph_r)
        write_interior(p, out, radius)


def select_kernel_path(kernel: str, overlap: bool, counts: Dim3, rem: Dim3,
                       local: Dim3, radius_ok: bool, nonperiodic: bool,
                       on_gpu: bool, f32: bool) -> str:
    """The compute path ``Jacobi3D`` builds: JAX's selection rules
    (models/jacobi.py:439-504, :557-570) with its on-TPU choice taken on
    CUDA devices, where the port's kernels run (and, as they take
    float32 only, for a float32 domain). Raises as JAX does for an
    explicit kernel its conditions exclude."""
    if overlap and rem != Dim3(0, 0, 0):
        raise NotImplementedError("overlap mode requires an evenly "
                                  "divisible grid")
    accel = on_gpu and f32
    wrap_ok = (counts == Dim3(1, 1, 1) and rem == Dim3(0, 0, 0)
               and not overlap and radius_ok and not nonperiodic)
    halo_ok = counts.x == 1 and not overlap and radius_ok and not nonperiodic
    overlap_ok = (overlap and counts.x == 1 and radius_ok
                  and local.z >= 4 and local.y >= 2 and not nonperiodic)
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
    return f"{kernel}-overlap" if overlap else kernel


def _wrap_steps(tile: int) -> int:
    """Temporal-blocking depth of the wrap and halo paths, as in the JAX
    model: STENCIL_WRAP_STEPS (default 2), clamped to [1, tile] — the
    TPU's sublane tile, kept so that both packages group the same steps
    the same way."""
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
                 overlap: bool = False) -> None:
        if kernel not in ("auto", "wrap", "halo", "xla", "pallas"):
            raise ValueError(
                f"kernel must be auto|wrap|halo|xla|pallas, got {kernel!r}")
        self.dd = DistributedDomain(x, y, z, device=device, devices=devices)
        self.dd.set_radius(1)
        self.dd.set_methods(methods)
        if boundary is not None:
            self.dd.set_boundary(boundary)
        devs = self.dd._devices
        on_gpu = all(d.type == "cuda" for d in devs)
        if mesh_shape is not None:
            self.dd.set_mesh_shape(mesh_shape)
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
        # the port's kernels take float32 only, so ``auto`` picks them
        # only for a float32 domain
        f32 = self._dtype == torch.float32
        path = select_kernel_path(
            self._kernel, self._overlap, dd.mesh_counts, dd.rem,
            dd.local_size, radius_ok, dd.boundary == Boundary.NONE,
            all(d.type == "cuda" for d in dd.mesh.devices), f32)
        if self._kernel == "auto" or path == "overlap":
            LOG_INFO(f"jacobi kernel path: {path}")
        kernel = path.split("-")[0]
        if kernel in ("wrap", "halo", "pallas", "overlap") and not f32:
            raise TypeError(f"kernel={kernel!r} runs CUDA kernels that take "
                            f"float32 only, got {self._dtype}; use "
                            f"kernel='xla'")
        self._method = pick_method(dd.methods)
        tile = sublane_tile(self._dtype)
        if kernel == "wrap":
            self._wrap_n = _wrap_steps(tile)
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

    def _build_halo_step(self, tile: int) -> None:
        """JAX's ``_build_halo_step`` rules (models/jacobi.py:838-878):
        N-step groups when the grid divides evenly, the shard's y extent
        is a multiple of the sublane tile, N > 1 and the JAX planner
        finds a blocking; the single-step kernel otherwise."""
        local = self.dd.local_size
        self._halo_n = N = _wrap_steps(tile)
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
        dd = self.dd
        nonper = dd.boundary == Boundary.NONE
        for _ in range(iters):
            if self._overlap:
                jacobi_shard_step_overlap(
                    dd.curr["temp"], dd.radius, dd.mesh_counts,
                    dd.local_size, dd.size, self._method,
                    kernel=self._base_kernel, nonperiodic=nonper)
            else:
                jacobi_shard_step(dd.curr["temp"], dd.radius,
                                  dd.mesh_counts, dd.local_size, dd.size,
                                  kernel=self._base_kernel, rem=dd.rem,
                                  nonperiodic=nonper, method=self._method)

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
        a = [p[cap].contiguous() for p in dd.curr["temp"]]
        b = [torch.empty_like(t) for t in a]
        orgs, lens = [], []
        for i in range(len(a)):
            idx = dd.shard_index(i)
            ox, oy, oz = shard_origin(local, rem, idx)
            orgs.append((oz, oy, ox))
            lens.append((shard_interior_len(2, local.z, rem, idx.z),
                         shard_interior_len(1, local.y, rem, idx.y)))
        N = self._halo_n
        tail = n
        if self._halo_pair_ok:
            for _ in range(n // N):
                slabs = exchange_interior_slabs(a, counts, rz=N, ry=N,
                                                y_z_extended=True)
                for i in range(len(a)):
                    jacobi7_halon_cuda(a[i], slabs[i], orgs[i], gsize, hot,
                                       cold, sph_r, steps=N, out=b[i])
                a, b = b, a
            tail = n % N
        for _ in range(tail):
            slabs = exchange_interior_slabs(a, counts, rz=1, ry=1, rem=rem)
            for i in range(len(a)):
                jacobi7_halo_cuda(a[i], slabs[i], orgs[i], hot, cold, sph_r,
                                  interior_len_zy=lens[i], out=b[i])
            a, b = b, a
        for p, t in zip(dd.curr["temp"], a):
            p[cap].copy_(t)

    def _run_overlap(self, n: int) -> None:
        """As ``_run_halo``: each shard's capacity interior (the grid is
        even here) sliced into a contiguous tensor once, ping-ponged with
        a second buffer through B7, and written back once; the halos go
        stale. The shards' receive slabs persist across runs. The steps
        run in one ``OverlapRecv.session``: between them only B7's two
        ordering rules join the shards' streams."""
        dd = self.dd
        counts, local = dd.mesh_counts, dd.local_size
        hot, cold, sph_r = sphere_geometry(dd.size)
        cap = self._capacity_slices()
        a = [p[cap].contiguous() for p in dd.curr["temp"]]
        b = [torch.empty_like(t) for t in a]
        orgs = []
        for i in range(len(a)):
            ox, oy, oz = shard_origin(local, dd.rem, dd.shard_index(i))
            orgs.append((oz, oy, ox))
        if self._overlap_recv is None:
            self._overlap_recv = OverlapRecv(a, counts)
        recv = self._overlap_recv
        with recv.session():
            for _ in range(n):
                jacobi7_overlap_cuda(a, orgs, hot, cold, sph_r, counts,
                                     out=b, recv=recv)
                a, b = b, a
        for p, t in zip(dd.curr["temp"], a):
            p[cap].copy_(t)

    def block(self) -> None:
        device_sync(self.dd.curr["temp"])

    def temperature(self) -> np.ndarray:
        """Global interior (z,y,x) on the host."""
        return self.dd.interior_to_host("temp")

    def exchange_stats(self) -> dict:
        """Per-iteration exchange accounting of the built path (JAX's,
        models/jacobi.py:950-993): bytes that cross between shards per
        iteration, whole mesh, and exchange rounds per iteration. The
        wrap path has none; the halo path counts its slab transfers
        (``interior_slab_bytes``) over its group length, the overlap path
        its single-row face slabs; the padded paths exchange once a
        step."""
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
        return {"path": path,
                "bytes_per_iteration":
                    float(self.dd.exchange_bytes_amortized_per_step()),
                "rounds_per_iteration": 1.0}

    def measure_exchange_seconds(self, reps: int = 10) -> float:
        """Exchange seconds per ITERATION of the built path: the halo
        path's slab exchange of one group (timed on zero shards) over
        its group length (the overlap path: a round of its single-row
        face slabs), or one ``dd.exchange()`` on the padded paths; 0.0
        on the wrap path, which has no exchange."""
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
        return (time.perf_counter() - t0) / reps

    def slab_exchange_seconds(self, reps: int = 10) -> float:
        """Seconds of one ``exchange_interior_slabs`` round of the halo
        (or overlap) path's slab configuration over all shards, on
        capacity-sized zero shards (the state is not touched)."""
        cfg = self._slab_exchange_cfg
        dd = self.dd
        c = dd.local_size
        shards = [torch.zeros((c.z, c.y, c.x), dtype=self._dtype, device=d)
                  for d in dd.mesh.devices]
        rem = Dim3(0, 0, 0) if cfg["y_z_extended"] else dd.rem

        def once() -> List:
            return exchange_interior_slabs(
                shards, dd.mesh_counts, rz=cfg["rz"], ry=cfg["ry"],
                radius_rows=cfg["radius_rows"],
                y_z_extended=cfg["y_z_extended"], rem=rem)

        once()
        device_sync(shards)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = once()
        device_sync([s["yhi"] for s in out])
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
