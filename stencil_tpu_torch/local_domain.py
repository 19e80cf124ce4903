"""LocalDomain: one subdomain's halo-padded, double-buffered fields.

PyTorch-port counterpart of ``stencil_tpu/local_domain.py`` (reference:
include/stencil/local_domain.cuh:34-276, src/local_domain.cu:86-219):
the halo geometry helpers, the ``LocalDomain`` class with its
``Accessor`` and the interior/exterior region queries
(``get_interior``, ``get_exterior``; reference: src/stencil.cu:874-977)
that let an application compute the interior while the exchange runs.
Tensors are indexed ``t[z, y, x]`` with x contiguous, as in the JAX
package; ``Dim3`` values stay (x, y, z) ordered and ``zyx_shape``
converts at the tensor boundary.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .geometry import Dim3, Dim3Like, Radius, Rect3


def zyx_shape(sz: Dim3Like) -> Tuple[int, int, int]:
    """Convert an (x,y,z) Dim3 into a (z,y,x) tensor shape."""
    sz = Dim3.of(sz)
    return (sz.z, sz.y, sz.x)


def halo_pos(dir: Dim3Like, sz: Dim3Like, radius: Radius, halo: bool) -> Dim3:
    """Offset (in allocation coordinates, x/y/z order) of the halo region
    on side ``dir``: the *halo* itself when ``halo`` is True, else the
    interior ("exterior compute") region adjacent to that side.
    ``dir == 0`` on an axis selects the whole interior span on that axis.
    (reference: src/local_domain.cu:86-129 halo_pos)
    """
    dir = Dim3.of(dir)
    sz = Dim3.of(sz)
    out: List[int] = []
    for axis in range(3):
        d = dir[axis]
        n = sz[axis]
        r_lo = radius.face(axis, -1)
        if d == 1:
            out.append(n + (r_lo if halo else 0))
        elif d == -1:
            out.append(0 if halo else r_lo)
        else:
            out.append(r_lo)
    return Dim3(*out)


def halo_extent(dir: Dim3Like, sz: Dim3Like, radius: Radius) -> Dim3:
    """Point-extent of the halo region on side ``dir``; components use
    the *face* radii (reference: local_domain.cuh:212-222 halo_extent).
    ``dir == (0,0,0)`` returns ``sz``.
    """
    dir = Dim3.of(dir)
    sz = Dim3.of(sz)
    out: List[int] = []
    for axis in range(3):
        d = dir[axis]
        out.append(sz[axis] if d == 0 else radius.face(axis, d))
    return Dim3(*out)


def halo_bytes(dir: Dim3Like, sz: Dim3Like, radius: Radius, elem_size: int) -> int:
    """Bytes of one quantity's halo region on side ``dir``
    (reference: local_domain.cuh halo_bytes)."""
    return elem_size * halo_extent(dir, sz, radius).flatten()


def raw_size(sz: Dim3Like, radius: Radius) -> Dim3:
    """Allocation size including halo padding
    (reference: local_domain.cuh raw_size())."""
    sz = Dim3.of(sz)
    return sz + radius.pad_lo() + radius.pad_hi()


def interior_slices(sz: Dim3Like, radius: Radius
                    ) -> Tuple[slice, slice, slice]:
    """(z, y, x) slices selecting the compute interior of a padded
    field (``LocalDomain.interior_slices`` in the JAX package)."""
    sz = Dim3.of(sz)
    lo = radius.pad_lo()
    return (slice(lo.z, lo.z + sz.z), slice(lo.y, lo.y + sz.y),
            slice(lo.x, lo.x + sz.x))


class Accessor:
    """Global-coordinate indexing into a padded local tensor (reference:
    include/stencil/accessor.hpp:14-49): ``acc[(x, y, z)]`` reads the
    element at global grid coordinate (x, y, z) of the padded (z,y,x)
    tensor; the stored origin is ``domain origin - pad_lo``, so halo
    cells are addressable too."""

    def __init__(self, arr, origin: Dim3Like, radius: Radius) -> None:
        self.arr = arr
        self.origin = Dim3.of(origin) - radius.pad_lo()

    def __getitem__(self, p: Dim3Like):
        p = Dim3.of(p) - self.origin
        return self.arr[p.z, p.y, p.x]

    def set(self, p: Dim3Like, v):
        """Write ``v`` at global coordinate ``p`` in place (JAX's
        functional update returns a new array; a tensor is updated) and
        return the tensor."""
        p = Dim3.of(p) - self.origin
        self.arr[p.z, p.y, p.x] = v
        return self.arr


class LocalDomain:
    """One subdomain's quantities on one device: halo-padded,
    double-buffered tensors plus the halo-geometry queries (reference:
    include/stencil/local_domain.cuh:34-276). ``device`` is explicit:
    the CUDA device unless the caller names another."""

    def __init__(self, sz: Dim3Like, origin: Dim3Like, radius: Radius,
                 device=None) -> None:
        self.sz = Dim3.of(sz)
        self.origin = Dim3.of(origin)
        self.radius = radius
        self.device = device
        self._names: List[str] = []
        self._dtypes: Dict[str, torch.dtype] = {}
        self.curr: Dict[str, torch.Tensor] = {}
        self.next_: Dict[str, torch.Tensor] = {}

    # -- data management (reference: local_domain.cuh add_data) -------
    def add_data(self, name: str, dtype=torch.float32) -> None:
        from .distributed import torch_dtype

        if name in self._dtypes:
            raise ValueError(f"duplicate quantity {name}")
        self._names.append(name)
        self._dtypes[name] = torch_dtype(dtype)

    def num_data(self) -> int:
        return len(self._names)

    @property
    def names(self) -> List[str]:
        return list(self._names)

    def elem_size(self, name: str) -> int:
        return self._dtypes[name].itemsize

    def realize(self) -> None:
        """Allocate zeroed curr/next padded tensors for every quantity on
        the domain's device (reference: src/local_domain.cu:159-219)."""
        from .distributed import resolve_device

        dev = resolve_device(self.device)
        shape = zyx_shape(self.raw_size())
        for name in self._names:
            dt = self._dtypes[name]
            self.curr[name] = torch.zeros(shape, dtype=dt, device=dev)
            self.next_[name] = torch.zeros(shape, dtype=dt, device=dev)

    def swap(self) -> None:
        self.curr, self.next_ = self.next_, self.curr

    # -- geometry -----------------------------------------------------
    def raw_size(self) -> Dim3:
        return raw_size(self.sz, self.radius)

    def size(self) -> Dim3:
        return self.sz

    def halo_pos(self, dir: Dim3Like, halo: bool) -> Dim3:
        return halo_pos(dir, self.sz, self.radius, halo)

    def halo_extent(self, dir: Dim3Like) -> Dim3:
        return halo_extent(dir, self.sz, self.radius)

    def halo_bytes(self, dir: Dim3Like, name: str) -> int:
        return halo_bytes(dir, self.sz, self.radius, self.elem_size(name))

    def halo_coords(self, dir: Dim3Like, halo: bool) -> Rect3:
        """Global coordinates of the halo (``halo=True``) or of the
        interior send region beside side ``dir`` (``halo=False``), whose
        width is the opposite face radius — the receiver's halo on its
        ``-dir`` side (reference: src/packer.cu:116-118; JAX
        ``local_domain.py:205-222``)."""
        pos = self.halo_pos(dir, halo)
        ext = self.halo_extent(Dim3.of(dir) if halo else -Dim3.of(dir))
        pos = pos - self.radius.pad_lo() + self.origin
        return Rect3(pos, pos + ext)

    def get_compute_region(self) -> Rect3:
        return Rect3(self.origin, self.origin + self.sz)

    # -- accessors ----------------------------------------------------
    def get_curr_accessor(self, name: str) -> Accessor:
        return Accessor(self.curr[name], self.origin, self.radius)

    def get_next_accessor(self, name: str) -> Accessor:
        return Accessor(self.next_[name], self.origin, self.radius)

    # -- host copies (reference: src/local_domain.cu:131-157) ---------
    def interior_slices(self) -> Tuple[slice, slice, slice]:
        """(z, y, x) slices selecting the compute interior of a padded
        tensor."""
        return interior_slices(self.sz, self.radius)

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def interior_to_host(self, name: str) -> np.ndarray:
        """The compute region on the host, (z,y,x) ordered (bfloat16 as
        float32 of the same values: numpy has no bfloat16)."""
        return self._host(self.curr[name][self.interior_slices()])

    def quantity_to_host(self, name: str) -> np.ndarray:
        """The full padded region (halos included) on the host."""
        return self._host(self.curr[name])


def interior_shrink(radius: Radius) -> Tuple[Dim3, Dim3]:
    """How far the interior pulls in from the compute region on the
    (lo, hi) side of each axis: the max radius over every direction
    touching that side (reference: src/stencil.cu:874-921)."""
    lo = Dim3(radius.max_side(0, -1), radius.max_side(1, -1),
              radius.max_side(2, -1))
    hi = Dim3(radius.max_side(0, 1), radius.max_side(1, 1),
              radius.max_side(2, 1))
    return lo, hi


def get_interior(dom: LocalDomain) -> Rect3:
    """The interior region: points whose stencil reads never touch the
    halo (reference: src/stencil.cu:874-921)."""
    lo_s, hi_s = interior_shrink(dom.radius)
    com = dom.get_compute_region()
    lo = com.lo + lo_s
    hi = com.hi - hi_s
    return Rect3(lo.elementwise_min(hi), hi.elementwise_max(lo))


def get_exterior(dom: LocalDomain) -> List[Rect3]:
    """Non-overlapping face slabs covering the compute region minus the
    interior, by sliding the faces in (+x, +y, +z, -x, -y, -z order;
    reference: src/stencil.cu:927-977)."""
    int_reg = get_interior(dom)
    com = dom.get_compute_region()
    out: List[Rect3] = []
    lo = [com.lo.x, com.lo.y, com.lo.z]
    hi = [com.hi.x, com.hi.y, com.hi.z]
    for axis in (0, 1, 2):  # +x, +y, +z
        if int_reg.hi[axis] != hi[axis]:
            r_lo, r_hi = list(lo), list(hi)
            r_lo[axis] = int_reg.hi[axis]
            out.append(Rect3.of(tuple(r_lo), tuple(r_hi)))
            hi[axis] = int_reg.hi[axis]
    for axis in (0, 1, 2):  # -x, -y, -z
        if int_reg.lo[axis] != lo[axis]:
            r_lo, r_hi = list(lo), list(hi)
            r_hi[axis] = int_reg.lo[axis]
            out.append(Rect3.of(tuple(r_lo), tuple(r_hi)))
            lo[axis] = int_reg.lo[axis]
    return out
