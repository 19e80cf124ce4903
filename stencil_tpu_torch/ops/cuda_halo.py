"""Hand-written CUDA kernels for the multi-device Jacobi step, with
plain twins.

PyTorch-port counterpart of the Jacobi half of
``stencil_tpu/ops/pallas_halo.py``: a shard stays interior-resident
(unpadded) and its halo arrives as four slab tensors from
``parallel.exchange.exchange_interior_slabs``.

==  ===================================  ==========================  ===========================
B   TPU kernel (pallas_halo.py)          wrapper                     plain twin
==  ===================================  ==========================  ===========================
B5  :115 ``jacobi7_halo_pallas``         ``jacobi7_halo_cuda``       ``jacobi7_halo_plain``
B6  :317 ``jacobi7_halon_pallas``        ``jacobi7_halon_cuda``      ``jacobi7_halon_plain``
==  ===================================  ==========================  ===========================

Both live in ``csrc/jacobi_halo.cu``; B6 is the z-streaming N-step ring
kernel of ``csrc/jacobi_ring.cuh`` (K2's body, its window rows read from
the shard and the slabs), launched as ``cuda_stencil.jacobi_ring_plan``
says. The module rules of
``ops/cuda_stencil.py`` hold: a CPU tensor goes to the plain twin; a
CUDA tensor launches the kernel or raises; each launch adds one to the
wrapper's entry in ``LAUNCHES``; float32 or bfloat16 (each kernel has a
bfloat16 instance that rounds after every operation, as the JAX kernels
compute a bfloat16 shard).

B6 takes ``1 <= steps <=`` the dtype's sublane tile (8 float32, 16
bfloat16). The ring kernel takes 8 a launch, so 9 to 16 steps are two
launches (``cuda_stencil.ring_split``): N1 = ceil(N / 2) steps from the
slabs over the shard grown by N2 = N - N1 rows in z and y, into a padded
buffer in device memory, then the last N2 steps from that buffer.

The two kernels add in different orders, as their JAX originals do (B5:
``((((ym+yp)+xm)+xp)+zm)+zp``, K1's; B6 per step:
``((zm+zp)+(ym+yp))+(xm+xp)``, K2's), so N B5 steps and one B6 launch
of N steps differ in the last bits, whatever ``pallas_halo.py:335-336``
says; each twin copies its own kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from .cuda_stencil import (_check, _check_cuda, _out, _sphere_args,
                           impose_spheres, is_bf16, jacobi_ring_plan,
                           ring_split, sm_count, sublane_tile)
from .stencil_kernels import sixth

#: launches per wrapper since the last ``reset_launch_counts``; only a
#: kernel launch counts, never a call that went to the plain twin
LAUNCHES = {"jacobi7_halo": 0, "jacobi7_halon": 0}

SLAB_NAMES = ("zlo", "zhi", "ylo", "yhi")


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------
def jacobi7_halo_plain(interior: torch.Tensor,
                       slabs: Dict[str, torch.Tensor], origin_zyx,
                       hot_c, cold_c, sph_r: int,
                       interior_len_zy: Optional[Sequence[int]] = None
                       ) -> torch.Tensor:
    """B5's twin: one Jacobi step plus the spheres on an interior-
    resident (Z, Y, X) shard, reading across its edges from the slabs,
    in the order of ``jacobi7_halo_pallas`` (pallas_halo.py:181-225).
    With ``interior_len_zy = (Lz, Ly)`` below the capacity, the rows
    z >= Lz-1 read ``zhi[0]`` as their z+ neighbour and the columns
    y >= Ly-1 ``yhi[:, 0]`` as their y+ one, as in the JAX kernel."""
    c = interior
    Z, Y, X = c.shape
    Lz, Ly = (Z, Y) if interior_len_zy is None else map(int, interior_len_zy)
    zlo, zhi, ylo, yhi = (slabs[k] for k in SLAB_NAMES)
    e = ylo.shape[1]
    ym = torch.cat([ylo[:, e - 1:e], c[:, :-1]], dim=1)
    yp = torch.cat([c[:, 1:], yhi[:, 0:1]], dim=1)
    yp[:, Ly - 1:] = yhi[:, 0:1]
    xm = torch.roll(c, 1, 2)
    xp = torch.roll(c, -1, 2)
    lat = ym + yp + xm + xp
    zm = torch.cat([zlo[-1:], c[:-1]], dim=0)
    zp = torch.cat([c[1:], zhi[0:1]], dim=0)
    zp[Lz - 1:] = zhi[0:1]
    new = (lat + zm + zp) * sixth(c.dtype, c.device)
    return impose_spheres(new, hot_c, cold_c, sph_r,
                          origin_zyx=tuple(int(v) for v in origin_zyx))


def _halon_window(interior: torch.Tensor, slabs: Dict[str, torch.Tensor],
                 steps: int) -> torch.Tensor:
    """B6's level-0 window: the (Z, Y, X) shard extended by ``steps``
    rows on each side in z and y, the y sides from the z-extended y
    slabs at every z, the z sides from the z slabs (pallas_halo.py
    ``ring_row``, :439-452)."""
    N = int(steps)
    c = interior
    Z = c.shape[0]
    zlo, zhi, ylo, yhi = (slabs[k] for k in SLAB_NAMES)
    rz = zlo.shape[0]
    e = ylo.shape[1]
    mid = torch.cat([zlo[rz - N:], c, zhi[:N]], dim=0)
    zs = slice(rz - N, rz + Z + N)
    return torch.cat([ylo[zs, e - N:], mid, yhi[zs, :N]], dim=1)


def jacobi7_halon_plain(interior: torch.Tensor,
                        slabs: Dict[str, torch.Tensor], origin_zyx,
                        gsize_zyx, hot_c, cold_c, sph_r: int,
                        steps: int = 2) -> torch.Tensor:
    """B6's twin: ``steps`` Jacobi steps on the window of
    ``_halon_window``, each in the order of ``jacobi7_halon_pallas``'s
    ``jstep`` (pallas_halo.py:404-410) and followed by the spheres at the
    global coordinates wrapped modulo ``gsize_zyx``. Each window value is
    a function of its position only, so the kernel's blocks, which
    recompute their ring, hold the same values as this whole-shard
    window."""
    N = int(steps)
    oz, oy, ox = (int(v) for v in origin_zyx)
    gsize = tuple(int(v) for v in gsize_zyx)
    w = _halon_window(interior, slabs, N)
    six = sixth(w.dtype, w.device)
    for k in range(N):
        zsum = w[:-2, 1:-1] + w[2:, 1:-1]
        ysum = w[1:-1, :-2] + w[1:-1, 2:]
        xsum = (torch.roll(w, 1, 2) + torch.roll(w, -1, 2))[1:-1, 1:-1]
        w = (zsum + ysum + xsum) * six
        ring = N - 1 - k
        w = impose_spheres(w, hot_c, cold_c, sph_r,
                           (oz - ring, oy - ring, ox), gsize)
    return w


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
_LIB = "jacobi_halo"
_I = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = {
    "jacobi7_halo_launch": [_P] * 6 + [_I] * 18 + [_P],
    "jacobi7_halon_launch": [_P] * 6 + [_I] * 24 + [_P],
    "jacobi7_halon_padded_launch": [_P] * 2 + [_I] * 22 + [_P],
}


def _launch(fn_name: str, device: torch.device, *args) -> None:
    from . import _build

    _build.launch(_LIB, fn_name, _SIGNATURES[fn_name], device, *args)


def _check_slabs(interior: torch.Tensor, slabs: Dict[str, torch.Tensor],
                 zext: bool, steps: int, what: str) -> Tuple[int, int]:
    """The slabs' (rz, e) after checking their shapes against the
    shard's (``zext``: z-extended y slabs) and that they hold ``steps``
    rows; on CUDA also device and contiguity."""
    Z, Y, X = interior.shape
    for k in SLAB_NAMES:
        t = slabs[k]
        if t.dtype != interior.dtype or t.device != interior.device:
            raise ValueError(f"{what}: slab {k} is {t.dtype} on {t.device}, "
                             f"the shard {interior.dtype} on "
                             f"{interior.device}")
        if interior.is_cuda:
            _check_cuda(t, f"{what} slab {k}")
    rz = slabs["zlo"].shape[0]
    e = slabs["ylo"].shape[1]
    zs = Z + 2 * rz if zext else Z
    want = {"zlo": (rz, Y, X), "zhi": (rz, Y, X), "ylo": (zs, e, X),
            "yhi": (zs, e, X)}
    for k, shape in want.items():
        if tuple(slabs[k].shape) != shape:
            raise ValueError(f"{what}: slab {k} has shape "
                             f"{tuple(slabs[k].shape)}, expected {shape}")
    if rz < steps or e < steps:
        raise ValueError(f"{what}: slabs of {rz} z rows and {e} y columns "
                         f"cannot feed {steps} step(s)")
    return rz, e


def jacobi7_halo_cuda(interior: torch.Tensor, slabs: Dict[str, torch.Tensor],
                      origin_zyx, hot_c, cold_c, sph_r: int,
                      interior_len_zy: Optional[Sequence[int]] = None,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B5: one Jacobi step plus spheres on an interior-resident (Z, Y, X)
    float32 or bfloat16 shard with slabs ``zlo/zhi (rz, Y, X)``,
    ``ylo/yhi (Z, e, X)``. ``origin_zyx``: the shard's global origin;
    ``interior_len_zy``: its actual (z, y) extents on a short (+-1)
    shard."""
    what = "jacobi7_halo_cuda"
    _check(interior, what)
    rz, e = _check_slabs(interior, slabs, False, 1, what)
    Z, Y, X = interior.shape
    Lz, Ly = (Z, Y) if interior_len_zy is None else map(int, interior_len_zy)
    if not (Z - 1 <= Lz <= Z and Y - 1 <= Ly <= Y and Lz >= 1 and Ly >= 1):
        raise ValueError(f"{what}: interior lengths ({Lz}, {Ly}) must be "
                         f"the capacity ({Z}, {Y}) or one less")
    out = _out(interior, out, interior.shape, what)
    if interior.device.type == "cpu":
        return out.copy_(jacobi7_halo_plain(interior, slabs, origin_zyx,
                                            hot_c, cold_c, sph_r, (Lz, Ly)))
    _check_cuda(interior, what)
    oz, oy, ox = (int(v) for v in origin_zyx)
    _launch("jacobi7_halo_launch", interior.device, interior.data_ptr(),
            out.data_ptr(), *(slabs[k].data_ptr() for k in SLAB_NAMES),
            Z, Y, X, rz, e, Lz, Ly, oz, oy, ox,
            *_sphere_args(hot_c, cold_c, sph_r), is_bf16(interior))
    LAUNCHES["jacobi7_halo"] += 1
    return out


def jacobi7_halon_cuda(interior: torch.Tensor,
                       slabs: Dict[str, torch.Tensor], origin_zyx, gsize_zyx,
                       hot_c, cold_c, sph_r: int, steps: int = 2,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B6: ``steps`` fused Jacobi steps (spheres after each, at global
    coordinates wrapped modulo ``gsize_zyx``) per radius-``steps`` slab
    exchange, on an evenly divided (Z, Y, X) float32 or bfloat16 shard
    with slabs ``zlo/zhi (rz, Y, X)`` and z-extended ``ylo/yhi (Z + 2 rz,
    e, X)``, ``rz, e >= steps``: the port's own ``rz = steps`` slabs or
    JAX's ``rz = block_z``. ``1 <= steps <=`` the sublane tile, the JAX
    kernel's limit (8 float32, 16 bfloat16)."""
    what = "jacobi7_halon_cuda"
    _check(interior, what)
    N = int(steps)
    tile = sublane_tile(interior.dtype)
    if N < 1 or N > tile:
        raise ValueError(f"{what}: needs 1 <= steps <= {tile}, got "
                         f"steps={N}")
    rz, e = _check_slabs(interior, slabs, True, N, what)
    out = _out(interior, out, interior.shape, what)
    if interior.device.type == "cpu":
        return out.copy_(jacobi7_halon_plain(interior, slabs, origin_zyx,
                                             gsize_zyx, hot_c, cold_c,
                                             sph_r, steps=N))
    _check_cuda(interior, what)
    Z, Y, X = interior.shape
    oz, oy, ox = (int(v) for v in origin_zyx)
    gz, gy, gx = (int(v) for v in gsize_zyx)
    dev, isz, bf = interior.device, interior.element_size(), is_bf16(interior)
    spheres = _sphere_args(hot_c, cold_c, sph_r)
    split = ring_split(N)
    grow = N - split[0]  # the rows the second launch reads beyond the shard
    dst = out if grow == 0 else torch.empty(
        (Z + 2 * grow, Y + 2 * grow, X), dtype=interior.dtype, device=dev)
    plan = jacobi_ring_plan(Z + 2 * grow, Y + 2 * grow, X, split[0],
                            sm_count(dev), isz)
    _launch("jacobi7_halon_launch", dev, interior.data_ptr(),
            dst.data_ptr(), *(slabs[k].data_ptr() for k in SLAB_NAMES),
            Z, Y, X, rz, e, oz, oy, ox, gz, gy, gx, *spheres, split[0],
            *plan[:3], grow, bf)
    if grow:
        plan = jacobi_ring_plan(Z, Y, X, grow, sm_count(dev), isz)
        _launch("jacobi7_halon_padded_launch", dev, dst.data_ptr(),
                out.data_ptr(), Z, Y, X, grow, oz, oy, ox, gz, gy, gx,
                *spheres, grow, *plan[:3], bf)
    LAUNCHES["jacobi7_halon"] += 1
    return out
