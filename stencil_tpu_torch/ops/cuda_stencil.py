"""Hand-written CUDA kernels for the Jacobi stencil, with plain twins.

PyTorch-port counterpart of ``stencil_tpu/ops/pallas_stencil.py``. Each
TPU kernel becomes a CUDA kernel for Hopper (``csrc/jacobi7.cu``) behind
a wrapper, and a plain PyTorch twin that computes the same function in
the same order of operations:

==  ==================================  ===========================  ========================
K   TPU kernel (pallas_stencil.py)      wrapper                      plain twin
==  ==================================  ===========================  ========================
K1  :134 ``jacobi7_wrap_pallas``        ``jacobi7_wrap_cuda``        ``jacobi7_wrap_plain``
K2  :246 ``jacobi7_wrapn_pallas``       ``jacobi7_wrapn_cuda``       ``jacobi7_wrapn_plain``
K3  :72 ``jacobi7_pallas``              ``jacobi7_padded_cuda``      ``jacobi7_padded_plain``
B8  :432 ``laplace6_pallas``            ``laplace6_cuda``            ``laplace6_plain``
==  ==================================  ===========================  ========================

K1–K3 live in ``csrc/jacobi7.cu``, B8 in ``csrc/laplace6.cu``; K2 is
the z-streaming N-step ring kernel of ``csrc/jacobi_ring.cuh``, which B6
(``ops/cuda_halo.py``) launches too, each with the tile, prefetch depth
and z run of ``jacobi_ring_plan``; B8 is a z-streaming radius-3 ring
kernel of its own, launched as ``laplace6_plan`` says. A
wrapper dispatches on the tensor's device: a CPU tensor goes to the
plain twin (that is how the tests run); a CUDA tensor launches the
kernel or raises — it never falls back. Each launch adds one to the
wrapper's entry in ``LAUNCHES``. K1–K3 take float32 or bfloat16 (a
bfloat16 instance of each kernel: every add and the multiply by
bf16(1/6) round to bfloat16 at once, in the kernel's order, as the JAX
kernels compute a bfloat16 field) and refuse any other dtype on the CPU
too; B8 takes float32 on the card, while ``laplace6_cuda`` hands a CPU
tensor of any float dtype to its twin, as the MHD wrappers do.

K2 takes ``1 <= steps <=`` the dtype's sublane tile: 8 for float32, 16
for bfloat16. The ring kernel takes 8 a launch, so bfloat16 runs 9 to 16
steps as two launches, ceil(N / 2) steps into a field in device memory
and the rest from it; every value of the ring depends only on its
position, so the two launches compute what one of N steps would.

The two wrap kernels add in different orders, as their JAX originals
do (K1: ``((((ym+yp)+xm)+xp)+zm)+zp``; K2 per step:
``((zm+zp)+(ym+yp))+(xm+xp)``), so N calls of K1 and one K2 launch of
N steps differ in the last bits; each twin copies its own kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry import Dim3, Radius
from .fd6 import _D2, _D2_C, const
from .stencil_kernels import sixth

HOT_TEMP = 1.0   # reference: bin/jacobi3d.cu:12
COLD_TEMP = 0.0  # reference: bin/jacobi3d.cu:11

#: launches per wrapper since the last ``reset_launch_counts``; only a
#: kernel launch counts, never a call that went to the plain twin
LAUNCHES = {"jacobi7_wrap": 0, "jacobi7_wrapn": 0, "jacobi7_padded": 0,
            "laplace6": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sublane_tile_bytes(itemsize: int) -> int:
    """The TPU's minimum sublane tile rows for an ``itemsize``-byte
    dtype (8 for 4-byte types). The GPU has no such tile; the port keeps
    the rule (``Y % tile == 0`` for the N-step kernel, ``N <= tile``) so
    that a grid takes the same path, and the same grouping of steps, in
    both packages."""
    return max(8, 32 // max(itemsize, 1))


def sublane_tile(dtype: torch.dtype) -> int:
    return sublane_tile_bytes(torch.empty((), dtype=dtype).element_size())


#: the storage dtypes of the Jacobi kernels (K1-K3, B5-B7)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: the steps one launch of the ring kernel takes (``kMaxSteps``)
RING_MAX_STEPS = 8


def ring_split(steps: int) -> Tuple[int, ...]:
    """The steps of each ring launch of an N-step call: N itself up to
    ``RING_MAX_STEPS``, else ceil(N / 2) and the rest."""
    N = int(steps)
    if N <= RING_MAX_STEPS:
        return (N,)
    return (-(-N // 2), N // 2)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------
def impose_spheres(vals: torch.Tensor, hot_c: Tuple[int, int, int],
                   cold_c: Tuple[int, int, int], sph_r: int,
                   origin_zyx: Tuple[int, int, int] = (0, 0, 0),
                   period_zyx: Optional[Tuple[int, int, int]] = None,
                   temps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> torch.Tensor:
    """Re-impose the Dirichlet spheres on a (Z, Y, X) block whose
    global origin is ``origin_zyx``: hot (1) first, then cold (0), which
    wins where the two overlap (reference: bin/jacobi3d.cu:40-63).
    ``hot_c``/``cold_c`` are (cx, cy, cz). ``period_zyx``: wrap the
    coordinates modulo the global grid first (floor modulo, so a ring
    cell at a negative coordinate wraps to the top), as the N-step halo
    kernel's ring cells need (pallas_halo.py:388-402). ``temps``: the
    (hot, cold) values as tensors in ``vals``' dtype on its device in
    place of the constants — an ensemble's per-member temperatures,
    ``(N, 1, 1, 1)`` against an (N, Z, Y, X) block (JAX
    ``serving/ensemble.py:580-583``)."""
    dev = vals.device
    gz, gy, gx = (o + torch.arange(n, device=dev, dtype=torch.int32)
                  for n, o in zip(vals.shape[-3:], origin_zyx))
    if period_zyx is not None:
        gz, gy, gx = (g % p for g, p in zip((gz, gy, gx), period_zyx))
    r2 = sph_r * sph_r
    if temps is None:
        temps = tuple(torch.full((), t, dtype=vals.dtype, device=dev)
                      for t in (HOT_TEMP, COLD_TEMP))
    for (cx, cy, cz), temp in zip((hot_c, cold_c), temps):
        d2 = (((gz - cz) ** 2)[:, None, None] + ((gy - cy) ** 2)[None, :, None]
              + ((gx - cx) ** 2)[None, None, :])
        vals = torch.where(d2 <= r2, temp, vals)
    return vals


def jacobi7_wrap_plain(interior: torch.Tensor, hot_c, cold_c,
                       sph_r: int) -> torch.Tensor:
    """K1's twin: one periodic 7-point step on an unpadded (Z, Y, X)
    field plus the spheres, in the order of ``jacobi7_wrap_pallas``
    (pallas_stencil.py:198, :207)."""
    c = interior
    ym = torch.roll(c, 1, 1)
    yp = torch.roll(c, -1, 1)
    xm = torch.roll(c, 1, 2)
    xp = torch.roll(c, -1, 2)
    lat = ym + yp + xm + xp
    new = (lat + torch.roll(c, 1, 0) + torch.roll(c, -1, 0)) \
        * sixth(c.dtype, c.device)
    return impose_spheres(new, hot_c, cold_c, sph_r)


def jacobi7_wrapn_plain(interior: torch.Tensor, hot_c, cold_c, sph_r: int,
                        steps: int = 2) -> torch.Tensor:
    """K2's twin: ``steps`` periodic steps, spheres after each, each
    step in the order of ``jacobi7_wrapn_pallas``'s ``jstep``
    (pallas_stencil.py:325-330). The kernel's recomputed ring holds the
    same values as these full-field steps, so the two agree bitwise."""
    w = interior
    for _ in range(steps):
        zsum = torch.roll(w, 1, 0) + torch.roll(w, -1, 0)
        ysum = torch.roll(w, 1, 1) + torch.roll(w, -1, 1)
        xsum = torch.roll(w, 1, 2) + torch.roll(w, -1, 2)
        w = (zsum + ysum + xsum) * sixth(w.dtype, w.device)
        w = impose_spheres(w, hot_c, cold_c, sph_r)
    return w


def jacobi7_padded_plain(padded: torch.Tensor, radius: Radius,
                         interior: Dim3) -> torch.Tensor:
    """K3's twin: the 7-point average over a halo-padded shard, in the
    order of ``jacobi7_pallas`` (pallas_stencil.py:89-94); returns the
    (Z, Y, X) interior."""
    lo = radius.pad_lo()
    Z, Y, X = interior.z, interior.y, interior.x
    ly, lx = lo.y, lo.x

    def plane(dz, dy, dx):
        return padded[lo.z + dz:lo.z + dz + Z, ly + dy:ly + dy + Y,
                      lx + dx:lx + dx + X]

    acc = plane(-1, 0, 0) + plane(1, 0, 0)
    acc = acc + plane(0, -1, 0)
    acc = acc + plane(0, 1, 0)
    acc = acc + plane(0, 0, -1)
    acc = acc + plane(0, 0, 1)
    return acc * sixth(padded.dtype, padded.device)


def laplace6_plain(padded: torch.Tensor, radius: Radius, interior: Dim3,
                   inv_ds: Tuple[float, float, float] = (1.0, 1.0, 1.0)
                   ) -> torch.Tensor:
    """B8's twin: the 6th-order Laplacian over a radius-3-padded shard,
    in the order of ``laplace6_pallas`` (pallas_stencil.py:451-465):
    ``accx``, ``accy`` and ``accz`` each start at ``D2_C * centre`` and
    add ``w_i * (hi + lo)`` for i = 1..3; then ``accx * ix2 + accy * iy2
    + accz * iz2``. Returns the (Z, Y, X) interior; any float dtype."""
    lo = radius.pad_lo()
    Z, Y, X = interior.z, interior.y, interior.x
    dt = padded.dtype

    def at(dz, dy, dx):
        return padded[lo.z + dz:lo.z + dz + Z, lo.y + dy:lo.y + dy + Y,
                      lo.x + dx:lo.x + dx + X]

    ctr = at(0, 0, 0)
    accx = const(_D2_C, dt) * ctr
    accy = accx
    accz = const(_D2_C, dt) * ctr
    for i, w in enumerate(_D2, start=1):
        wc = const(w, dt)
        accx = accx + wc * (at(0, 0, i) + at(0, 0, -i))
        accy = accy + wc * (at(0, i, 0) + at(0, -i, 0))
        accz = accz + wc * (at(i, 0, 0) + at(-i, 0, 0))
    ix2, iy2, iz2 = (const(v * v, dt) for v in inv_ds)
    return accx * ix2 + accy * iy2 + accz * iz2


# ---------------------------------------------------------------------------
# the N-step ring kernel's launch plan (K2 and B6)
# ---------------------------------------------------------------------------
#: the ring kernel's threads a block, the registers an SM holds, and the
#: registers the card allots a thread of the kernel: its 77-78
#: (``-Xptxas=-v``) in the card's unit of 8, which the card tests hold
#: the build to; so three blocks an SM where shared memory allows
RING_THREADS = 256
SM_REGISTERS = 64 * 1024
RING_REGISTERS = 80
#: shared memory of an H100 SM, the most one block may ask for, what the
#: runtime keeps per block, and the kernel's static tables: a ``RowSrc``
#: (three pointers and a stride) for each of ``kMaxWY`` window rows and
#: an ``int2`` of squared distances for each of ``kMaxWX`` columns and
#: ``kMaxWY`` rows (csrc/jacobi_ring.cuh)
SM_SMEM_BYTES = 228 * 1024
BLOCK_SMEM_BYTES = 227 * 1024
BLOCK_RESERVED_BYTES = 1024
RING_MAX_WINDOW_ROWS = 48
RING_MAX_WINDOW_COLS = 80
RING_STATIC_BYTES = 32 * RING_MAX_WINDOW_ROWS \
    + 8 * (RING_MAX_WINDOW_COLS + RING_MAX_WINDOW_ROWS)
#: a tile's 64 columns (two a lane of a warp), and its rows: the most
#: whose ring fits a block at prefetch depth 2 (32 for N <= 4, 16 for
#: N = 5, 6, 8 for N = 7, 4 for N = 8)
RING_TILE_X = 64
RING_TILE_ROWS = (32, 16, 8, 4)
RING_DEPTHS = (2, 3, 4)


class RingPlan(NamedTuple):
    """One launch of the ring kernel: the rows ``ty`` of a block's 64 x
    ty output tile, how many input planes it asks for ahead (``depth``),
    the z planes it walks (``zrun``) and the blocks one SM holds."""
    ty: int
    depth: int
    zrun: int
    blocks_per_sm: int


def ring_margin(steps: int) -> int:
    """Window columns on each side of a tile: N rounded up to 4, so that
    window rows start on 16 bytes when X % 4 == 0."""
    return 4 * -(-steps // 4)


def ring_smem_bytes(steps: int, ty: int, depth: int,
                    itemsize: int = 4) -> int:
    """The ring kernel's dynamic shared memory: depth + 3 input planes
    and 4 planes for each of the N - 1 intermediate levels, of the
    (64 + 2M) x (ty + 2N) window, in cells of the storage dtype
    (``ring_smem_bytes`` in csrc/jacobi_ring.cuh)."""
    slots = depth + 3 + 4 * (steps - 1)
    return itemsize * slots * (RING_TILE_X + 2 * ring_margin(steps)) \
        * (ty + 2 * steps)


def ring_blocks_per_sm(steps: int, ty: int, depth: int,
                       itemsize: int = 4) -> int:
    """Blocks of the ring kernel one SM holds, by shared memory and by
    registers; 0 where one block does not fit. ``ring_occupancy`` reads
    the card's count."""
    need = ring_smem_bytes(steps, ty, depth, itemsize)
    if need + RING_STATIC_BYTES > BLOCK_SMEM_BYTES:
        return 0
    per = need + RING_STATIC_BYTES + BLOCK_RESERVED_BYTES
    return min(SM_REGISTERS // (RING_THREADS * RING_REGISTERS),
               SM_SMEM_BYTES // per)


def ring_tile(steps: int, itemsize: int = 4) -> Tuple[int, int, int]:
    """(ty, depth, blocks per SM) of N steps: the first tile rows of
    ``RING_TILE_ROWS`` that fit at depth 2, then the deepest prefetch
    that keeps as many blocks on an SM, but 3 where several blocks share
    it (six planes or more in flight an SM; depth 4 at N = 2 would leave
    256 bytes of the SM's shared memory)."""
    for ty in RING_TILE_ROWS:
        bps = ring_blocks_per_sm(steps, ty, RING_DEPTHS[0], itemsize)
        if bps:
            depth = max(d for d in RING_DEPTHS
                        if ring_blocks_per_sm(steps, ty, d, itemsize) == bps
                        and (bps == 1 or d <= 3))
            return ty, depth, bps
    raise ValueError(f"no ring tile fits {steps} steps")


def ring_cost(Z: int, Y: int, X: int, steps: int, n_sms: int, ty: int,
              bps: int, zrun: int) -> int:
    """Waves x planes loaded: a wave is ``bps`` blocks on each of the
    ``n_sms`` SMs, and a block of a z run loads zrun + 2N input planes."""
    blocks = -(-X // RING_TILE_X) * -(-Y // ty) * -(-Z // zrun)
    return -(-blocks // (n_sms * bps)) * (zrun + 2 * steps)


@functools.lru_cache(maxsize=None)
def jacobi_ring_plan(Z: int, Y: int, X: int, steps: int, n_sms: int,
                     itemsize: int = 4) -> RingPlan:
    """The ring kernel's launch for N = ``steps`` over a (Z, Y, X) field
    or shard (or output box) on a card of ``n_sms`` SMs, in cells of
    ``itemsize`` bytes: ``ring_tile``'s tile, and the z run that
    minimises ``ring_cost`` (waves x planes loaded), found among the runs
    ceil(Z / k), k = 1..Z: any other run loads more planes for the same
    number of blocks. Ties go to the longer run."""
    if not 1 <= steps <= RING_MAX_STEPS:
        raise ValueError(f"the ring kernel takes 1 <= steps <= "
                         f"{RING_MAX_STEPS} a launch, got {steps}")
    ty, depth, bps = ring_tile(steps, itemsize)
    runs = {-(-Z // k) for k in range(1, Z + 1)}
    zrun = min(runs, key=lambda r: (ring_cost(Z, Y, X, steps, n_sms, ty,
                                              bps, r), -r))
    return RingPlan(ty, depth, zrun, bps)


# ---------------------------------------------------------------------------
# B8's launch plan
# ---------------------------------------------------------------------------
#: B8's ring kernel (csrc/laplace6.cu): threads a block, its tile's rows
#: (16 thread rows of two output rows), the window's pitch (the tile's 64
#: columns, four a thread, and 4 on each side) and the registers the card
#: allots a thread: its ``-Xptxas=-v`` count (125-128) in the card's unit
#: of 8, which the card tests hold the build to
LAPLACE6_THREADS = 256
LAPLACE6_TY = 32
LAPLACE6_PITCH = RING_TILE_X + 8
LAPLACE6_REGISTERS = 128
#: the planes a block asks for ahead, ``kDepth`` in the kernel: on an
#: H100 at 256^3 two beat one, three, five and six and tied four (PERF.md)
LAPLACE6_DEPTH = 2
#: the stencil's radius: window rows on each side of a tile, and the
#: planes a z run loads beyond its own on each side
LAPLACE6_R = 3
#: the rows of a window plane: the tile's and 3 on each side, rounded up
#: to a multiple of the block's 8 warps, which copy a row each at a time
LAPLACE6_WINDOW_ROWS = 8 * -(-(LAPLACE6_TY + 2 * LAPLACE6_R) // 8)
#: B8's dynamic shared memory: a ring of depth + 4 window planes
#: (``kRingBytes`` in csrc/laplace6.cu)
LAPLACE6_SMEM_BYTES = 4 * (LAPLACE6_DEPTH + LAPLACE6_R + 1) \
    * LAPLACE6_PITCH * LAPLACE6_WINDOW_ROWS


class Laplace6Plan(NamedTuple):
    """One launch of B8's ring kernel: the z planes a block walks
    (``zrun``) and the blocks one SM holds."""
    zrun: int
    blocks_per_sm: int


def laplace6_blocks_per_sm() -> int:
    """Blocks of B8's kernel one SM holds, by shared memory and by
    registers. ``laplace6_occupancy`` reads the card's count."""
    return min(SM_REGISTERS // (LAPLACE6_THREADS * LAPLACE6_REGISTERS),
               SM_SMEM_BYTES // (LAPLACE6_SMEM_BYTES + BLOCK_RESERVED_BYTES))


@functools.lru_cache(maxsize=None)
def laplace6_plan(Z: int, Y: int, X: int, n_sms: int) -> Laplace6Plan:
    """B8's launch over a (Z, Y, X) interior on a card of ``n_sms`` SMs:
    the z run that minimises ``ring_cost`` (waves x planes a block
    loads, the ring's model at radius 3) on the 64 x 32 tile, among the
    runs ceil(Z / k), k = 1..Z: any other run loads more planes for the
    same number of blocks. Ties go to the longer run."""
    bps = laplace6_blocks_per_sm()
    runs = {-(-Z // k) for k in range(1, Z + 1)}
    zrun = min(runs, key=lambda r: (ring_cost(
        Z, Y, X, LAPLACE6_R, n_sms, LAPLACE6_TY, bps, r), -r))
    return Laplace6Plan(zrun, bps)


def laplace6_occupancy(device: torch.device) -> int:
    """Blocks of B8's kernel one SM of ``device`` holds, as the CUDA
    runtime counts them (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
    ``laplace6_blocks_per_sm`` models it."""
    return _occupancy("laplace6", "laplace6_blocks_per_sm", device)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ring_occupancy(device: torch.device, steps: int, ty: int,
                   depth: int, itemsize: int = 4) -> int:
    """Blocks of the ring kernel (K2's instantiation for the storage
    dtype of ``itemsize`` bytes) one SM of ``device`` holds at this tile
    and depth, as the CUDA runtime counts them
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
    ``ring_blocks_per_sm`` models it."""
    return _occupancy(_LIB, "jacobi7_ring_blocks_per_sm", device, steps,
                      ty, depth, int(itemsize == 2))


def _occupancy(lib: str, fn_name: str, device: torch.device, *args) -> int:
    """Call a library's ``fn_name(int..., int* blocks_per_sm)`` on
    ``device``; raise on a CUDA error."""
    from . import _build

    fn = getattr(_build.load(lib), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = [_I] * len(args) + [ctypes.POINTER(_I)]
    got = _I(0)
    with torch.cuda.device(device):
        err = fn(*args, ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")
    return got.value


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
_LIB = "jacobi7"
_I = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = {
    "jacobi7_wrap_launch": [_P, _P] + [_I] * 11 + [_P],
    "jacobi7_wrapn_launch": [_P, _P] + [_I] * 15 + [_P],
    "jacobi7_padded_launch": [_P, _P] + [_I] * 9 + [_P],
    "laplace6_launch": [_P, _P] + [_I] * 8 + [ctypes.c_float] * 3
    + [_I, _P],
}


def _launch(fn_name: str, device: torch.device, *args,
            lib_name: str = _LIB) -> None:
    from . import _build

    _build.launch(lib_name, fn_name, _SIGNATURES[fn_name], device, *args)


def _check(t: torch.Tensor, what: str,
           dtypes: Tuple[torch.dtype, ...] = KERNEL_DTYPES) -> None:
    if t.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{what}: the CUDA kernel takes {names}, got "
                        f"{t.dtype}")
    if t.dim() != 3:
        raise ValueError(f"{what}: expected a (Z, Y, X) tensor, got "
                         f"shape {tuple(t.shape)}")


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: tensor on {t.device}, expected cuda "
                         f"(or cpu for the plain twin)")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def _out(t: torch.Tensor, out: Optional[torch.Tensor], shape, what: str
         ) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=t.dtype, device=t.device)
    if (tuple(out.shape) != tuple(shape) or out.dtype != t.dtype
            or out.device != t.device or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be a contiguous {t.dtype} "
                         f"tensor of shape {tuple(shape)} on {t.device}")
    if out.data_ptr() == t.data_ptr():
        raise ValueError(f"{what}: out must not alias the input")
    return out


def _sphere_args(hot_c, cold_c, sph_r):
    return (*map(int, hot_c), *map(int, cold_c), int(sph_r) * int(sph_r))


def is_bf16(t: torch.Tensor) -> int:
    """The launchers' ``is_bf16`` argument for a tensor's dtype."""
    return int(t.dtype == torch.bfloat16)


def jacobi7_wrap_cuda(interior: torch.Tensor, hot_c, cold_c, sph_r: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: one periodic Jacobi step plus spheres on an unpadded (Z, Y,
    X) float32 or bfloat16 field. ``out`` (optional, not aliasing
    ``interior``) receives the result."""
    what = "jacobi7_wrap_cuda"
    _check(interior, what)
    out = _out(interior, out, interior.shape, what)
    if interior.device.type == "cpu":
        return out.copy_(jacobi7_wrap_plain(interior, hot_c, cold_c, sph_r))
    _check_cuda(interior, what)
    Z, Y, X = interior.shape
    _launch("jacobi7_wrap_launch", interior.device, interior.data_ptr(),
            out.data_ptr(), Z, Y, X, *_sphere_args(hot_c, cold_c, sph_r),
            is_bf16(interior))
    LAUNCHES["jacobi7_wrap"] += 1
    return out


def jacobi7_wrapn_cuda(interior: torch.Tensor, hot_c, cold_c, sph_r: int,
                       steps: int = 2,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: ``steps`` fused periodic Jacobi steps (spheres after each) in
    one pass over memory, launched as ``jacobi_ring_plan`` says. Keeps
    the JAX kernel's rules, ``1 <= steps <= tile`` and ``Y % tile ==
    0`` with the dtype's sublane tile, 8 for float32 and 16 for bfloat16
    (see ``sublane_tile_bytes``); 9 to 16 steps are two launches
    (``ring_split``)."""
    what = "jacobi7_wrapn_cuda"
    _check(interior, what)
    N = int(steps)
    Z, Y, X = interior.shape
    tile = sublane_tile(interior.dtype)
    if N < 1 or N > tile:
        raise ValueError(f"wrapN kernel needs 1 <= steps <= {tile}, "
                         f"got steps={N}")
    if Y % tile:
        raise ValueError(f"wrap{N} kernel needs Y % {tile} == 0, got Y={Y}")
    out = _out(interior, out, interior.shape, what)
    if interior.device.type == "cpu":
        return out.copy_(jacobi7_wrapn_plain(interior, hot_c, cold_c, sph_r,
                                             steps=N))
    _check_cuda(interior, what)
    split = ring_split(N)
    src = interior
    for k, n in enumerate(split):
        dst = out if k == len(split) - 1 else torch.empty_like(interior)
        plan = jacobi_ring_plan(Z, Y, X, n, sm_count(interior.device),
                                interior.element_size())
        _launch("jacobi7_wrapn_launch", interior.device, src.data_ptr(),
                dst.data_ptr(), Z, Y, X, *_sphere_args(hot_c, cold_c, sph_r),
                n, *plan[:3], is_bf16(interior))
        src = dst
    LAUNCHES["jacobi7_wrapn"] += 1
    return out


def jacobi7_padded_cuda(padded: torch.Tensor, radius: Radius,
                        interior: Dim3,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: the 7-point average over a halo-padded (Zp, Yp, Xp) float32
    or bfloat16 shard with pads ``radius.pad_lo()`` below; returns the
    (Z, Y, X) interior (the caller imposes sources and writes it back)."""
    what = "jacobi7_padded_cuda"
    _check(padded, what)
    lo = radius.pad_lo()
    Zp, Yp, Xp = padded.shape
    Z, Y, X = interior.z, interior.y, interior.x
    if min(lo) < 1 or lo.z + Z + 1 > Zp or lo.y + Y + 1 > Yp \
            or lo.x + X + 1 > Xp:
        raise ValueError(f"{what}: padded shape {tuple(padded.shape)} "
                         f"with low pads {lo} has no radius-1 ring "
                         f"around a {interior} interior")
    out = _out(padded, out, (Z, Y, X), what)
    if padded.device.type == "cpu":
        return out.copy_(jacobi7_padded_plain(padded, radius, interior))
    _check_cuda(padded, what)
    _launch("jacobi7_padded_launch", padded.device, padded.data_ptr(),
            out.data_ptr(), Z, Y, X, Yp, Xp, lo.z, lo.y, lo.x,
            is_bf16(padded))
    LAUNCHES["jacobi7_padded"] += 1
    return out


def laplace6_cuda(padded: torch.Tensor, radius: Radius, interior: Dim3,
                  inv_ds: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B8: the 6th-order Laplacian over a halo-padded (Zp, Yp, Xp) shard
    with low pads ``radius.pad_lo()`` of at least 3 and a radius-3 ring
    on the high side; returns the (Z, Y, X) interior. A CUDA tensor must
    be float32 and is one launch, as ``laplace6_plan`` says; a CPU
    tensor of any float dtype goes to the twin."""
    what = "laplace6_cuda"
    if padded.dim() != 3 or not padded.is_floating_point():
        raise ValueError(f"{what}: expected a floating (Z, Y, X) tensor, "
                         f"got {padded.dtype} {tuple(padded.shape)}")
    lo = radius.pad_lo()
    Zp, Yp, Xp = padded.shape
    Z, Y, X = interior.z, interior.y, interior.x
    if min(lo) < 3 or lo.z + Z + 3 > Zp or lo.y + Y + 3 > Yp \
            or lo.x + X + 3 > Xp:
        raise ValueError(f"{what}: padded shape {tuple(padded.shape)} "
                         f"with low pads {lo} has no radius-3 ring "
                         f"around a {interior} interior")
    out = _out(padded, out, (Z, Y, X), what)
    if padded.device.type == "cpu":
        return out.copy_(laplace6_plain(padded, radius, interior, inv_ds))
    _check(padded, what, (torch.float32,))
    _check_cuda(padded, what)
    ix2, iy2, iz2 = (float(np.float32(v * v)) for v in inv_ds)
    plan = laplace6_plan(Z, Y, X, sm_count(padded.device))
    _launch("laplace6_launch", padded.device, padded.data_ptr(),
            out.data_ptr(), Z, Y, X, Yp, Xp, lo.z, lo.y, lo.x, ix2, iy2,
            iz2, plan.zrun, lib_name="laplace6")
    LAUNCHES["laplace6"] += 1
    return out
