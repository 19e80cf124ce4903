"""The hand-written overlapped MHD RK3 substep (B13, B14), with plain twins.

PyTorch-port counterpart of ``stencil_tpu/ops/pallas_mhd_overlap.py``:
one RK3 substep (or the fused substeps 0+1) on the interior-resident
(Z, Y, X) shards of an x-unsharded mesh, where every shard sends its
boundary rows of all 8 fields to its neighbours while its interior is
computed, and the exterior shell is recomputed from the landed rows
(``csrc/mhd_overlap.cu``: launch A sends and computes the interior,
launch B the shell; every compute launch is the ring kernel of B9 and
B11, ``csrc/mhd_ring.cuh``).

===  ===============================================  ===========================  ============================
B    TPU kernel                                       wrapper                      plain twin
===  ===============================================  ===========================  ============================
B13  pallas_mhd_overlap.py:67                         ``mhd_substep_overlap_cuda``  ``mhd_substep_overlap_plain``
     ``mhd_substep_overlap_pallas``
B14  pallas_mhd_overlap.py:360                        ``mhd_substep_fixup_cuda``    ``mhd_substep_fixup_plain``
     ``mhd_substep_fixup_pallas``
===  ===============================================  ===========================  ============================

``mhd_substep_overlap`` (JAX :515) composes the two. The module rules
of ``ops/cuda_mhd.py`` hold: CPU shards go to the plain twins; CUDA
shards launch the kernels or raise; float32 or bfloat16 storage on the
card (bfloat16: float32 arithmetic, the pair's scratch f1, w1 and margin
float32, as in ``cuda_mhd``'s B10 and B12). Each wrapper adds one to its
entry in ``LAUNCHES`` per shard and call, however many kernels the call
launches.

What each computes, per shard, with hr = R (or 2R with the pair):

* B13: the new f (and w) at the interior points, ``interior_region``,
  and the landed rows, in the layout of ``exchange_interior_slabs(rz=hr,
  ry=hr, y_z_extended=True)`` (``MhdOverlapRecv.landed``). Its values at
  the other points are unspecified (the JAX kernel leaves clamped-window
  placeholders there). On the card: the sends, then the ring kernel over
  ``interior_plan``'s regions, reading the shard alone — one substep over
  z, y in [R, n - R); with the pair, substep 0 there into the shard's
  scratch f1, w1 (``MhdOverlapRecv.pair_scratch``), then substep 1 over
  z, y in [kT, n - kT) from them.
* B14: the exterior shell (``shell_regions``) from the pre-substep
  shard and the landed rows, through B11's window rule
  (``ops/cuda_mhd.halo_window``), written into B13's outputs in place
  (JAX aliases them). On the card, ``fixup_plan``: one substep, the ring
  kernel over the shell's strips (depth R); the pair, substep 0 over the
  depth-R shell into f1, w1, substep 0 over the R rows around the shard
  (B12's margin kernel), then substep 1 over the depth-kT shell from f1,
  w1 and that margin. The pair's B14 therefore reads what the same
  shard's last B13 pair left in the scratch, and refuses to run unless
  that pass was for the same fields (address and version) and constants.
  B14 after B13 equals B11 (B12 with the pair) on the same shards, point
  for point: bitwise.

Ordering on the card: ``MhdOverlapRecv`` extends
``ops/cuda_overlap.ShardOrdering`` (rules (a) and (b) of B7) with the
receive buffers; the targets of a shard's launch A are its four face
neighbours and its four diagonal (z+-1, y+-1) neighbours, whose ylo/yhi
corner rows it stores directly. The pair's scratch of a shard is
written and read on that shard's stream only.

Across processes (``ranks``) every list over the mesh holds None at the
positions other ranks hold; a rank launches for its own shards only,
its launch A storing into the other ranks' receive buffers through CUDA
IPC (``MhdOverlapRecv.ptrs``), ordered by ``ShardOrdering``'s flags. The
pair's scratch is never written by another shard, so it is not shared.
On CPU shards the twins take the landed rows from
``exchange_interior_slabs``' messages between the ranks.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..geometry import Dim3
from ..parallel.exchange import exchange_interior_slabs
from ..parallel.mesh import mesh_neighbor
from . import cuda_mhd as cm
from .cuda_mhd import R, SLAB_NAMES, Fields
from .cuda_overlap import ShardOrdering

#: launches per wrapper since the last ``reset_launch_counts``, one per
#: shard and call (the pair's too); only a kernel launch counts, never a
#: call that went to the plain twin
LAUNCHES = {"mhd_substep_overlap": 0, "mhd_substep_fixup": 0}

#: the depth of the pair's shell, kT = 8 (``csrc/mhd_common.cuh``, the
#: TPU kernels' tile): with the pair B13 computes z, y in [8, n - 8),
#: the points whose substep-1 rows lie in [R, n - R), and B14 the rest
PAIR_TILE = 8

Slabs = Dict[str, Dict[str, torch.Tensor]]
#: (z0, nz, y0, ny): the points z in [z0, z0 + nz), y in [y0, y0 + ny),
#: every x
Region = Tuple[int, int, int, int]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def halo_rows(pair: bool) -> int:
    """The rows that cross between shards: R, or 2R for the pair."""
    return 2 * R if pair else R


def shell_width(pair: bool) -> int:
    """The depth of the exterior shell B14 computes: R, or
    ``PAIR_TILE`` (8 >= 2R) with the pair."""
    return PAIR_TILE if pair else R


def interior_region(Z: int, Y: int, pair: bool) -> Optional[Region]:
    """The points B13 computes: z in [e, Z - e), y in [e, Y - e) with e =
    ``shell_width(pair)``; None when that is empty."""
    e = shell_width(pair)
    if Z <= 2 * e or Y <= 2 * e:
        return None
    return (e, Z - 2 * e, e, Y - 2 * e)


def shell_regions(Z: int, Y: int, pair: bool) -> List[Region]:
    """The points B14 computes, as disjoint strips that with
    ``interior_region`` cover the shard: z in [0, e) and [max(e, Z - e),
    Z) at every y, then, between them, y in [0, e) and [max(e, Y - e),
    Y), with e = ``shell_width(pair)``."""
    return _strips(Z, Y, shell_width(pair))


def _strips(Z: int, Y: int, e: int) -> List[Region]:
    out = [(0, min(e, Z), 0, Y)]
    zt = max(e, Z - e)
    if zt < Z:
        out.append((zt, Z - zt, 0, Y))
    if Z > 2 * e:
        out.append((e, Z - 2 * e, 0, min(e, Y)))
        yt = max(e, Y - e)
        if yt < Y:
            out.append((e, Z - 2 * e, yt, Y - yt))
    return out


def interior_plan(Z: int, Y: int, X: int, pair: bool, n_sms: int
                  ) -> np.ndarray:
    """B13's ring-kernel launches after its sends, as the launcher's
    (z0, nz, y0, ny, zrun) rows (``ring_zrun`` of each region): one
    substep, ``interior_region`` from the shard; the pair, substep 0 over
    the one-substep interior from the shard, then (where the shard has
    one) substep 1 over the pair's interior, whose rows it reads all lie
    in the first."""
    regions = [interior_region(Z, Y, False)]
    if pair:
        regions.append(interior_region(Z, Y, True))
    return np.asarray([(z0, nz, y0, ny, cm.ring_zrun(nz, ny, X, n_sms))
                       for z0, nz, y0, ny in filter(None, regions)],
                      dtype=np.int32).reshape(-1, 5)


class Strip(NamedTuple):
    """One strip of B14's shell and how its launch walks it."""
    region: Region   # (z0, nz, y0, ny)
    axis: str        # "z" / "y": the axis its blocks walk
    tiles: int       # its tiles of ``RING_TILE_Y`` rows of the broad axis
    #                  (y for a z strip, z for a y strip) per 32 columns


class ShellLaunch(NamedTuple):
    """One launch of B14's shell kernel on a shard: the ints that
    ``mhd_substep_fixup_launch`` copies into the kernel's ShellPlan
    (``csrc/mhd_overlap.cu``; its near strips start at slice 0, a y
    strip's z at e), and the grid's column tiles. Block row b counts the
    near z strip's tiles, the far one's, then the y strips'."""
    zt: int    # first slice of the far z strip
    yt: int    # first slice of the far y strip
    nzs: int   # z strips: 1 or 2
    nys: int   # y strips: 0, 1 or 2
    tz: int    # row tiles of a z strip
    ty: int    # row tiles of a y strip
    e: int     # the shell's depth
    cols: int  # column tiles of 32

    def ints(self) -> np.ndarray:
        return np.asarray(self[:7], dtype=np.int32)

    @property
    def grid(self) -> Tuple[int, int]:
        return self.cols, self.nzs * self.tz + self.nys * self.ty


class FixupPlan(NamedTuple):
    """B14's launches on one (Z, Y, X) shard (``fixup_plan``)."""
    strips: Tuple[Strip, ...]     # the shell B14 writes, as ``shell`` walks it
    launches: int                 # kernel launches a shard
    shell: ShellLaunch            # the launch that writes the strips
    shell0: Optional[ShellLaunch]     # the pair: substep 0, depth R
    margin: Optional[cm.MarginPlan]   # the pair: substep 0 around it

    def ints(self) -> np.ndarray:
        """The launcher's plan: ``shell``'s ints, or with the pair the
        kernel's PairPlan (``shell0``, ``margin``, ``shell``)."""
        if self.shell0 is None:
            return self.shell.ints()
        return np.concatenate([self.shell0.ints(), self.margin.ints(),
                               self.shell.ints()])


#: B14's kernel holds one 512-thread block of 214 KB an SM
#: (``csrc/mhd_ring.cuh`` RingTile, 128 registers a thread); the card's
#: own count is ``fixup_occupancy``
FIXUP_BLOCKS_PER_SM = 1


def _shell_launch(Z: int, Y: int, X: int, e: int
                  ) -> Tuple[Tuple[Strip, ...], ShellLaunch]:
    """The strips of the depth-e shell and the one launch that walks
    them: the z strips in z, the y strips in y, each cut into tiles of
    32 columns by ``RING_TILE_Y`` rows of its broad axis."""
    regions = _strips(Z, Y, e)
    n_z = 2 if max(e, Z - e) < Z else 1   # z strips come first
    zs, ys = regions[:n_z], regions[n_z:]
    tz = -(-Y // cm.RING_TILE_Y)
    ty = -(-(Z - 2 * e) // cm.RING_TILE_Y) if ys else 0
    strips = tuple([Strip(r, "z", tz) for r in zs]
                   + [Strip(r, "y", ty) for r in ys])
    return strips, ShellLaunch(zs[-1][0] if n_z == 2 else Z,
                               ys[-1][2] if len(ys) == 2 else Y, n_z,
                               len(ys), tz, ty, e, -(-X // 32))


def fixup_plan(Z: int, Y: int, X: int, pair: bool) -> FixupPlan:
    """B14's launch plan for one (Z, Y, X) shard: the one source of the
    launcher, the tests and ``chip_smoke.py``; the kernel is given
    ``ints()``. One substep: one launch of the shell kernel over
    ``shell_regions``' strips (depth R). The pair: three launches —
    substep 0 over the depth-R shell into the scratch f1, w1
    (``shell0``), substep 0 over the R rows around the shard
    (``margin``, ``ops/cuda_mhd.margin_plan``), then substep 1 over the
    depth-kT shell (``shell``)."""
    strips, shell = _shell_launch(Z, Y, X, shell_width(pair))
    if not pair:
        return FixupPlan(strips, 1, shell, None, None)
    return FixupPlan(strips, 3, shell, _shell_launch(Z, Y, X, R)[1],
                     cm.margin_plan(Z, Y, X))


def _write_regions(dst: torch.Tensor, src: torch.Tensor,
                   regions: Sequence[Region]) -> None:
    for z0, nz, y0, ny in regions:
        dst[z0:z0 + nz, y0:y0 + ny] = src[z0:z0 + nz, y0:y0 + ny]


# ---------------------------------------------------------------------------
# receive buffers and ordering
# ---------------------------------------------------------------------------
def send_pieces(i: int, counts: Dim3, Z: int, Y: int, hr: int
                ) -> List[Tuple[str, int, Tuple[int, ...]]]:
    """Shard i's eight sends of each field, as (receive buffer name,
    target shard, (nz, ny, sz0, sy0, dz0, dy0, dY)): a box of nz x ny
    rows from the shard at (sz0, sy0) into the target's buffer (dY rows
    per z) at (dz0, dy0). The hr top z rows fill the z+1 neighbour's
    ``zlo``, the bottom ones the z-1 neighbour's ``zhi``; the Z rows of
    the hr last (first) y rows fill the y+1 (y-1) neighbour's ``ylo``
    (``yhi``) at z rows [hr, hr + Z); the four hr x hr yz corners fill the
    diagonal shards' ``ylo``/``yhi`` at z rows [0, hr) (from z+1) or [Z +
    hr, Z + 2hr) (from z-1). On a one-shard axis the neighbour is the
    shard itself."""
    def nb(dz: int, dy: int) -> int:
        j = mesh_neighbor(i, counts, 2, dz) if dz else i
        return mesh_neighbor(j, counts, 1, dy) if dy else j

    top, last = Z - hr, Y - hr
    return [
        ("zlo", nb(1, 0), (hr, Y, top, 0, 0, 0, Y)),
        ("zhi", nb(-1, 0), (hr, Y, 0, 0, 0, 0, Y)),
        ("ylo", nb(0, 1), (Z, hr, 0, last, hr, 0, hr)),
        ("yhi", nb(0, -1), (Z, hr, 0, 0, hr, 0, hr)),
        ("ylo", nb(1, 1), (hr, hr, top, last, 0, 0, hr)),
        ("ylo", nb(-1, 1), (hr, hr, 0, last, Z + hr, 0, hr)),
        ("yhi", nb(1, -1), (hr, hr, top, 0, 0, 0, hr)),
        ("yhi", nb(-1, -1), (hr, hr, 0, 0, Z + hr, 0, hr)),
    ]


class PairScratch:
    """One shard's scratch for the pair on the card, on its device: f1
    and w1 (substep 0 over the shard, (8, Z, Y, X) each), written by
    B13's launch A and B14's launch B, and the margin (substep 0 over the
    R rows around the shard, ``cm.margin_plan``'s (8, floats) buffer),
    written and read by launch B; with the launchers' pointers into
    them. ``holds`` names what f1 and w1 hold substep 0 of: the fields
    (every field's address and version) and the constants of the last
    launch A, None before one."""

    def __init__(self, shape, dtype: torch.dtype,
                 stream: torch.cuda.Stream) -> None:
        Z, Y, X = shape
        n = cm.margin_plan(Z, Y, X).floats
        comp = cm.compute_dtype(dtype)
        # allocated on the shard's stream, the only one that uses them,
        # so that the caching allocator never hands their blocks to
        # another stream while its launches may still run
        with torch.cuda.stream(stream):
            self.f1 = torch.empty((8, Z, Y, X), dtype=comp,
                                  device=stream.device)
            self.w1 = torch.empty_like(self.f1)
            self.margin = torch.empty((8, n), dtype=comp,
                                      device=stream.device)
        self.p_f1 = cm._ptrs(self.f1.unbind(0))
        self.p_w1 = cm._ptrs(self.w1.unbind(0))
        self.p_margin, self.p_slabs1 = cm.margin_ptrs(self.margin, Z, Y, X)
        self.holds: Optional[tuple] = None


def pair_key(fields: Fields, consts: np.ndarray) -> tuple:
    """What a B13 pair pass on ``fields`` with ``consts`` leaves in its
    shard's scratch (``PairScratch.holds``)."""
    from ..models.astaroth import FIELDS

    return (tuple((fields[q].data_ptr(), fields[q]._version)
                  for q in FIELDS), consts.tobytes())


class MhdOverlapRecv(ShardOrdering):
    """The persistent receive buffers of every shard of a mesh, per row
    count hr (R, and 2R for the pair): ``buffers(hr)[i] = {"zlo", "zhi":
    (8, hr, Y, X), "ylo", "yhi": (8, Z + 2hr, hr, X)}`` on shard i's
    device (the 8 fields in FIELDS order) — and, on the card, the
    shards' streams, the events of rules (a) and (b) and, from the first
    pair call on, each shard's ``pair_scratch``. The buffers are
    zeroed here, on the cards' current streams, so that a session's
    ``enter`` orders every shard's stream after the zeroing: zeroed
    later, inside a session, a card's zeroing would race with the stores
    of shards on other cards, which no event orders against it."""

    def __init__(self, shards: Sequence[Optional[torch.Tensor]],
                 counts: Dim3, ranks: Optional[Sequence[int]] = None
                 ) -> None:
        self.counts = Dim3.of(counts)
        if self.counts.x != 1:
            raise ValueError(f"MhdOverlapRecv: x must not be sharded (mesh "
                             f"{tuple(self.counts)})")
        if len(shards) != self.counts.flatten():
            raise ValueError(f"MhdOverlapRecv: {len(shards)} shards for a "
                             f"{tuple(self.counts)} mesh")
        held = next(t for t in shards if t is not None)
        self.shape = tuple(held.shape[-3:])
        self.dtype = held.dtype
        self.devices = [None if t is None else t.device for t in shards]
        Z, Y, _ = self.shape
        n = len(shards)
        self.pieces = {hr: [send_pieces(i, self.counts, Z, Y, hr)
                            for i in range(n)] for hr in (R, 2 * R)}
        super().__init__(self.devices,
                         [[j for _, j, _ in self.pieces[R][i]]
                          for i in range(n)], ranks)
        self._buffers = {hr: self._zeroed_buffers(hr) for hr in (R, 2 * R)}
        #: per row count, the pointer of every position's (8, ...)
        #: receive buffer of each name (another rank's mapped through
        #: CUDA IPC); None on the CPU
        self.ptrs = ({hr: self.share(self._buffers[hr]) for hr in (R, 2 * R)}
                     if self.streams is not None else None)
        self._pair: List[Optional[PairScratch]] = [None] * n
        #: B14's launch arguments per argument set (``_fixup_args``)
        self.fixup_cache: Dict[tuple, tuple] = {}

    def _zeroed_buffers(self, hr: int) -> List[Dict[str, torch.Tensor]]:
        Z, Y, X = self.shape
        shapes = {"zlo": (8, hr, Y, X), "zhi": (8, hr, Y, X),
                  "ylo": (8, Z + 2 * hr, hr, X),
                  "yhi": (8, Z + 2 * hr, hr, X)}
        return [None if d is None else
                {k: torch.zeros(s, dtype=self.dtype, device=d)
                 for k, s in shapes.items()} for d in self.devices]

    def buffers(self, hr: int) -> List[Dict[str, torch.Tensor]]:
        """Every shard's (8, ...) receive buffers of ``hr`` rows."""
        return self._buffers[hr]

    def pair_scratch(self, i: int, make: bool = False
                     ) -> Optional[PairScratch]:
        """Shard i's scratch for the pair on the card (``PairScratch``),
        made at the first pair call (``make``), so that a run without the
        pair never holds it; None before."""
        if self._pair[i] is None and make:
            self._pair[i] = PairScratch(self.shape, self.dtype,
                                        self.streams[i])
        return self._pair[i]

    def landed(self, hr: int) -> List[Slabs]:
        """The landed rows of every shard, per field: ``landed(hr)[i][q] =
        {"zlo", "zhi", "ylo", "yhi"}`` (views of ``buffers(hr)``), what
        ``halo_window`` and B11/B12 read."""
        from ..models.astaroth import FIELDS

        return [None if b is None else
                {q: {k: v[f] for k, v in b.items()}
                 for f, q in enumerate(FIELDS)} for b in self.buffers(hr)]

    def field_ptrs(self, hr: int, j: int, k: str) -> List[int]:
        """The 8 per-field pointers of position j's receive buffer ``k``
        of ``hr`` rows (FIELDS order), this process's or mapped."""
        Z, Y, X = self.shape
        rows = hr * Y * X if k in ("zlo", "zhi") else (Z + 2 * hr) * hr * X
        step = rows * torch.empty((), dtype=self.dtype).element_size()
        base = self.ptrs[hr][j][k]
        return [base + q * step for q in range(8)]


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------
def landed_slabs(shards: Sequence[Optional[Fields]], counts: Dim3, hr: int,
                 ranks: Optional[Sequence[int]] = None
                 ) -> List[Optional[Slabs]]:
    """Every shard's landed rows after every launch A of a substep: the
    slabs of ``exchange_interior_slabs(rz=hr, ry=hr, y_z_extended=True)``
    over the 8 fields, per field (None at the positions other ranks
    hold, ``ranks``)."""
    from ..models.astaroth import FIELDS

    stacked = [None if f is None else torch.stack([f[q] for q in FIELDS])
               for f in shards]
    return [None if sl is None else
            {q: {k: v[f] for k, v in sl.items()} for f, q in
             enumerate(FIELDS)}
            for sl in exchange_interior_slabs(stacked, Dim3.of(counts),
                                              rz=hr, ry=hr,
                                              y_z_extended=True,
                                              ranks=ranks)]


def _own_window_update(fields: Fields, w: Optional[Fields], s: int, prm,
                       dt_phys: float, pair: bool, write_w: bool
                       ) -> Tuple[Fields, Optional[Fields]]:
    """B9's twin (or B10's with the pair) on the shard alone: its values
    at ``interior_region`` read only the shard, on windows of the shape
    and layout B11's (B12's) twin uses, so that every point's operations
    run as they do there."""
    if pair:
        return cm.mhd_substep01_wrap_plain(fields, prm, dt_phys)
    return cm.mhd_substep_wrap_plain(fields, w, s, prm, dt_phys,
                                     write_w=write_w)


def mhd_substep_overlap_plain(fields: Sequence[Fields],
                              w: Optional[Sequence[Fields]], s: int, prm,
                              dt_phys: float, counts: Dim3,
                              pair: bool = False, write_w: bool = True,
                              ranks: Optional[Sequence[int]] = None
                              ) -> Tuple[List[Fields], Optional[List[Fields]],
                                         List[Slabs]]:
    """B13's twin over every shard of the mesh: (new fields, new w or
    None, landed rows). The new fields and w hold B11's (B12's) values at
    ``interior_region`` and zeros elsewhere; the landed rows are
    ``landed_slabs``. ``pair=True``: substeps 0+1 (``s`` and ``w`` are
    not read). ``ranks``: each position's owner on a mesh that spans
    processes (None in every list at the positions other ranks hold)."""
    from ..models.astaroth import FIELDS

    Z, Y, _ = _held(fields)[FIELDS[0]].shape
    inner = interior_region(Z, Y, pair)
    new_f: List[Fields] = []
    new_w: Optional[List[Fields]] = [] if write_w else None
    for i, f in enumerate(fields):
        if f is None:
            new_f.append(None)
            if write_w:
                new_w.append(None)
            continue
        got_f, got_w = _own_window_update(f, None if w is None else w[i], s,
                                          prm, dt_phys, pair, write_w)
        for got, out in ((got_f, new_f), (got_w, new_w)):
            if got is None:
                continue
            z = {q: torch.zeros_like(f[q]) for q in FIELDS}
            for q in FIELDS:
                if inner is not None:
                    _write_regions(z[q], got[q], [inner])
            out.append(z)
    return new_f, new_w, landed_slabs(fields, counts, halo_rows(pair), ranks)


def _held(fields: Sequence[Optional[Fields]]) -> Fields:
    """The first shard's fields this process holds."""
    return next(f for f in fields if f is not None)


def mhd_substep_fixup_plain(fields: Sequence[Fields],
                            w: Optional[Sequence[Fields]],
                            f_partial: Sequence[Fields],
                            w_partial: Optional[Sequence[Fields]],
                            slabs: Sequence[Slabs], s: int, prm,
                            dt_phys: float, pair: bool = False
                            ) -> Tuple[List[Fields], Optional[List[Fields]]]:
    """B14's twin: per shard, ``f_partial`` (and ``w_partial``) with the
    exterior shell (``shell_regions``) replaced by B11's twin (B12's with
    the pair) on the pre-substep ``fields``/``w`` and the landed rows
    ``slabs``; new tensors. ``w_partial=None`` (write_w=False) returns
    None for w."""
    from ..models.astaroth import FIELDS

    Z, Y, _ = _held(fields)[FIELDS[0]].shape
    shell = shell_regions(Z, Y, pair)
    write_w = w_partial is not None
    out_f: List[Fields] = []
    out_w: Optional[List[Fields]] = [] if write_w else None
    for i, f in enumerate(fields):
        if f is None:
            out_f.append(None)
            if write_w:
                out_w.append(None)
            continue
        if pair:
            full_f, full_w = cm.mhd_substep01_halo_plain(f, slabs[i], prm,
                                                         dt_phys)
        else:
            full_f, full_w = cm.mhd_substep_halo_plain(
                f, None if w is None else w[i], slabs[i], s, prm, dt_phys,
                write_w=write_w)
        nf = {q: f_partial[i][q].clone() for q in FIELDS}
        for q in FIELDS:
            _write_regions(nf[q], full_f[q], shell)
        out_f.append(nf)
        if write_w:
            nw = {q: w_partial[i][q].clone() for q in FIELDS}
            for q in FIELDS:
                _write_regions(nw[q], full_w[q], shell)
            out_w.append(nw)
    return out_f, out_w


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
_LIB = "mhd_overlap"
_I = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = {
    # (fields[8], w[8] or NULL, dst[64], pieces[56], out_f[8], out_w[8] or
    #  NULL, f1[8] and w1[8] (the pair) or NULL, regions
    #  (``interior_plan``), n_regions, Z, Y, X, pair, consts, n_consts,
    #  stream)
    "mhd_substep_overlap_launch": [_P] * 9 + [_I] * 5 + [_P, _I, _I, _P],
    # (fields[8], w[8] or NULL, slabs[32], f1[8], w1[8], margin[8] and
    #  slabs1[32] (the pair) or NULL, out_f[8], out_w[8] or NULL, plan
    #  (``FixupPlan.ints``), n_plan, n_margin, Z, Y, X, rz, ry, pair,
    #  consts, n_consts, is_bf16, stream)
    "mhd_substep_fixup_launch": [_P] * 10 + [_I] * 8 + [_P, _I, _I, _P],
}


def fixup_occupancy(device: torch.device) -> int:
    """Blocks of B14's one-substep kernel one SM of ``device`` holds, as
    the CUDA runtime counts them
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), to hold against
    ``FIXUP_BLOCKS_PER_SM``."""
    from . import _build

    fn = _build.load(_LIB).mhd_fixup_blocks_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_I)]
    got = _I(0)
    with torch.cuda.device(device):
        err = fn(ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"mhd_fixup_blocks_per_sm failed: CUDA error "
                           f"{err}")
    return got.value


def _check_mesh(fields: Sequence[Fields], w, counts: Dim3, what: str):
    counts = Dim3.of(counts)
    if counts.x != 1:
        raise ValueError(f"{what}: x must not be sharded (mesh "
                         f"{tuple(counts)})")
    if len(fields) != counts.flatten():
        raise ValueError(f"{what}: {len(fields)} shards for a "
                         f"{tuple(counts)} mesh")
    if w is not None and len(w) != len(fields):
        raise ValueError(f"{what}: {len(w)} w for {len(fields)} shards")
    f0 = None
    for i, f in enumerate(fields):
        if f is None:
            continue
        g = cm._check_fields(f, None if w is None else w[i], what)
        if f0 is not None and (g.shape != f0.shape or g.dtype != f0.dtype):
            raise ValueError(f"{what}: shards of {tuple(f0.shape)} "
                             f"{f0.dtype} and {tuple(g.shape)} {g.dtype}")
        f0 = f0 if f0 is not None else g
    devs = {f[next(iter(f))].device.type for f in fields if f is not None}
    if len(devs) != 1:
        raise ValueError(f"{what}: shards on CPU and CUDA devices at once")
    return counts, f0


def _check_w_args(w, s: int, pair: bool, write_w: bool, what: str) -> None:
    from ..models.astaroth import RK3_ALPHA

    if pair:
        if w is not None:
            raise ValueError(f"{what}: the pair reads no w (alpha_0 == 0)")
        if not write_w:
            raise ValueError(f"{what}: the pair always writes w")
    elif w is None and float(RK3_ALPHA[s]) != 0.0:
        raise ValueError(f"{what}: w=None is only valid when alpha_s == 0 "
                         f"(substep {s} has alpha {RK3_ALPHA[s]})")


def _recv_for(recv: Optional[MhdOverlapRecv], fields: Sequence[Fields],
              counts: Dim3, what: str,
              ranks: Optional[Sequence[int]] = None) -> MhdOverlapRecv:
    from ..models.astaroth import FIELDS

    f0 = _held(fields)[FIELDS[0]]
    if recv is None:
        return MhdOverlapRecv([None if f is None else f[FIELDS[0]]
                               for f in fields], counts, ranks)
    if (recv.counts != counts or recv.shape != tuple(f0.shape)
            or recv.dtype != f0.dtype
            or recv.devices != [None if f is None else f[FIELDS[0]].device
                                for f in fields]):
        raise ValueError(f"{what}: recv was made for another mesh")
    return recv


def _launch_ptrs(group: Optional[Fields]):
    from ..models.astaroth import FIELDS

    return None if group is None else cm._ptrs([group[q] for q in FIELDS])


def mhd_substep_overlap_cuda(fields: Sequence[Fields],
                             w: Optional[Sequence[Fields]], s: int, prm,
                             dt_phys: float, counts: Dim3,
                             pair: bool = False, write_w: bool = True,
                             out_f: Optional[Sequence[Fields]] = None,
                             out_w: Optional[Sequence[Fields]] = None,
                             recv: Optional[MhdOverlapRecv] = None,
                             ranks: Optional[Sequence[int]] = None
                             ) -> Tuple[List[Fields], Optional[List[Fields]],
                                        MhdOverlapRecv]:
    """B13 (launch A) on every shard of an x-unsharded mesh
    (``fields[i]``: the 8 (Z, Y, X) fields of mesh position i, x
    fastest): RK3 substep ``s`` at ``interior_region`` into ``out_f``/
    ``out_w`` (made if None; they must not alias the inputs), and the
    boundary rows of all 8 fields stored into the neighbours' receive
    buffers ``recv.buffers(hr)`` (``recv``: the mesh's persistent
    ``MhdOverlapRecv``, made if None). Dead-w elision as in B11 (``w=None``
    only where alpha_s == 0; ``write_w=False``); ``pair=True`` runs
    substeps 0+1 (``w`` None, w written). Returns (out_f, out_w or None,
    recv); on the card the landed rows are complete once every shard's
    launch A has run (rule (b) orders B14 after them). On a mesh that
    spans processes (``ranks``, or ``recv.ranks``) every list holds None
    at the positions other ranks hold."""
    from ..models.astaroth import FIELDS

    what = "mhd_substep_overlap_cuda"
    _check_w_args(w, s, pair, write_w, what)
    if not write_w and out_w is not None:
        raise ValueError(f"{what}: out_w given with write_w=False")
    counts, f0 = _check_mesh(fields, w, counts, what)
    recv = _recv_for(recv, fields, counts, what, ranks)
    hr = halo_rows(pair)
    own = recv.local

    def outs(given):
        return [None if f is None else
                cm._outputs(f[FIELDS[0]], None if given is None else given[i],
                            what) for i, f in enumerate(fields)]

    out_f = outs(out_f)
    out_w = outs(out_w) if write_w else None
    if f0.device.type == "cpu":
        nf, nw, slabs = mhd_substep_overlap_plain(fields, w, s, prm, dt_phys,
                                                  counts, pair=pair,
                                                  write_w=write_w,
                                                  ranks=recv.ranks)
        landed = recv.landed(hr)
        for i in own:
            for q in FIELDS:
                out_f[i][q].copy_(nf[i][q])
                if write_w:
                    out_w[i][q].copy_(nw[i][q])
                for k in SLAB_NAMES:
                    landed[i][q][k].copy_(slabs[i][q][k])
        return out_f, out_w, recv
    for i in own:
        f = fields[i]
        ts = ([f[q] for q in FIELDS] + list(out_f[i].values())
              + ([w[i][q] for q in FIELDS] if w is not None else [])
              + (list(out_w[i].values()) if write_w else []))
        cm._check_cuda(f0, ts, what)
        if any(out_f[i][q].data_ptr() == f[q].data_ptr() for q in FIELDS):
            raise ValueError(f"{what}: out_f aliases the fields")
    Z, Y, X = f0.shape
    consts = cm.kernel_consts(prm, dt_phys, s)
    regions = interior_plan(Z, Y, X, pair, cm.sm_count(f0.device))
    from . import _build

    with recv.own_session():
        recv.begin_a()
        for i in own:
            f = fields[i]
            pieces = recv.pieces[hr][i]
            dst = (ctypes.c_void_p * 64)(*[p for k, j, _ in pieces
                                           for p in recv.field_ptrs(hr, j, k)])
            geo = np.asarray([g for _, _, g in pieces], dtype=np.int32)
            p_in, p_f = _launch_ptrs(f), _launch_ptrs(out_f[i])
            p_w = _launch_ptrs(None if w is None else w[i])
            p_wo = _launch_ptrs(out_w[i] if write_w else None)
            sc = recv.pair_scratch(i, make=True) if pair else None
            if sc is not None:
                sc.holds = None
            with recv.launch_a(i):
                _build.launch(_LIB, "mhd_substep_overlap_launch",
                              _SIGNATURES["mhd_substep_overlap_launch"],
                              f[FIELDS[0]].device,
                              p_in, p_w, dst, geo.ctypes.data, p_f, p_wo,
                              None if sc is None else sc.p_f1,
                              None if sc is None else sc.p_w1,
                              regions.ctypes.data, len(regions), Z, Y, X,
                              int(pair), consts.ctypes.data, consts.size,
                              cm.is_bf16(f0))
            if sc is not None:
                sc.holds = pair_key(f, consts)
    LAUNCHES["mhd_substep_overlap"] += len(own)
    return out_f, out_w, recv


def mhd_substep_fixup_cuda(fields: Sequence[Fields],
                           w: Optional[Sequence[Fields]],
                           f_partial: Sequence[Fields],
                           w_partial: Optional[Sequence[Fields]], s: int,
                           prm, dt_phys: float, counts: Dim3,
                           recv: MhdOverlapRecv, pair: bool = False
                           ) -> Tuple[List[Fields], Optional[List[Fields]]]:
    """B14 (launch B) on every shard: the exterior shell
    (``shell_regions``) of substep ``s`` from the pre-substep ``fields``/
    ``w`` and the landed rows in ``recv.buffers(hr)``, written into B13's
    outputs ``f_partial``/``w_partial`` IN PLACE (JAX aliases them;
    ``w_partial=None`` is write_w=False). ``pair`` as for B13. On the
    card, ``fixup_plan``: with one substep one launch of the ring kernel a
    shard, reading the shard and the landed rows itself; with the pair
    three (substep 0 over the depth-R shell, the margin, substep 1 over
    the depth-kT shell), which complete the substep 0 that the shard's
    last B13 pair left in ``recv.pair_scratch``: ``ValueError`` unless
    that pass was on these ``fields`` (the same tensors, unwritten
    since) with these constants. B14 may run again on the same state.
    The launch arguments are built once per argument set
    (``_fixup_args``). Returns (f_partial, w_partial)."""
    from ..models.astaroth import FIELDS

    what = "mhd_substep_fixup_cuda"
    write_w = w_partial is not None
    _check_w_args(w, s, pair, write_w, what)
    counts, f0 = _check_mesh(fields, w, counts, what)
    recv = _recv_for(recv, fields, counts, what)
    hr = halo_rows(pair)
    own = recv.local
    f_partial = [None if f is None else cm._outputs(f[FIELDS[0]], fp, what)
                 for f, fp in zip(fields, f_partial)]
    if write_w:
        w_partial = [None if f is None else
                     cm._outputs(f[FIELDS[0]], wp, what)
                     for f, wp in zip(fields, w_partial)]
    if f0.device.type == "cpu":
        nf, nw = mhd_substep_fixup_plain(fields, w, f_partial, w_partial,
                                         recv.landed(hr), s, prm, dt_phys,
                                         pair=pair)
        for i in own:
            for q in FIELDS:
                f_partial[i][q].copy_(nf[i][q])
                if write_w:
                    w_partial[i][q].copy_(nw[i][q])
        return f_partial, w_partial
    for i in own:
        f = fields[i]
        ts = ([f[q] for q in FIELDS] + list(f_partial[i].values())
              + ([w[i][q] for q in FIELDS] if w is not None else [])
              + (list(w_partial[i].values()) if write_w else []))
        cm._check_cuda(f0, ts, what)
    consts = cm.kernel_consts(prm, dt_phys, s)
    if pair:
        for i in own:
            f = fields[i]
            sc = recv.pair_scratch(i)
            if sc is None or sc.holds != pair_key(f, consts):
                raise ValueError(
                    f"{what}: shard {i}'s scratch does not hold substep 0 of "
                    f"these fields with these constants; run "
                    f"mhd_substep_overlap_cuda(pair=True) on them first")
    args = _fixup_args(recv, fields, w, f_partial, w_partial, consts, pair)
    from . import _build

    sig = _SIGNATURES["mhd_substep_fixup_launch"]
    with recv.own_session():
        recv.begin_b()
        for j, a in zip(own, args):
            with recv.launch_b(j):
                _build.launch(_LIB, "mhd_substep_fixup_launch", sig,
                              recv.devices[j], *a)
    LAUNCHES["mhd_substep_fixup"] += len(own)
    return f_partial, w_partial


#: argument sets ``_fixup_args`` keeps per ``MhdOverlapRecv``: an
#: Astaroth iteration's 3 substeps, each from either buffer of its
#: ping-pong pair (the pair: 2 launches an iteration, so 4)
FIXUP_CACHE_SETS = 6


def _fixup_args(recv: MhdOverlapRecv, fields: Sequence[Fields],
                w: Optional[Sequence[Fields]], f_partial: Sequence[Fields],
                w_partial: Optional[Sequence[Fields]], consts: np.ndarray,
                pair: bool) -> List[tuple]:
    """B14's launcher arguments per shard of this process (after the
    device; in ``recv.local`` order), built once
    per argument set and kept in ``recv.fixup_cache`` (at most
    ``FIXUP_CACHE_SETS``, then it starts anew): the pointer arrays (with
    the pair, the shard's scratch), the plan's ints
    (``FixupPlan.ints``) and ``consts`` (``kernel_consts``). The key is
    the constants and
    every tensor's address (128 ``data_ptr`` reads on four shards, a few
    microseconds); the wrapper has checked the tensors' shapes, dtypes
    and layout before, so equal addresses are equal arguments."""
    from ..models.astaroth import FIELDS

    groups = (fields, w, f_partial, w_partial)
    key = (pair, consts.tobytes()) + tuple(
        None if g is None else tuple(g[i][q].data_ptr() for q in FIELDS)
        for i in recv.local for g in groups)
    got = recv.fixup_cache.get(key)
    if got is not None:
        return got[0]
    if len(recv.fixup_cache) >= FIXUP_CACHE_SETS:
        recv.fixup_cache.clear()
    Z, Y, X = recv.shape
    hr = halo_rows(pair)
    plan = fixup_plan(Z, Y, X, pair)
    table = plan.ints()
    n_margin = plan.margin.floats if pair else 0
    landed = recv.landed(hr)
    args = []
    for j in recv.local:
        f = fields[j]
        sc = recv.pair_scratch(j) if pair else None
        scratch = ((None,) * 4 if sc is None else
                   (sc.p_f1, sc.p_w1, sc.p_margin, sc.p_slabs1))
        args.append((
            _launch_ptrs(f), _launch_ptrs(None if w is None else w[j]),
            cm._ptrs(cm._slab_list(landed[j])), *scratch,
            _launch_ptrs(f_partial[j]),
            _launch_ptrs(None if w_partial is None else w_partial[j]),
            table.ctypes.data, table.size, n_margin, Z, Y, X, hr, hr,
            int(pair), consts.ctypes.data, consts.size,
            int(recv.dtype == torch.bfloat16)))
    # the entry keeps the arrays that the pointers point into alive
    recv.fixup_cache[key] = (args, table, consts)
    return args


def mhd_substep_overlap(fields: Sequence[Fields],
                        w: Optional[Sequence[Fields]], s: int, prm,
                        dt_phys: float, counts: Dim3, pair: bool = False,
                        write_w: bool = True,
                        out_f: Optional[Sequence[Fields]] = None,
                        out_w: Optional[Sequence[Fields]] = None,
                        recv: Optional[MhdOverlapRecv] = None
                        ) -> Tuple[List[Fields], Optional[List[Fields]],
                                   MhdOverlapRecv]:
    """One full overlapped substep on every shard (JAX :515): B13, then
    B14 on B13's outputs. Equals a slab round (``exchange_interior_slabs``
    with hr rows) and B11 (B12 with the pair) on every shard, bitwise.
    Returns (new fields, new w or None, recv)."""
    f1, w1, recv = mhd_substep_overlap_cuda(fields, w, s, prm, dt_phys,
                                            counts, pair=pair,
                                            write_w=write_w, out_f=out_f,
                                            out_w=out_w, recv=recv)
    f1, w1 = mhd_substep_fixup_cuda(fields, w, f1, w1, s, prm, dt_phys,
                                    counts, recv, pair=pair)
    return f1, w1, recv
