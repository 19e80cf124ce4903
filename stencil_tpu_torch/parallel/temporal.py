"""Communication-avoiding temporal blocking: one deep exchange feeds
``s`` stencil steps.

PyTorch-port counterpart of ``stencil_tpu/parallel/temporal.py``. One
exchange ships a depth-``s*r`` halo (``geometry.Radius.deepened``), then
``s`` stencil applications run locally on a *shrinking valid region*:
each sub-step consumes one base-radius ring, so sub-step ``k`` computes
the window ``interior + (s-1-k)*r`` and the last sub-step lands exactly
on the interior. Halo-ring cells are recomputed redundantly — the same
values their owner shard computes —, so ``s``-blocked stepping is
numerically identical to step-by-step stepping, with ``s`` times fewer
exchange rounds for a thin ring of redundant compute and deeper slabs
(the reference exchanges one radius every step,
src/stencil.cu:1002-1186).

Geometry (per axis, padded tensor coordinates; ``p = alloc_steps * r``
pads)::

    [0 ......... p | interior capacity C | p ......... alloc)
    sub-step k window:  [p - m*r_lo,  p + C + m*r_hi),  m = s-1-k

Uneven (+-1 remainder) shards keep STATIC capacity-based windows: a
short shard's window reads at most one slack row of garbage at the top,
which only ever reaches cells *beyond* the validity the next sub-step
needs (the induction that makes the base exchange's dead-row placement
sound).

The JAX engine runs one traced shard inside ``shard_map``; the port
holds the list of shards of a mesh (``parallel/mesh.py``) and runs each
sub-step over every shard in turn. A sub-step reads only its own
shard's padded tensor, so the order of the shards does not matter; the
exchanges (the deep one, and the mid-group refreshes of per-axis
depths) fill every shard's halos IN PLACE between sub-steps
(``parallel/exchange.py`` ``dispatch_exchange``).

Overlap composition: with ``overlap=True`` sub-step 0 splits into the
deep-interior block, which reads only points its shard owns and is
queued between the exchange's start and its ``wait`` (the
``parallel/overlap.py`` split at temporal depth), plus thin shells of
thickness ``s*r`` computed from the exchanged fields.

The deep exchange and the mid-group refreshes carry the halo wire
format and layout (``wire_format``, ``wire_layout``) to the engine;
asymmetric depths decline the irredundant layout, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..geometry import DepthsLike, Dim3, Radius, normalize_depths
from .exchange import dispatch_exchange, start_dispatch_exchange
from .packing import normalize_wire_layout

ZERO = Dim3(0, 0, 0)

# a temporal update function: (padded blocks per field, window interior
# dims, window offset (x, y, z) in shard-interior coordinates — negative
# for halo-ring cells recomputed redundantly —, the sub-step index k, and
# the shard's linear mesh position i) -> dict of window-shaped outputs
# for the fields it advances. The callee owns per-sub-step sources and
# boundary values: ring cells must receive exactly what their owner
# shard computes (periodic: wrap global coordinates; Boundary.NONE: zero
# outside the domain).
TemporalUpdateFn = Callable[[Dict[str, torch.Tensor], Dim3,
                             Tuple[int, int, int], int, int],
                            Dict[str, torch.Tensor]]


def validate_temporal(radius: Radius, local: Dim3, steps: DepthsLike,
                      rem: Dim3 = ZERO) -> None:
    """Feasibility of ``steps``-deep blocking on ``local``-capacity
    shards: every shard's ACTUAL interior must supply the deep slab the
    exchange ships from it (``s_a * r`` rows per side, per axis)."""
    depths = normalize_depths(steps)
    for a in range(3):
        min_interior = local[a] - (1 if rem[a] else 0)
        need = depths[a] * max(radius.face(a, -1), radius.face(a, 1))
        if need and min_interior < need:
            raise ValueError(
                f"temporal blocking depth {depths[a]} needs interior >= "
                f"{need} along axis {'xyz'[a]}, but the smallest shard "
                f"has {min_interior} (grow the grid or lower "
                f"exchange_every)")


def sub_step_windows(radius: Radius, capacity: Dim3, steps: DepthsLike
                     ) -> List[Tuple[Dim3, Dim3]]:
    """The shrinking-window schedule in shard-interior coordinates: for
    each sub-step ``k`` the (offset, dims) of the region it computes —
    offset components ``-m_a * r_lo``, dims ``capacity + m_a * (r_lo +
    r_hi)`` with the per-axis extension ``m_a(k) = s_a - 1 - (k mod
    s_a)``. With uniform depths ``m = s - 1 - k``; sub-step ``max(s) -
    1`` lands exactly on ``((0,0,0), capacity)``. Per-axis depths
    saw-tooth: each axis's window re-extends right after its own
    mid-group exchange refreshes it."""
    depths = normalize_depths(steps)
    out = []
    lo, hi = radius.pad_lo(), radius.pad_hi()
    for k in range(max(depths)):
        m = Dim3(depths.x - 1 - (k % depths.x),
                 depths.y - 1 - (k % depths.y),
                 depths.z - 1 - (k % depths.z))
        off = Dim3(-m.x * lo.x, -m.y * lo.y, -m.z * lo.z)
        dims = Dim3(capacity.x + m.x * (lo.x + hi.x),
                    capacity.y + m.y * (lo.y + hi.y),
                    capacity.z + m.z * (lo.z + hi.z))
        out.append((off, dims))
    return out


def refresh_axes(depths: DepthsLike, k: int) -> List[int]:
    """The axes whose halo an asymmetric group exchanges at sub-step
    ``k``: axis ``a`` when ``k % s_a == 0`` (sub-step 0 is the full
    multi-axis exchange; shallow axes re-exchange mid-group while deep
    axes coast on their ring). Uniform depths refresh every axis at
    ``k == 0`` only."""
    depths = normalize_depths(depths)
    return [a for a in range(3) if k % depths[a] == 0]


def _axes_wire_radius(radius: Radius, depths: Dim3,
                      axes: Sequence[int]) -> Radius:
    """Wire radius for a mid-group refresh of ``axes`` only: those axes'
    faces deepen to ``s_a * r``, every other direction is zero, so the
    sweep engine skips the coasting axes entirely."""
    out = Radius.constant(0)
    for a in axes:
        for side in (-1, 1):
            d = [0, 0, 0]
            d[a] = side
            out.set_dir(tuple(d), depths[a] * radius.face(a, side))
    return out


def _region_blocks(fields: Dict[str, torch.Tensor], p_lo: Dim3,
                   r_lo: Dim3, r_hi: Dim3, off: Dim3, dims: Dim3
                   ) -> Dict[str, torch.Tensor]:
    """Every field's stencil-read block (a view) for the region at
    interior coordinates ``off``: padded coordinates ``[p_lo + off -
    r_lo, p_lo + off + dims + r_hi)``."""
    z0 = p_lo.z + off.z - r_lo.z
    y0 = p_lo.y + off.y - r_lo.y
    x0 = p_lo.x + off.x - r_lo.x
    return {q: p[z0:z0 + r_lo.z + dims.z + r_hi.z,
                 y0:y0 + r_lo.y + dims.y + r_hi.y,
                 x0:x0 + r_lo.x + dims.x + r_hi.x]
            for q, p in fields.items()}


def _write_region(fields: Dict[str, torch.Tensor], p_lo: Dim3, off: Dim3,
                  outs: Dict[str, torch.Tensor]) -> None:
    """Write window-shaped outputs at interior coordinates ``off``, in
    place."""
    for q, val in outs.items():
        Z, Y, X = val.shape
        z0, y0, x0 = p_lo.z + off.z, p_lo.y + off.y, p_lo.x + off.x
        fields[q][z0:z0 + Z, y0:y0 + Y, x0:x0 + X].copy_(val)


def temporal_shard_steps(fields: Dict[str, List[torch.Tensor]],
                         radius: Radius, mesh_counts: Dim3, method,
                         update_fn: TemporalUpdateFn, steps: DepthsLike,
                         alloc_steps: Optional[DepthsLike] = None,
                         rem: Dim3 = ZERO,
                         overlap: bool = False,
                         nonperiodic: bool = False,
                         wire_format=None,
                         wire_layout=None
                         ) -> Dict[str, List[torch.Tensor]]:
    """One ``steps``-deep blocked group on every shard of a mesh: a
    single depth-``steps*r`` exchange, then ``steps`` applications of
    ``update_fn`` on the shrinking windows, IN PLACE; returns
    ``fields``.

    ``fields[q]``: the padded (z,y,x) shards of quantity q (x fastest),
    allocation pads ``alloc_steps * r`` per side (``alloc_steps``
    defaults to ``steps``; a larger allocation lets tail groups of
    smaller depth run on the same buffers — the exchange then places
    ``steps*r`` slabs immediately around the interior).
    ``overlap``: split sub-step 0 into the pre-exchange deep-interior
    block plus post-exchange shells (even shards only).
    ``wire_format``/``wire_layout``: the halo wire format and layout
    of every exchange of the group (``parallel/exchange.py``).

    Per-axis ``steps`` (e.g. ``{"z": 4, "y": 1, "x": 1}``): the group
    runs ``max(steps)`` sub-steps; axis ``a`` is exchanged at depth
    ``s_a * r`` on every sub-step ``k`` with ``k % s_a == 0``
    (``refresh_axes``), and each axis's window saw-tooths with its own
    ``m_a(k)``. Non-uniform depths decline ``overlap`` and the
    ``"irredundant"`` wire layout, which both assume one group-wide
    exchange."""
    depths = normalize_depths(steps)
    alloc_d = depths if alloc_steps is None else normalize_depths(alloc_steps)
    if any(not 1 <= depths[a] <= alloc_d[a] for a in range(3)):
        raise ValueError(f"steps={depths} outside [1, {alloc_d}]")
    steps = max(depths)
    uniform = depths.x == depths.y == depths.z
    if overlap and rem != ZERO:
        raise NotImplementedError(
            "overlap composition requires evenly divisible shards")
    if not uniform and overlap:
        raise NotImplementedError(
            f"asymmetric temporal depths {tuple(depths)} decline the "
            f"overlap composition: the sub-step-0 shell split assumes one "
            f"group-wide exchange, not mid-group refreshes")
    if not uniform and normalize_wire_layout(wire_layout) != "slab":
        raise NotImplementedError(
            f"asymmetric temporal depths {tuple(depths)} decline "
            f"wire_layout {wire_layout!r}: the irredundant dedup plan "
            f"assumes one group-wide exchange whose slabs carry the "
            f"halo-of-halo rows mid-group refreshes rely on")
    wire = radius.deepened(depths)
    alloc_r = radius.deepened(alloc_d)
    p_lo, p_hi = alloc_r.pad_lo(), alloc_r.pad_hi()
    r_lo, r_hi = radius.pad_lo(), radius.pad_hi()
    names = list(fields)
    n = len(fields[names[0]])
    any_p = fields[names[0]][0]
    cap = Dim3(any_p.shape[2] - p_lo.x - p_hi.x,
               any_p.shape[1] - p_lo.y - p_hi.y,
               any_p.shape[0] - p_lo.z - p_hi.z)
    validate_temporal(radius, cap, depths, rem)

    shards = [{q: fields[q][i] for q in names} for i in range(n)]
    landed = start_dispatch_exchange(fields, wire,
                                     mesh_counts, method, rem=rem,
                                     alloc_radius=alloc_r,
                                     nonperiodic=nonperiodic,
                                     wire_format=wire_format,
                                     wire_layout=wire_layout)

    windows = sub_step_windows(radius, cap, depths)
    k0 = 0
    inner_dims = cap - r_lo - r_hi
    if overlap and not inner_dims.any_lt(1):
        # sub-step 0 as inner + shells: the inner block reads only
        # points its shard owns, which the exchange never writes, so it
        # is queued while the deep exchange runs
        w_off, w_dims = windows[0]
        inner = (Dim3(r_lo.x, r_lo.y, r_lo.z), inner_dims)
        shells = []
        for a in range(3):
            for side in (-1, 1):
                t = steps * radius.face(a, side)
                if t == 0:
                    continue
                off = [w_off.x, w_off.y, w_off.z]
                dims = [w_dims.x, w_dims.y, w_dims.z]
                if side == 1:
                    off[a] = cap[a] - r_hi[a]
                dims[a] = t
                shells.append((Dim3(*off), Dim3(*dims)))
        pieces: List[List] = [[] for _ in range(n)]
        for i, shard in enumerate(shards):
            off, dims = inner
            pieces[i].append((off, update_fn(
                _region_blocks(shard, p_lo, r_lo, r_hi, off, dims), dims,
                (off.x, off.y, off.z), 0, i)))
        landed.wait()
        for i, shard in enumerate(shards):
            for off, dims in shells:
                pieces[i].append((off, update_fn(
                    _region_blocks(shard, p_lo, r_lo, r_hi, off, dims),
                    dims, (off.x, off.y, off.z), 0, i)))
        for i, shard in enumerate(shards):
            for off, outs in pieces[i]:
                _write_region(shard, p_lo, off, outs)
        k0 = 1
    else:
        landed.wait()

    for k in range(k0, steps):
        if k > 0 and not uniform:
            # mid-group refresh: the shallow axes re-exchange at their
            # own depth while deep axes coast on their remaining ring
            axes = [a for a in refresh_axes(depths, k)
                    if radius.wire_rows(a)]
            if axes:
                dispatch_exchange(fields,
                                  _axes_wire_radius(radius, depths, axes),
                                  mesh_counts, method, rem=rem,
                                  alloc_radius=alloc_r,
                                  nonperiodic=nonperiodic,
                                  wire_format=wire_format,
                                  wire_layout=wire_layout)
        off, dims = windows[k]
        for i, shard in enumerate(shards):
            outs = update_fn(_region_blocks(shard, p_lo, r_lo, r_hi, off,
                                            dims),
                             dims, (off.x, off.y, off.z), k, i)
            _write_region(shard, p_lo, off, outs)
    return fields
