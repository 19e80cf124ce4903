"""Canonical irredundant halo wire layout: send every cell ONCE.

PyTorch-port counterpart of ``stencil_tpu/parallel/packing.py``: the
planner is pure Python and is kept here as a copy, so that the port
imports nothing of the JAX package. The port's engine
(``parallel/exchange.py``) holds every shard of the mesh, so where the
JAX engine adds the traced ``shard_interior_len`` to a ``plus_L`` span,
the port adds each shard's own interior length at its mesh position.

The slab layout (``wire_layout="slab"``, the default and the reference
library's shape — src/packer.cu ships full padded cross-sections) puts
each per-axis message over the FULL allocation of the other dims.  That
is simple and makes the sequential-sweep corner rule automatic, but it
re-sends redundantly: the pending axes' halo rows in a slab are stale
at ship time (the later sweep overwrites them anyway), and when the
allocation is padded deeper than the wire (temporal blocking,
``alloc_radius``) the slab drags the whole s-deep pad cross-section
along for a 1-deep refresh.

This module plans the IRREDUNDANT layout (``wire_layout="irredundant"``
— TEMPI's canonical datatype representation, arXiv:2012.14363, crossed
with the irredundant compressed stencil layout of arXiv:2401.12071):
each per-axis-direction message is ONE contiguous box that carries

* along the sweep axis: exactly the wire face rows;
* along every axis swept EARLIER in ``axis_order``: the interior plus
  that axis's wire halo rows — the minimal diagonal (edge/corner)
  segment, freshly filled by the earlier sweep, so corner data still
  propagates by the sequential-sweep rule;
* along every PENDING axis: the interior only — its halo is rewritten
  by the later sweep, so shipping it would be pure waste.

Each halo cell of the wire-radius shell is therefore sent exactly once
(telescoping: a cell in the halo shell of axes ``i < j`` rides only the
sweep-``j`` message), the number of messages is unchanged (still one
per direction per axis), and only the payload shrinks.

Boxes are STATIC capacity-sized spans so one program serves every
shard of an uneven (+-1 remainder) partition; a span whose start
depends on the shard's actual interior length carries ``plus_L`` and
the engine adds ``shard_interior_len`` at slice time.  The
one-row static overhang a short shard ships lands in the receiver's
dead slack (same mesh coordinate on non-sweep axes, hence the same
interior length at both endpoints) or in a halo row the later sweep
rewrites — bitwise equality with the slab layout holds on the whole
live window (interior plus wire-radius shell).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

from ..geometry import Dim3, Radius

#: halo wire LAYOUTS: how a per-axis message is shaped. "slab" ships
#: full-allocation cross-sections (the reference layout); "irredundant"
#: ships each wire-halo cell exactly once (this module's planner).
WIRE_LAYOUTS = ("slab", "irredundant")


def normalize_wire_layout(wire_layout) -> str:
    """Canonical wire-layout name; ``None`` means the slab default."""
    if wire_layout is None:
        return "slab"
    if wire_layout not in WIRE_LAYOUTS:
        raise ValueError(f"unknown wire layout {wire_layout!r}; "
                         f"expected one of {WIRE_LAYOUTS}")
    return str(wire_layout)


@dataclass(frozen=True)
class Span:
    """One axis extent of a message box: ``[start, start + size)``
    where ``start = base (+ L)`` and ``L`` is the shard's actual
    interior length along that grid axis (``plus_L`` marks the two
    dynamic placements: the hi-side halo landing and the lo-side
    interior-edge pickup)."""
    base: int
    plus_L: bool
    size: int


@dataclass(frozen=True)
class DirectionPlan:
    """Pack/unpack index map for ONE per-axis-direction message.

    ``src``/``dst`` are per-GRID-axis spans (index 0 = x, 1 = y,
    2 = z) into the sender's/receiver's padded allocation; sizes match
    span-for-span so the moved box is a reshape away from
    both."""
    axis: int
    side: int
    src: Tuple[Span, Span, Span]
    dst: Tuple[Span, Span, Span]

    @property
    def elems(self) -> int:
        n = 1
        for s in self.src:
            n *= s.size
        return n


def plan_direction(axis: int, side: int, radius: Radius,
                   alloc_radius: Radius, axis_order: Tuple[int, ...],
                   interiors: Sequence[int]) -> DirectionPlan:
    """Plan the irredundant box for sweep ``axis``, direction ``side``
    (+1 ships toward the +axis neighbor's lo halo landing at
    ``p_lo + L``; -1 the mirror).  ``interiors`` is the per-grid-axis
    interior CAPACITY (allocation minus both alloc pads)."""
    assert axis in axis_order, (axis, axis_order)
    pos = axis_order.index(axis)
    src = []
    dst = []
    for j in range(3):
        p_lo = alloc_radius.face(j, -1)
        c = int(interiors[j])
        if j == axis:
            r_lo = radius.face(j, -1)
            r_hi = radius.face(j, 1)
            if side == 1:
                # rows [p_lo, p_lo + r_hi) -> neighbor's [p_lo + L, ...)
                src.append(Span(p_lo, False, r_hi))
                dst.append(Span(p_lo, True, r_hi))
            else:
                # rows [p_lo + L - r_lo, ...) -> neighbor's [p_lo - r_lo, ...)
                src.append(Span(p_lo - r_lo, True, r_lo))
                dst.append(Span(p_lo - r_lo, False, r_lo))
        elif j in axis_order and axis_order.index(j) < pos:
            # already swept: interior plus its freshly-filled wire halo
            # rows — the minimal diagonal segment (edge/corner carry)
            r_lo = radius.face(j, -1)
            r_hi = radius.face(j, 1)
            span = Span(p_lo - r_lo, False, c + r_lo + r_hi)
            src.append(span)
            dst.append(span)
        else:
            # pending (or never-swept) axis: interior only — its halo
            # is rewritten by the later sweep
            span = Span(p_lo, False, c)
            src.append(span)
            dst.append(span)
    return DirectionPlan(axis=axis, side=side,
                         src=tuple(src), dst=tuple(dst))


def plan_sweep(radius: Radius, alloc_radius: "Radius | None",
               interiors: Sequence[int],
               axis_order: Tuple[int, ...] = (0, 1, 2)
               ) -> Dict[Tuple[int, int], DirectionPlan]:
    """All direction plans of one exchange round, keyed ``(axis,
    side)``; zero-radius directions are omitted (no message)."""
    alloc_r = alloc_radius if alloc_radius is not None else radius
    plans: Dict[Tuple[int, int], DirectionPlan] = {}
    for a in axis_order:
        for side in (1, -1):
            if radius.face(a, side) == 0:
                continue
            plans[(a, side)] = plan_direction(a, side, radius, alloc_r,
                                              axis_order, interiors)
    return plans


def _interiors_from_padded(shard_padded_shape_zyx: Sequence[int],
                           alloc_r: Radius) -> Tuple[int, int, int]:
    z, y, x = (int(v) for v in shard_padded_shape_zyx)
    dims = (x, y, z)  # per grid axis
    return tuple(dims[a] - alloc_r.face(a, -1) - alloc_r.face(a, 1)
                 for a in range(3))


def irredundant_bytes_per_sweep(shard_padded_shape_zyx: Sequence[int],
                                radius: Radius, mesh_counts: Dim3,
                                elem_size: int,
                                axis_order: Tuple[int, ...] = (0, 1, 2),
                                wire_format=None,
                                alloc_radius: "Radius | None" = None
                                ) -> Dict[str, int]:
    """Per-axis wire bytes one shard ships per exchange under the
    irredundant layout — the twin of
    :func:`..parallel.exchange.exchanged_bytes_per_sweep` (which prices
    the slab layout).  Counts only shifts that cross between shards (a
    mesh axis of more than one shard); a narrowing ``wire_format`` axis
    prices elements at on-wire width."""
    from .exchange import AXIS_NAME, normalize_wire_format, wire_elem_size

    alloc_r = alloc_radius if alloc_radius is not None else radius
    interiors = _interiors_from_padded(shard_padded_shape_zyx, alloc_r)
    plans = plan_sweep(radius, alloc_r, interiors, axis_order)
    wf = normalize_wire_format(wire_format)
    out = {"x": 0, "y": 0, "z": 0}
    for (a, _side), plan in plans.items():
        if mesh_counts[a] <= 1:
            continue
        es = wire_elem_size(elem_size, wf[AXIS_NAME[a]])
        out[AXIS_NAME[a]] += plan.elems * es
    return out


def pack_layout_report() -> Dict[str, Dict[str, object]]:
    """Slab-vs-irredundant modeled wire bytes for the canonical
    exchange configs of the JAX package's pack-layout report (the same
    six configs, so that both report the same figures).  Every entry's
    irredundant bytes are strictly below slab wherever a diagonal
    (edge/corner) carry exists (r >= 1 on more than one axis)."""
    from .exchange import exchanged_bytes_per_sweep

    counts = Dim3(2, 2, 2)
    asym = Radius.constant(0)
    asym.set_dir((1, 0, 0), 2)
    asym.set_dir((-1, 0, 0), 1)
    asym.set_dir((0, 1, 0), 1)
    configs = [
        # name, shard_padded_zyx, radius, elem, alloc_radius
        ("exchange[r1]", (16, 16, 16), Radius.constant(1), 4, None),
        ("exchange[r3]", (20, 20, 20), Radius.constant(3), 4, None),
        ("exchange[asym]", (14, 15, 17), asym, 4, None),
        ("exchange_packed[uneven,f32]", (10, 10, 10), Radius.constant(1),
         4, None),
        ("temporal[s=2,deep]", (12, 12, 12), Radius.constant(2), 4, None),
        ("deep_tail[r1,alloc=r2]", (16, 16, 16), Radius.constant(1), 4,
         Radius.constant(2)),
    ]
    report: Dict[str, Dict[str, object]] = {}
    for name, padded, radius, elem, alloc in configs:
        slab = sum(exchanged_bytes_per_sweep(
            padded, radius, counts, elem).values())
        irr = sum(irredundant_bytes_per_sweep(
            padded, radius, counts, elem, alloc_radius=alloc).values())
        report[name] = {
            "shard_padded_zyx": list(padded),
            "slab_bytes": int(slab),
            "irredundant_bytes": int(irr),
            "saved_fraction": round(1.0 - irr / slab, 6) if slab else 0.0,
        }
    return report
