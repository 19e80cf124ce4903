"""The halo-exchange engine over a mesh of shards.

PyTorch-port counterpart of ``stencil_tpu/parallel/exchange.py``. The
JAX engine runs inside ``shard_map``: every shard traces the same
program and ``lax.ppermute`` moves a slab from each shard to its
neighbour along one mesh axis. The port holds all shards in one process
(``parallel/mesh.py``), so a shift is a loop over the mesh positions
that copies each neighbour's slab into this shard (a device-to-device
``copy_`` when the two lie on different devices, a local copy when they
share one; on a one-shard axis the neighbour is the shard itself).

* ``exchange_shard`` fills the halos of the padded shards in place, by
  three sequential axis sweeps, x, then y, then z; each slab spans the
  full allocation of the other two axes, so edge and corner data ride
  along (reference src/stencil.cu:1002-1186 collapsed as in SURVEY §7)
  — or, with ``wire_layout="irredundant"``, the box of
  ``packing.plan_direction`` that carries each halo cell once.
* ``exchange_shard_packed`` moves, per direction, ONE buffer holding
  every quantity's slab (or box) of a shard, per storage dtype
  (reference src/packer.cu); ``exchange_shard_allgather`` gathers every
  shard's boundary slab of a mesh line onto each device and takes the
  two neighbours' (the reference's bin/bench_alltoallv.cu control).
* Halo wire formats (``wire_format``): a float32 message narrows to
  bfloat16 or one of the float8 types on the sender's device, crosses to
  the receiver's device at that width, and widens back to float32
  before it is written; only mesh axes of more than one shard narrow.
* ``accumulate_shard`` is the adjoint sweep: it adds every pad slab into
  the interior that owns it and zeroes the pad (the PIC deposit,
  ``models/pic.py``).
* ``exchange_interior_slabs`` returns, per shard, the four slab tensors
  the halo kernels read (``ops/cuda_halo.py``), leaving the shards as
  they are.
* ``dispatch_exchange`` routes a multi-quantity exchange by
  ``Method``: ``PallasDMA`` to the remote-write kernel
  (``parallel/cuda_exchange.py``, B4), ``PpermutePacked`` to
  ``exchange_shard_packed``, ``AllGather`` to
  ``exchange_shard_allgather`` and ``PpermuteSlab`` to
  ``exchange_shard``; ``make_exchange`` closes over a mesh and its
  settings, and gates a narrowing wire format behind a precision
  certificate (``analysis/precision.py``).

They keep the JAX functions' arguments, with the list of shards (x
fastest, the order of ``Mesh.devices``) in place of the one traced
shard, so that tests feed both packages the same values. Unlike the JAX
versions, the engines update the shards IN PLACE.

A mesh may span processes (``parallel/mesh.py``): the list then holds
None at the positions other ranks own, and ``ranks=`` (``Mesh.peers``)
names each position's owner. Each move of a direction, from shard ``j``
into shard ``i``, is then a local copy where this rank owns both, a send
of ``j``'s box to ``i``'s owner where it owns ``j``, a receive into
``i``'s box where it owns ``i``, and nothing where it owns neither; all
of one direction's messages go in one batch (``multihost.RankMessages``),
which lands before the next direction starts, so that edges and corners
ride the later sweeps as they do in one process. A narrowing wire format
narrows before the send and widens after the receive. Every engine runs
across ranks: the slab, packed, all-gather and interior-slab engines and
``accumulate_shard`` by such batches; the remote-write kernel (B4) on
CUDA shards by stores into the other ranks' shards, mapped through CUDA
IPC (``parallel/ipc.py``), and on CPU shards by batches as well. An
exchange started for overlap (``start_dispatch_exchange``) posts its
first direction's batch and returns; ``wait()`` lands it and runs the
rest, so the work queued in between overlaps the messages.

Within one direction every source is interior along the sweep axis and
every destination halo, so the copies of one direction may run in any
order, on shards that share a device or not, and give what JAX's
simultaneous shifts give. On distinct CUDA devices a cross-device
``copy_`` is ordered after the work already queued on both devices'
current streams, and every kernel launches on its own shard's device and
current stream (``ops/_build.launch``), so a copy out of a shard waits
for the kernel that wrote it and the next kernel for the copies into
its slabs.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..geometry import Dim3, Radius
from .mesh import mesh_index, mesh_linear, mesh_neighbor, this_rank
from .packing import (DirectionPlan, Span, normalize_wire_layout,
                      plan_direction)

# grid axis index -> tensor dimension of a (z,y,x)-ordered field
AXIS_TO_DIM = {0: 2, 1: 1, 2: 0}
AXIS_NAME = {0: "x", 1: "y", 2: "z"}

#: halo WIRE formats: what a message is converted to at the send
#: boundary (TEMPI's canonical-datatype pack layer, arXiv:2012.14363).
#: "f32" is the identity — full storage precision on the wire; "bf16"
#: narrows float32 messages to bfloat16 and widens them on arrival, so
#: halo math runs unchanged at storage precision while wire bytes halve;
#: "e4m3"/"e5m2" narrow to the float8 types (a quarter of the bytes,
#: with the coarser error bound of their 3-/2-bit mantissas). Narrower
#: storage dtypes are never re-narrowed.
WIRE_FORMATS = ("f32", "bf16", "e4m3", "e5m2")

#: wire format -> dtype NAME of the on-wire element type for a float32
#: lane (numpy's and torch's names agree)
WIRE_DTYPE_NAMES = {"f32": "float32", "bf16": "bfloat16",
                    "e4m3": "float8_e4m3fn", "e5m2": "float8_e5m2"}

#: on-wire byte width of a 4-byte float32 element per wire format
_WIRE_F32_BYTES = {"f32": 4, "bf16": 2, "e4m3": 1, "e5m2": 1}

_WIRE_DTYPES = {"bf16": torch.bfloat16, "e4m3": torch.float8_e4m3fn,
                "e5m2": torch.float8_e5m2}

#: float8_e4m3fn has no infinity and 448 is its largest finite value;
#: JAX (XLA, and ml_dtypes alike) rounds |x| <= 464 to +-448 and turns
#: every larger magnitude, +-inf included, into NaN, where torch
#: saturates to +-448 (tests/test_torch_wire.py
#: test_wire_round_trip_equals_jax pins the rule)
E4M3_NAN_ABOVE = 464.0

#: the quiet NaN of each sign on the wire, as bits of the integer type of
#: the dtype's width: JAX narrows a NaN to the quiet NaN of its sign,
#: where torch's bfloat16 cast drops the sign and its float8 casts set
#: every mantissa bit, so ``_to_wire`` writes these bits itself
_NAN_BITS = {torch.bfloat16: (torch.int16, 0x7FC0, -0x40),
             torch.float8_e4m3fn: (torch.int8, 0x7F, -0x01),
             torch.float8_e5m2: (torch.int8, 0x7E, -0x02)}

#: 0xFFC00000: the sign, exponent and quiet bits of a float32 NaN. JAX
#: widens a NaN to the quiet NaN of its sign; torch keeps the mantissa
#: bits of float8_e4m3fn's NaN, and on the card its float8_e5m2 widening
#: sets them all, so ``_from_wire`` masks every widened float8 NaN down
#: to these (a bfloat16 widening is an exact 16-bit shift, so the quiet
#: NaNs ``_to_wire`` writes widen to JAX's as they are)
_QUIET_NAN_MASK = -0x400000

#: (device, wire dtype) -> the quiet NaNs of ``_NAN_BITS`` as 0-dim
#: tensors of the wire's integer type on that device, made once
_QUIET_NANS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def normalize_wire_format(wire_format) -> Dict[str, str]:
    """Canonical per-axis wire-format map ``{"x"|"y"|"z": fmt}``.

    Accepts ``None`` (full precision), a single format string applied
    to every mesh axis, or a per-axis dict (missing axes default to
    "f32")."""
    if wire_format is None:
        return {"x": "f32", "y": "f32", "z": "f32"}
    if isinstance(wire_format, str):
        if wire_format not in WIRE_FORMATS:
            raise ValueError(f"unknown wire format {wire_format!r}; "
                             f"expected one of {WIRE_FORMATS}")
        return {"x": wire_format, "y": wire_format, "z": wire_format}
    out = {"x": "f32", "y": "f32", "z": "f32"}
    for k, v in dict(wire_format).items():
        if k not in out:
            raise ValueError(f"unknown mesh axis {k!r} in wire_format")
        if v not in WIRE_FORMATS:
            raise ValueError(f"unknown wire format {v!r} for axis "
                             f"{k!r}; expected one of {WIRE_FORMATS}")
        out[k] = v
    return out


def wire_dtype(dtype: torch.dtype, fmt: str) -> torch.dtype:
    """The on-wire dtype of a message stored as ``dtype`` under wire
    format ``fmt``: only float32 narrows (to ``torch.bfloat16``,
    ``torch.float8_e4m3fn`` or ``torch.float8_e5m2``); everything else
    ships at storage width."""
    if fmt != "f32" and dtype == torch.float32:
        return _WIRE_DTYPES[fmt]
    return dtype


def wire_elem_size(elem_size: int, fmt: str) -> int:
    """Byte width of one element on the wire (the cost-model twin of
    :func:`wire_dtype`): a 4-byte element ships as 2 under "bf16" and
    as 1 under the float8 formats."""
    if int(elem_size) == 4:
        return _WIRE_F32_BYTES[fmt]
    return int(elem_size)


def _quiet_nans(device: torch.device, wd: torch.dtype):
    """(positive, negative) quiet NaN of wire dtype ``wd`` as 0-dim
    tensors of its integer type on ``device`` (``_NAN_BITS``)."""
    got = _QUIET_NANS.get((device, wd))
    if got is None:
        ity, pos, neg = _NAN_BITS[wd]
        got = _QUIET_NANS[(device, wd)] = tuple(
            torch.full((), v, dtype=ity, device=device) for v in (pos, neg))
    return got


def _to_wire(t: torch.Tensor, fmt: str) -> torch.Tensor:
    """``t`` narrowed to its wire dtype under ``fmt`` (``t`` itself when
    nothing narrows), as JAX's ``astype`` narrows: round to nearest
    even, NaN made the quiet NaN of its sign, and under "e4m3" NaN for
    |x| > 464 and +-inf (``E4M3_NAN_ABOVE``; ``not |x| <= 464`` holds
    for NaN too)."""
    wd = wire_dtype(t.dtype, fmt)
    if wd == t.dtype:
        return t
    if wd == torch.float8_e4m3fn:
        nan = ~(t.abs() <= E4M3_NAN_ABOVE)
    else:
        nan = torch.isnan(t)
    pos, neg = _quiet_nans(t.device, wd)
    quiet = torch.where(torch.signbit(t), neg, pos)
    return torch.where(nan, quiet, t.to(wd).view(pos.dtype)).view(wd)


def _from_wire(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A wire message widened back to its storage ``dtype`` (``t``
    itself when it arrived at that width); a NaN widens to the quiet NaN
    of its sign, as in JAX (``_QUIET_NAN_MASK``: only float8 needs it)."""
    if t.dtype == dtype:
        return t
    out = t.to(dtype)
    if dtype != torch.float32 or t.dtype == torch.bfloat16:
        return out
    bits = out.view(torch.int32)
    return torch.where(torch.isnan(out), bits & _QUIET_NAN_MASK,
                       bits).view(dtype)


class WireProbe:
    """The record of a probe exchange (``make_exchange``'s precision
    gate): per message that moves between two mesh positions, its axis,
    the dtype it crossed at, the storage dtype it was meant for and the
    dtype it was written as; ``bytes`` sums the messages' wire bytes."""

    def __init__(self) -> None:
        self.records: List[Tuple[str, torch.dtype, torch.dtype,
                                 torch.dtype]] = []
        self.bytes = 0

    def moved(self, axis: str, wire: torch.dtype, storage: torch.dtype,
              written: torch.dtype, nbytes: int) -> None:
        self.records.append((axis, wire, storage, written))
        self.bytes += int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _ship(src: torch.Tensor, device: torch.device, fmt: str, axis: str,
          probe: Optional[WireProbe] = None) -> torch.Tensor:
    """One message between two mesh positions: ``src`` narrowed under
    ``fmt`` on its own device, moved to ``device`` at wire width, and
    widened back to its storage dtype there. A message that does not
    narrow is returned as it is, for the caller's ``copy_`` to move."""
    wire = _to_wire(src, fmt)
    recv = src if wire is src else _from_wire(wire.to(device), src.dtype)
    if probe is not None:
        probe.moved(axis, wire.dtype, src.dtype, recv.dtype, _nbytes(wire))
    return recv


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


def _first(arrs: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """A shard this process holds (every shard has the same shape and
    dtype)."""
    for t in arrs:
        if t is not None:
            return t
    raise ValueError("this process holds no shard of the mesh")


def _check_pads(a: int, radius: Radius, alloc_r: Radius) -> None:
    if (alloc_r.face(a, -1) < radius.face(a, -1)
            or alloc_r.face(a, 1) < radius.face(a, 1)):
        raise ValueError(
            f"axis {a}: wire depth ({radius.face(a, -1)},"
            f"{radius.face(a, 1)}) exceeds allocation pads "
            f"({alloc_r.face(a, -1)},{alloc_r.face(a, 1)})")


def _shard_lens(shape_zyx: Sequence[int], alloc_r: Radius, counts: Dim3,
                rem: Dim3) -> List[Tuple[int, int, int]]:
    """Per shard (x fastest), its actual interior length along each grid
    axis: the capacity of the padded ``shape_zyx``, one less along an
    uneven axis past the remainder."""
    caps = [shape_zyx[AXIS_TO_DIM[a]] - alloc_r.face(a, -1)
            - alloc_r.face(a, 1) for a in range(3)]
    return [tuple(shard_interior_len(a, caps[a], rem, idx[a])
                  for a in range(3))
            for idx in (mesh_index(i, counts)
                        for i in range(counts.flatten()))]


def _direction_plan(a: int, side: int, radius: Radius, alloc_r: Radius,
                    axis_order: Tuple[int, ...], shape_zyx: Sequence[int],
                    layout: str) -> DirectionPlan:
    """Where the message of sweep ``a``, direction ``side``, leaves the
    sender and lands in the receiver: the irredundant box of
    ``packing.plan_direction``, or the slab — the same rows along ``a``,
    over the full allocation of the other two axes."""
    full = [int(shape_zyx[AXIS_TO_DIM[b]]) for b in range(3)]
    interiors = [full[b] - alloc_r.face(b, -1) - alloc_r.face(b, 1)
                 for b in range(3)]
    plan = plan_direction(a, side, radius, alloc_r, tuple(axis_order),
                          interiors)
    if layout == "irredundant":
        return plan
    slab = [Span(0, False, full[b]) for b in range(3)]

    def spans(along):
        return tuple(along[b] if b == a else slab[b] for b in range(3))

    return DirectionPlan(axis=a, side=side, src=spans(plan.src),
                         dst=spans(plan.dst))


def _narrows(spans: Tuple[Span, Span, Span], lens: Tuple[int, int, int],
             shape_zyx: Sequence[int]) -> Tuple[Tuple[int, int, int], ...]:
    """The ``narrow`` calls, ``(dim, start, size)``, that cut a
    ``DirectionPlan`` box out of a padded (z,y,x) shard whose actual
    interior lengths are ``lens`` (per grid axis): a ``plus_L`` span
    starts ``lens[a]`` further on (JAX: ``_box_take`` / ``_box_put``).
    A span over a whole dimension needs none, so a slab is one. The
    dimensions count from the end, so that a shard with leading
    dimensions (an ensemble's member axis) is cut alike."""
    out = []
    for a in range(3):
        s, dim = spans[a], _dim(a)
        start = s.base + (lens[a] if s.plus_L else 0)
        if start != 0 or s.size != shape_zyx[dim]:
            out.append((dim, start, s.size))
    return tuple(out)


def _dim(a: int) -> int:
    """The tensor dimension of grid axis ``a``, counted from the end."""
    return AXIS_TO_DIM[a] - 3


def _view(arr: torch.Tensor,
          narrows: Tuple[Tuple[int, int, int], ...]) -> torch.Tensor:
    for dim, start, size in narrows:
        arr = arr.narrow(dim, start, size)
    return arr


def _exterior(i: int, counts: Dim3, a: int, side: int) -> bool:
    """Is the ``side`` halo of shard ``i`` along ``a`` across the open
    global boundary? On a one-shard axis every halo is (JAX:
    ``_edge_masked``)."""
    n = counts[a]
    return n == 1 or mesh_index(i, counts)[a] == (n - 1 if side == 1 else 0)


def _faces(r: Radius) -> Tuple[int, ...]:
    return tuple(r.face(a, s) for a in range(3) for s in (-1, 1))


#: an exchange configuration (``_moves``' arguments) -> its moves
_MOVES: Dict[tuple, tuple] = {}


def _moves(shape_zyx: Sequence[int], radius: Radius, alloc_r: Radius,
           counts: Dim3, rem: Dim3, axis_order: Tuple[int, ...],
           layout: str, nonperiodic: bool) -> tuple:
    """The moves of one exchange of padded (z,y,x) shards of
    ``shape_zyx``, planned once per configuration and then reused: per
    direction in sweep order, ``(axis, side, per_shard)``, where
    ``per_shard[i]`` is ``(dst, j, src)``: the ``narrow`` calls
    (``_narrows``) of shard i's halo box, and those of the box of shard
    j it is filled from — ``j`` None where the halo is zero-filled.
    ``shape_zyx`` may carry leading dimensions (an ensemble's member
    axis): the moves depend on its last three only, so one message per
    direction carries every member's slab."""
    shape = tuple(int(v) for v in shape_zyx[-3:])
    key = (shape, _faces(radius), _faces(alloc_r),
           tuple(counts), tuple(rem), tuple(axis_order), layout,
           nonperiodic)
    got = _MOVES.get(key)
    if got is not None:
        return got
    lens = _shard_lens(shape, alloc_r, counts, rem)
    out = []
    for a in axis_order:
        if radius.wire_rows(a) == 0:
            continue
        _check_pads(a, radius, alloc_r)
        for side in (1, -1):
            if radius.face(a, side) == 0:
                continue
            plan = _direction_plan(a, side, radius, alloc_r, axis_order,
                                   shape, layout)
            per = []
            for i in range(counts.flatten()):
                dst = _narrows(plan.dst, lens[i], shape)
                if nonperiodic and _exterior(i, counts, a, side):
                    per.append((dst, None, None))
                    continue
                j = mesh_neighbor(i, counts, a, side)
                per.append((dst, j, _narrows(plan.src, lens[j], shape)))
            out.append((a, side, tuple(per)))
    got = _MOVES[key] = tuple(out)
    return got


def exchange_shard(shards: Sequence[torch.Tensor], radius: Radius,
                   mesh_counts: Dim3 = Dim3(1, 1, 1),
                   axis_order: Tuple[int, ...] = (0, 1, 2),
                   rem: Dim3 = Dim3(0, 0, 0),
                   alloc_radius: "Radius | None" = None,
                   nonperiodic: bool = False,
                   wire_format=None, wire_layout=None,
                   probe: Optional[WireProbe] = None,
                   ranks: Optional[Sequence[int]] = None
                   ) -> Sequence[torch.Tensor]:
    """Fill all halo regions of the padded (z,y,x) shards of a mesh (x
    fastest) via sequential axis sweeps, in place; returns ``shards``.
    Per axis the hi-side halo is filled first, then the lo side, as in
    the JAX engine (``stencil_tpu/parallel/exchange.py:218-332``):

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
    (``Boundary.NONE``); on a one-shard axis every halo is exterior.
    ``wire_format``: per-axis halo wire format
    (``normalize_wire_format``); a narrowing axis of more than one shard
    ships each message at the narrow width (``_ship``); one-shard axes
    are local copies at full precision.
    ``wire_layout``: "slab" (default — full-allocation cross-sections)
    or "irredundant" (each wire-halo cell ships exactly once, boxes of
    ``packing.plan_direction`` placed by each shard's own interior
    lengths). The live window (interior plus wire-radius shell) is
    bitwise the slab layout's; a short shard's dead slack row may
    differ. ``probe``: records every message (``make_exchange``).
    ``ranks``: each position's owner on a mesh that spans processes
    (None at the positions of ``shards`` other ranks own)."""
    for _ in _shard_batches(shards, radius, mesh_counts, axis_order, rem,
                            alloc_radius, nonperiodic, wire_format,
                            wire_layout, probe, ranks):
        pass
    return shards


def _shard_batches(shards, radius, mesh_counts, axis_order, rem,
                   alloc_radius, nonperiodic, wire_format, wire_layout,
                   probe, ranks):
    """``exchange_shard`` as a generator: it yields once each direction's
    batch of cross-rank messages is posted, and lands the batch when
    resumed (in one process it never yields)."""
    counts = Dim3.of(mesh_counts)
    arrs = _as_list(shards, counts)
    alloc_r = alloc_radius if alloc_radius is not None else radius
    wf = normalize_wire_format(wire_format)
    layout = normalize_wire_layout(wire_layout)
    me = this_rank() if ranks is not None else None
    for a, _, per in _moves(_first(arrs).shape, radius, alloc_r, counts,
                            rem, axis_order, layout, nonperiodic):
        name = AXIS_NAME[a]
        fmt = wf[name] if counts[a] > 1 else "f32"
        plain = fmt == "f32" and probe is None
        msgs = _messages(ranks)
        for i, (dst_at, j, src_at) in enumerate(per):
            mine = ranks is None or ranks[i] == me
            if j is not None and ranks is not None and ranks[j] != me:
                if mine:
                    dst = _view(arrs[i], dst_at)
                    msgs.recv(dst.shape, wire_dtype(dst.dtype, fmt),
                              dst.device, ranks[j], i, _lander(dst))
                continue
            if not mine:
                if j is not None:
                    msgs.send(_to_wire(_view(arrs[j], src_at), fmt),
                              ranks[i], i)
                continue
            dst = _view(arrs[i], dst_at)
            if j is None:
                dst.zero_()
                continue
            src = _view(arrs[j], src_at)
            if j == i:
                dst.copy_(src.clone())
            elif plain:
                dst.copy_(src)
            else:
                dst.copy_(_ship(src, arrs[i].device, fmt, name, probe))
        yield from _posted(msgs)


def _posted(msgs):
    """Post a batch of messages, yield, then land it (nothing without a
    batch)."""
    if msgs is not None:
        msgs.start()
        yield
        msgs.wait()


def _messages(ranks):
    """A batch of cross-rank messages for one direction, or None in one
    process."""
    if ranks is None:
        return None
    from .multihost import RankMessages

    return RankMessages()


def _lander(dst: torch.Tensor):
    """What writes an arrived wire message into ``dst``: widened to its
    storage dtype on ``dst``'s device, then copied."""
    def land(buf: torch.Tensor) -> None:
        dst.copy_(_from_wire(buf, dst.dtype))

    return land


def accumulate_shard(shards: Sequence[torch.Tensor], radius: Radius,
                     mesh_counts: Dim3 = Dim3(1, 1, 1),
                     axis_order: Tuple[int, ...] = (2, 1, 0),
                     rem: Dim3 = Dim3(0, 0, 0),
                     nonperiodic: bool = False,
                     probe: Optional[WireProbe] = None,
                     ranks: Optional[Sequence[int]] = None
                     ) -> Sequence[torch.Tensor]:
    """The ADJOINT of ``exchange_shard``, in place on the padded (z,y,x)
    shards of a mesh (x fastest); returns ``shards`` (JAX
    ``parallel/exchange.py:335-404``): fold halo-pad contributions back
    into the interiors that own them (a PIC particle near a shard edge
    deposits charge into pad cells that belong to a neighbour).

    Per axis, in the reverse of the exchange's order (z, y, x), each pad
    slab is added into the owning neighbour's interior edge rows, then
    zeroed: first the hi pad ``[p_lo + L, p_lo + L + r_hi)`` into the
    +neighbour's rows ``[p_lo, p_lo + r_hi)``, then the lo pad ``[0,
    r_lo)`` into the -neighbour's rows ``[p_lo + L' - r_lo, p_lo + L')``,
    where ``L`` is this shard's actual interior length (``rem``: uneven
    +-1 shards) and ``L'`` the neighbour's. A slab spans the full
    allocation of the other two axes, so edge and corner contributions
    ride into the other axes' pads and are folded by the later sweeps.
    As JAX's ``ppermute`` is simultaneous, every shard's slab of a
    direction is taken before any shard adds its arrivals.
    ``nonperiodic``: contributions crossing the open global boundary are
    dropped (on a one-shard axis, all of them). ``probe`` records every
    message between two mesh positions (one a shard, direction and axis
    of more than one shard). ``ranks``: each position's owner on a mesh
    that spans processes (None at the positions of ``shards`` other
    ranks own): a slab whose receiver another rank owns goes as a
    message, in one batch a direction, taken with the others before any
    arrival is added."""
    counts = Dim3.of(mesh_counts)
    arrs = _as_list(shards, counts)
    me = this_rank() if ranks is not None else None
    own = [i for i, t in enumerate(arrs) if t is not None]
    idx = [mesh_index(i, counts) for i in range(len(arrs))]
    for a in axis_order:
        r_lo, r_hi = radius.face(a, -1), radius.face(a, 1)
        if r_lo == 0 and r_hi == 0:
            continue
        dim = AXIS_TO_DIM[a]
        name = AXIS_NAME[a]
        interior = _first(arrs).shape[dim] - r_lo - r_hi
        lens = [shard_interior_len(a, interior, rem, m[a]) for m in idx]
        # (side the slab travels, its rows on the sender, the rows it is
        # added into on the receiver, the edge whose arrivals the open
        # boundary absorbs)
        moves = []
        if r_hi > 0:
            moves.append((1, lambda i: (r_lo + lens[i], r_hi),
                          lambda i: (r_lo, r_hi), -1))
        if r_lo > 0:
            moves.append((-1, lambda i: (0, r_lo),
                          lambda i: (lens[i], r_lo), 1))
        for side, src_at, dst_at, edge in moves:
            sent = [None if t is None else t.narrow(dim, *src_at(i)).clone()
                    for i, t in enumerate(arrs)]
            takes = [not (nonperiodic and _exterior(i, counts, a, edge))
                     for i in range(len(arrs))]
            sent_from: Dict[int, torch.Tensor] = {}
            msgs = _messages(ranks)
            if msgs is not None:
                for i in range(len(arrs)):
                    j = mesh_neighbor(i, counts, a, -side)
                    if not takes[i] or ranks[i] == ranks[j]:
                        continue
                    if ranks[j] == me:
                        msgs.send(sent[j], ranks[i], i)
                    elif ranks[i] == me:
                        def land(buf, i=i):
                            sent_from[i] = buf
                        t = arrs[i]
                        msgs.recv(sent[i].shape, t.dtype, t.device, ranks[j],
                                  i, land)
                msgs.run()
            for i in own:
                t = arrs[i]
                j = mesh_neighbor(i, counts, a, -side)
                recv = sent_from.get(i, sent[j])
                if j != i and probe is not None:
                    probe.moved(name, recv.dtype, recv.dtype, recv.dtype,
                                _nbytes(recv))
                if takes[i]:
                    dst = t.narrow(dim, *dst_at(i))
                    dst.copy_(dst + recv.to(t.device))
                t.narrow(dim, *src_at(i)).zero_()
    return shards


def exchange_interior_slabs(shards: Sequence[torch.Tensor],
                            mesh_counts: Dim3,
                            rz: int, ry: int, radius_rows: int = 0,
                            y_z_extended: bool = False,
                            rem: Dim3 = Dim3(0, 0, 0),
                            ranks: Optional[Sequence[int]] = None
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
    ``ranks``: each position's owner on a mesh that spans processes; the
    shards and the returned slabs are then None at the positions other
    ranks own. The z slabs land before the y sources that span them are
    sent, in two batches of messages.
    """
    counts = Dim3.of(mesh_counts)
    if counts.x != 1:
        raise ValueError("exchange_interior_slabs: x must not be sharded "
                         f"(mesh {tuple(counts)})")
    arrs = _as_list(shards, counts)
    first = _first(arrs)
    lead = tuple(first.shape[:-3])
    Z, Y, X = first.shape[-3:]
    r = radius_rows or min(rz, ry)
    if not (r <= rz and r <= ry):
        raise ValueError(f"radius_rows {r} exceeds rz={rz} or ry={ry}")
    if rem != Dim3(0, 0, 0) and y_z_extended:
        raise ValueError("uneven shards unsupported with z-extended y slabs")
    n = len(arrs)
    idx = [mesh_index(i, counts) for i in range(n)]
    Lz = [shard_interior_len(2, Z, rem, idx[i].z) for i in range(n)]
    Ly = [shard_interior_len(1, Y, rem, idx[i].y) for i in range(n)]

    me = this_rank() if ranks is not None else None

    def moved(*plans) -> List[List[Optional[torch.Tensor]]]:
        """Per plan ``(axis, step, rows, take)``, the message of every
        position ``i`` this process holds, on its device: ``take(j)`` of
        the neighbour ``j`` one ``step`` along ``axis``, ``rows`` (z, y)
        of it. Cross-rank messages of all the plans go in one batch."""
        outs: List[List[Optional[torch.Tensor]]] = [[None] * n
                                                    for _ in plans]
        msgs = _messages(ranks)
        for p, (axis, step, rows, take) in enumerate(plans):
            for i in range(n):
                j = mesh_neighbor(i, counts, axis, step)
                mine = ranks is None or ranks[i] == me
                if ranks is None or ranks[j] == me:
                    if mine:
                        outs[p][i] = take(j).to(arrs[i].device, copy=True)
                    else:
                        msgs.send(take(j), ranks[i], len(plans) * i + p)
                elif mine:
                    def land(buf, p=p, i=i):
                        outs[p][i] = buf

                    msgs.recv(lead + (rows[0], rows[1], X), first.dtype,
                              arrs[i].device, ranks[j],
                              len(plans) * i + p, land)
        if msgs is not None:
            msgs.run()
        return outs

    # r-row transfers: zlo from the z-minus neighbour's actual top rows,
    # zhi from the z-plus neighbour's bottom rows
    zlo_r, zhi_r = moved(
        (2, -1, (r, Y), lambda j: arrs[j].narrow(-3, Lz[j] - r, r)),
        (2, 1, (r, Y), lambda j: arrs[j].narrow(-3, 0, r)))
    if y_z_extended:
        def ysrc(j: int, lo: bool) -> torch.Tensor:
            y0 = 0 if lo else Y - r
            return torch.cat([t.narrow(-2, y0, r) for t in
                              (zlo_r[j], arrs[j], zhi_r[j])], dim=-3)
        zoff = rz - r
        yrows = (Z + 2 * r, r)
    else:
        def ysrc(j: int, lo: bool) -> torch.Tensor:
            return arrs[j].narrow(-2, 0 if lo else Ly[j] - r, r)
        zoff = 0
        yrows = (Z, r)
    ylo_r, yhi_r = moved((1, -1, yrows, lambda j: ysrc(j, False)),
                         (1, 1, yrows, lambda j: ysrc(j, True)))

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

    return [None if zlo_r[i] is None else
            {"zlo": zembed(zlo_r[i], True), "zhi": zembed(zhi_r[i], False),
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


def measure_slab_exchange_seconds(mesh, local: Dim3, dtype, rz: int, ry: int,
                                  radius_rows: int, y_z_extended: bool,
                                  nfields: int = 1, reps: int = 10) -> float:
    """Seconds of ONE ``exchange_interior_slabs`` round for ``nfields``
    interior-resident fields over ``mesh`` (a ``parallel/mesh.Mesh``):
    the exchange cost of the fused halo paths, which perform exactly
    this transfer between their kernels (JAX: ``parallel/exchange.py:852``).
    Zero shards of ``local`` (x, y, z) extent are made on each mesh
    position's device; one round runs first, outside the timed window,
    then ``reps`` rounds, ending in a synchronize of every device."""
    import time

    from ..utils.timers import device_sync

    counts = mesh.shape
    fields = [[torch.zeros((local.z, local.y, local.x), dtype=dtype,
                           device=d) if i in mesh.local_positions else None
               for i, d in enumerate(mesh.devices)]
              for _ in range(nfields)]

    def once():
        return [exchange_interior_slabs(f, counts, rz=rz, ry=ry,
                                        radius_rows=radius_rows,
                                        y_z_extended=y_z_extended,
                                        ranks=mesh.peers)
                for f in fields]

    out = once()
    device_sync([t for f in fields for t in f if t is not None])
    t0 = time.perf_counter()
    for _ in range(reps):
        out = once()
    device_sync([s[k] for per in out for s in per if s is not None
                 for k in ("zlo", "zhi", "ylo", "yhi")])
    return (time.perf_counter() - t0) / reps


def exchanged_bytes_per_sweep(shard_padded_shape_zyx, radius: Radius,
                              mesh_counts: Dim3, elem_size: int,
                              axis_order: Tuple[int, ...] = (0, 1, 2),
                              wire_format=None) -> Dict[str, int]:
    """Per-axis bytes one shard puts on the wire per exchange (reference:
    stencil.hpp:86-93, src/stencil.cu:516-637). Counts only shifts that
    cross shards; one-shard axes are wraps of the shard into itself and
    cost 0. A narrowing ``wire_format`` axis prices its elements at the
    on-wire width. Prices the SLAB layout; the irredundant twin is
    ``packing.irredundant_bytes_per_sweep``."""
    out = {"x": 0, "y": 0, "z": 0}
    shape = list(shard_padded_shape_zyx)
    wf = normalize_wire_format(wire_format)
    for a in axis_order:
        dim = AXIS_TO_DIM[a]
        if mesh_counts[a] <= 1:
            continue
        other = 1
        for d in range(3):
            if d != dim:
                other *= shape[d]
        es = wire_elem_size(elem_size, wf[AXIS_NAME[a]])
        out[AXIS_NAME[a]] = radius.wire_rows(a) * other * es
    return out


def _single_axis_radius(radius: Radius, axis: int) -> Radius:
    """``radius`` on the faces of ``axis`` alone, zero elsewhere."""
    r = Radius.constant(0)
    for side in (-1, 1):
        d = [0, 0, 0]
        d[axis] = side
        r.set_dir(tuple(d), radius.face(axis, side))
    return r


def exchange_shard_packed(fields: Dict[str, List[torch.Tensor]],
                          radius: Radius, mesh_counts: Dim3,
                          axis_order: Tuple[int, ...] = (0, 1, 2),
                          rem: Dim3 = Dim3(0, 0, 0),
                          alloc_radius: "Radius | None" = None,
                          nonperiodic: bool = False,
                          wire_format=None, wire_layout=None,
                          probe: Optional[WireProbe] = None,
                          ranks: Optional[Sequence[int]] = None
                          ) -> Dict[str, List[torch.Tensor]]:
    """Multi-quantity exchange with per-direction packing (JAX
    ``parallel/exchange.py:518-644``; reference src/packer.cu:10-44,
    69-82), in place; returns ``fields``. Per axis, side and storage
    dtype (quantities in sorted name order, so both ends agree on the
    layout), each shard's message is every quantity's slab — or
    irredundant box — from its neighbour, flattened and concatenated
    into ONE buffer on the neighbour's device, narrowed once, moved to
    this shard's device, widened once, split, and written back. The
    placement of every part is ``exchange_shard``'s, so each quantity's
    halos come out bitwise as ``exchange_shard`` fills them. A one-shard
    axis is a local copy of each quantity, as there. ``ranks``: each
    position's owner on a mesh that spans processes (``exchange_shard``):
    a packed buffer is then one message."""
    for _ in _packed_batches(fields, radius, mesh_counts, axis_order, rem,
                             alloc_radius, nonperiodic, wire_format,
                             wire_layout, probe, ranks):
        pass
    return fields


def _packed_batches(fields, radius, mesh_counts, axis_order, rem,
                    alloc_radius, nonperiodic, wire_format, wire_layout,
                    probe, ranks):
    """``exchange_shard_packed`` as a generator (``_shard_batches``)."""
    counts = Dim3.of(mesh_counts)
    alloc_r = alloc_radius if alloc_radius is not None else radius
    wf = normalize_wire_format(wire_format)
    layout = normalize_wire_layout(wire_layout)
    names = sorted(fields)
    arrs = {q: _as_list(fields[q], counts) for q in names}
    moves = {q: _moves(_first(arrs[q]).shape, radius, alloc_r, counts, rem,
                       axis_order, layout, nonperiodic) for q in names}
    groups: Dict[torch.dtype, List[str]] = {}
    for q in names:
        groups.setdefault(_first(arrs[q]).dtype, []).append(q)
    me = this_rank() if ranks is not None else None
    n = counts.flatten()
    for k, (a, _, first) in enumerate(moves[names[0]]):
        name = AXIS_NAME[a]
        fmt = wf[name] if counts[a] > 1 else "f32"
        msgs = _messages(ranks)
        for g, (dt, qs) in enumerate(groups.items()):
            for i, (_, j, _) in enumerate(first):
                mine = ranks is None or ranks[i] == me
                theirs = (j is not None and ranks is not None
                          and ranks[j] != me)
                if not mine:
                    if j is not None and not theirs:
                        srcs = [_view(arrs[q][j], moves[q][k][2][i][2])
                                for q in qs]
                        buf = torch.cat([s.reshape(-1) for s in srcs])
                        msgs.send(_to_wire(buf, fmt), ranks[i], g * n + i)
                    continue
                dsts = [_view(arrs[q][i], moves[q][k][2][i][0]) for q in qs]
                if j is None:
                    for d in dsts:
                        d.zero_()
                    continue
                if theirs:
                    msgs.recv((sum(d.numel() for d in dsts),),
                              wire_dtype(dt, fmt), dsts[0].device, ranks[j],
                              g * n + i, _splitter(dsts))
                    continue
                srcs = [_view(arrs[q][j], moves[q][k][2][i][2]) for q in qs]
                if j == i:
                    for d, s in zip(dsts, srcs):
                        d.copy_(s.clone())
                    continue
                buf = torch.cat([s.reshape(-1) for s in srcs])
                dev = dsts[0].device
                _splitter(dsts)(_ship(buf, dev, fmt, name, probe).to(dev))
        yield from _posted(msgs)


def _splitter(dsts: Sequence[torch.Tensor]):
    """What writes an arrived packed buffer into the boxes ``dsts``, in
    order: widened to their storage dtype, then split."""
    def land(buf: torch.Tensor) -> None:
        recv = _from_wire(buf, dsts[0].dtype)
        off = 0
        for d in dsts:
            d.copy_(recv[off:off + d.numel()].view(d.shape))
            off += d.numel()

    return land


def exchange_shard_allgather(shards: Sequence[torch.Tensor], radius: Radius,
                             mesh_counts: Dim3,
                             axis_order: Tuple[int, ...] = (0, 1, 2),
                             probe: Optional[WireProbe] = None,
                             ranks: Optional[Sequence[int]] = None
                             ) -> Sequence[torch.Tensor]:
    """The all-gather control strategy (JAX ``parallel/exchange.py:
    647-681``; reference bin/bench_alltoallv.cu), in place; returns
    ``shards``. Per axis and side, along each mesh line every shard's
    boundary slab is gathered onto each device of the line (one stacked
    tensor a device), and each shard takes its neighbour's slab from the
    stack on its own device: n times the bytes of the slab copy, the
    same halos. A one-shard axis is the slab copy's local wrap. Even
    grids with the allocation at ``radius`` only (``dispatch_exchange``
    refuses the rest), so every shard's boxes lie alike. ``ranks``:
    each position's owner on a mesh that spans processes; a position
    then receives every slab of its line that another rank owns as a
    message (one batch a direction), n times the slab's bytes too."""
    for _ in _allgather_batches(shards, radius, mesh_counts, axis_order,
                                probe, ranks):
        pass
    return shards


def _allgather_batches(shards, radius, mesh_counts, axis_order, probe,
                       ranks):
    """``exchange_shard_allgather`` as a generator (``_shard_batches``)."""
    counts = Dim3.of(mesh_counts)
    arrs = _as_list(shards, counts)
    for a, side, per in _moves(_first(arrs).shape, radius, radius, counts,
                               Dim3(0, 0, 0), axis_order, "slab", False):
        n_dev = counts[a]
        if n_dev == 1:
            for i, (dst_at, _, src_at) in enumerate(per):
                if arrs[i] is not None:
                    _view(arrs[i], dst_at).copy_(
                        _view(arrs[i], src_at).clone())
            continue
        name = AXIS_NAME[a]
        dst_at, _, src_at = per[0]
        msgs = _messages(ranks)
        stacks = []
        for first in range(len(arrs)):
            idx = list(mesh_index(first, counts))
            if idx[a] != 0:
                continue
            line = []
            for k in range(n_dev):
                idx[a] = k
                line.append(mesh_linear(Dim3(*idx), counts))
            slabs = [None if arrs[k] is None else _view(arrs[k], src_at)
                     for k in line]
            gathered = {}
            for k in line:
                if arrs[k] is None:
                    # another rank's position: this rank sends it the
                    # slabs it owns
                    for p, s in enumerate(slabs):
                        if s is not None:
                            msgs.send(s, ranks[k], k * n_dev + p)
                    continue
                # one stack a device in one process; across ranks one a
                # position, so that a sender knows every message it owes
                dev = arrs[k].device
                key = dev if ranks is None else k
                if key in gathered:
                    continue
                got = gathered[key] = [None] * n_dev
                for p, s in enumerate(slabs):
                    if s is not None:
                        got[p] = s.to(dev)
                        continue

                    def land(buf, got=got, p=p):
                        got[p] = buf
                    msgs.recv(_view(arrs[k], src_at).shape, arrs[k].dtype,
                              dev, ranks[line[p]], k * n_dev + p, land)
                if probe is not None:
                    for s in slabs:
                        probe.moved(name, s.dtype, s.dtype, s.dtype,
                                    _nbytes(s))
            stacks.append((line, gathered))
        yield from _posted(msgs)
        for line, gathered in stacks:
            stacked = {key: torch.stack(got) for key, got in gathered.items()}
            for p, k in enumerate(line):
                if arrs[k] is not None:
                    key = arrs[k].device if ranks is None else k
                    _view(arrs[k], dst_at).copy_(
                        stacked[key][(p + side) % n_dev])


class ExchangeInFlight:
    """A started exchange. ``wait()`` runs what is left of it: the
    batches of cross-rank messages still to post and land (``pending``,
    a generator of the copy engines' directions, stopped after the
    first direction's batch was posted), then makes the cards' current
    streams wait for the side streams it runs on (``join``, an ``ops/
    cuda_exchange.CardJoin``). With neither — the copy engines in one
    process, or any exchange on the CPU in one process — it has landed
    already and ``wait()`` has nothing to do."""

    def __init__(self, join=None, pending=None) -> None:
        self._join = join
        self._pending = pending

    def wait(self) -> None:
        if self._pending is not None:
            for _ in self._pending:
                pass
            self._pending = None
        if self._join is not None:
            self._join.exit()
            self._join = None


def start_dispatch_exchange(fields: Dict[str, List[torch.Tensor]],
                            radius: Radius, mesh_counts: Dim3, method,
                            axis_order: Tuple[int, ...] = (0, 1, 2),
                            rem: Dim3 = Dim3(0, 0, 0),
                            alloc_radius: "Radius | None" = None,
                            nonperiodic: bool = False,
                            wire_format=None, wire_layout=None,
                            probe: Optional[WireProbe] = None,
                            ranks: Optional[Sequence[int]] = None):
    """Start ``dispatch_exchange`` and return a handle whose ``wait()``
    makes the work queued after it on the cards' current streams see
    the filled halos. Between the two, the caller may queue work that
    reads only the shards' interiors, which the exchange does not write
    — the overlap path's inner block. In one process the copy engines
    run on the current streams and have landed at once; ``PallasDMA``
    runs on one side stream per card (``parallel/cuda_exchange.py``).
    On a mesh that spans processes (``ranks``) the copy engines post
    their first direction's messages here and finish in ``wait()``
    (every later direction carries the earlier ones' halos, so it
    starts only once they have landed); ``PallasDMA`` stores into the
    other ranks' shards, ordered by device-side flags."""
    return _start_exchange(fields, radius, mesh_counts, method, axis_order,
                           rem, alloc_radius, nonperiodic, wire_format,
                           wire_layout, probe, ranks)


def _start_exchange(fields, radius, mesh_counts, method, axis_order, rem,
                    alloc_radius, nonperiodic, wire_format, wire_layout,
                    probe, ranks=None):
    from .methods import WIRE_CAPABLE, Method

    counts = Dim3.of(mesh_counts)
    wf = normalize_wire_format(wire_format)
    narrows = any(v != "f32" for v in wf.values())
    layout = normalize_wire_layout(wire_layout)
    wire_capable = method in WIRE_CAPABLE
    if rem != Dim3(0, 0, 0) and not wire_capable:
        raise NotImplementedError(
            f"uneven (+-1 remainder) subdomains are only supported by "
            f"the PpermuteSlab and PpermutePacked methods, not {method}")
    if ((alloc_radius is not None or nonperiodic or narrows
         or layout != "slab") and not wire_capable):
        raise NotImplementedError(
            f"deep-carry allocations, non-periodic boundaries, narrow "
            f"wire formats, and non-slab wire layouts are only "
            f"supported by the PpermuteSlab and PpermutePacked "
            f"methods, not {method}")
    if method == Method.PallasDMA:
        from .cuda_exchange import start_exchange_shard_cuda

        return start_exchange_shard_cuda(list(fields.values()), radius,
                                         counts, axis_order, ranks)
    if method == Method.PpermutePacked:
        batches = _packed_batches(fields, radius, counts, axis_order, rem,
                                  alloc_radius, nonperiodic, wf, layout,
                                  probe, ranks)
    elif method == Method.AllGather:
        batches = itertools.chain.from_iterable(
            _allgather_batches(shards, radius, counts, axis_order, probe,
                               ranks) for shards in fields.values())
    else:
        batches = itertools.chain.from_iterable(
            _shard_batches(shards, radius, counts, axis_order, rem,
                           alloc_radius, nonperiodic, wf, layout, probe,
                           ranks) for shards in fields.values())
    # run up to the first posted batch (in one process: to the end)
    if next(batches, StopIteration) is StopIteration:
        return ExchangeInFlight()
    return ExchangeInFlight(pending=batches)


def dispatch_exchange(fields: Dict[str, List[torch.Tensor]], radius: Radius,
                      mesh_counts: Dim3, method,
                      axis_order: Tuple[int, ...] = (0, 1, 2),
                      rem: Dim3 = Dim3(0, 0, 0),
                      alloc_radius: "Radius | None" = None,
                      nonperiodic: bool = False,
                      wire_format=None, wire_layout=None,
                      probe: Optional[WireProbe] = None,
                      ranks: Optional[Sequence[int]] = None
                      ) -> Dict[str, List[torch.Tensor]]:
    """Route a multi-quantity exchange (``fields[q]`` is the list of
    padded shards of quantity q, x fastest) to the selected strategy,
    in place; returns ``fields`` (JAX: ``parallel/exchange.py:693-742``,
    with its ``NotImplementedError`` for uneven grids, deep allocations,
    non-periodic boundaries, narrowing wire formats and non-slab wire
    layouts off ``PpermuteSlab`` and ``PpermutePacked``).
    ``PallasDMA`` is B4's remote-write sweep, on the card and (as its
    plain twin) on the CPU; ``PpermutePacked`` is
    ``exchange_shard_packed``, ``AllGather`` ``exchange_shard_allgather``
    and ``PpermuteSlab`` ``exchange_shard``. The halos are the same bits
    whatever the method. ``ranks``: each position's owner on a mesh that
    spans processes, where every method runs (the copy engines by
    messages between the ranks, ``PallasDMA`` by stores over CUDA IPC
    on the card)."""
    _start_exchange(fields, radius, mesh_counts, method, axis_order, rem,
                    alloc_radius, nonperiodic, wire_format, wire_layout,
                    probe, ranks).wait()
    return fields


def make_exchange(mesh, radius: Radius, methods=None,
                  axis_order: Tuple[int, ...] = (0, 1, 2),
                  rem: Dim3 = Dim3(0, 0, 0),
                  nonperiodic: bool = False,
                  wire_format=None, fields_spec=None,
                  wire_layout=None):
    """The multi-quantity halo exchange over ``mesh`` (a
    ``parallel/mesh.Mesh``), JAX ``parallel/exchange.py:745-829``:
    returns ``exchange(fields)``, which fills the halos of every
    quantity's list of padded shards in place through
    ``dispatch_exchange`` with the method ``pick_method(methods)``
    chooses (default ``Method.Default``) and returns ``fields``.

    A NARROWING ``wire_format`` is certificate-gated, as in JAX:
    ``fields_spec`` — ``{name: (padded shard shape (z, y, x), dtype)}``
    — is then required, one probe exchange runs on "meta" shards of that
    spec (no card memory, no kernel) with the engine recording every
    message it moves between mesh positions, and ``analysis/precision.certify_wire_probe`` builds the
    ``PrecisionCertificate``; an unsafe one raises
    ``PrecisionGateError``. The returned callable carries
    ``wire_format``, ``wire_layout``, ``precision_declaration`` and
    ``precision_certificate`` (None for an all-f32 wire, which runs no
    gate). On a mesh that spans processes the exchange moves messages
    between ranks (``mesh.peers``); the probe stays a simulation of the
    whole mesh in this process."""
    from .methods import Method, pick_method

    method = pick_method(Method.Default if methods is None else methods)
    counts = mesh.shape
    wf = normalize_wire_format(wire_format)
    narrows = any(v != "f32" for v in wf.values())
    layout = normalize_wire_layout(wire_layout)

    def exchange(fields: Dict[str, List[torch.Tensor]],
                 probe: Optional[WireProbe] = None
                 ) -> Dict[str, List[torch.Tensor]]:
        return dispatch_exchange(fields, radius, counts, method, axis_order,
                                 rem, nonperiodic=nonperiodic,
                                 wire_format=wf, wire_layout=layout,
                                 probe=probe,
                                 ranks=None if probe is not None
                                 else mesh.peers)

    cert = None
    if narrows:
        from ..analysis import precision

        if fields_spec is None:
            raise ValueError(
                "make_exchange: a narrowing wire_format is certificate-"
                "gated — pass fields_spec={name: (padded_shard_shape_zyx, "
                "dtype)} so that a probe exchange can prove the wire "
                "before it realizes")
        cert = precision.certify_wire_probe(exchange, fields_spec, mesh, wf)
        if not cert.safe:
            raise precision.PrecisionGateError(
                f"make_exchange: wire format {wf} is NOT certified safe "
                f"— refusing to realize: " + "; ".join(cert.reasons))
    exchange.wire_format = dict(wf)
    exchange.wire_layout = layout
    exchange.precision_declaration = {"wire": dict(wf),
                                      "compute": "float32"}
    exchange.precision_certificate = cert
    return exchange
