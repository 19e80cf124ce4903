"""Fixed-capacity particle migration over a mesh of shards.

PyTorch-port counterpart of ``stencil_tpu/parallel/migrate.py``: the
dynamic, data-dependent exchange of a particle-in-cell code (which
particles cross which shard boundary is decided at run time), in the
JAX engine's static form:

* per-shard particle state is SoA: same-dtype ``(capacity,)`` tensors
  plus a ``(capacity,)`` validity mask, dead slots masked;
* destinations are per-axis offsets in {-1, 0, +1} (a particle moves at
  most one shard a step); the 26 directions collapse into three axis
  hops, x, then y on the intermediate shard, then z, the remaining
  offsets riding along in the wire record;
* per axis and direction, the leavers are sorted to the front (a stable
  argsort over the leave mask), cut or padded to a static ``budget`` of
  record slots, and packed into ONE ``(rows, budget)`` buffer, which
  moves to the neighbour as one message;
* arrivals fill free slots (a stable argsort over the validity mask);
  leavers beyond ``budget`` and arrivals beyond the free capacity are
  dropped and counted (the overflow count).

The wire record is ``n_fields + RECORD_EXTRA_ROWS`` rows of the field
dtype a slot: the fields, then one control row that packs the three
remaining offsets and the validity flag into ``code = (ox+1) + 3*(oy+1)
+ 9*(oz+1) + 27*valid`` (in [0, 53], exact in every float dtype).

The JAX engine runs inside ``shard_map`` and moves each buffer with a
simultaneous ``lax.ppermute``. The port holds every shard in one
process, so each axis first builds the buffers of BOTH directions on
every shard, and only then lets any shard take its arrivals. On a mesh
that spans processes (``ranks``) each rank builds its own shards'
buffers, sends those whose receiver another rank holds as messages (one
batch an axis, tagged by receiver and direction as the slab engine tags
its own) and takes its arrivals once the batch has landed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..geometry import Dim3
from .exchange import (AXIS_NAME, WireProbe, _messages, _nbytes,
                       active_probe)
from .mesh import mesh_neighbor, this_rank

#: wire-record rows beyond the SoA fields: one packed control row
RECORD_EXTRA_ROWS = 1


def migration_record_rows(n_fields: int) -> int:
    """Rows of one migration wire record: the SoA fields plus the packed
    control row."""
    return int(n_fields) + RECORD_EXTRA_ROWS


def migration_messages(mesh_counts: Dim3,
                       axis_order: Sequence[int] = (0, 1, 2)) -> int:
    """Messages one shard sends a migration: 2 per mesh axis of more than
    one shard (a one-shard axis is a local copy)."""
    return sum(2 for a in axis_order if mesh_counts[a] > 1)


def migration_wire_bytes_per_shard(n_fields: int, budget: int, counts,
                                   elem_size: int) -> int:
    """Wire bytes one shard sends a migration: ``migration_messages``
    fixed ``record_rows x budget`` buffers (JAX
    ``analysis/costmodel.py:169``)."""
    return (migration_messages(counts) * migration_record_rows(n_fields)
            * int(budget) * int(elem_size))


def encode_record_code(comps: Sequence[torch.Tensor],
                       sent: torch.Tensor) -> torch.Tensor:
    """Three {-1, 0, +1} offset components and the validity flag as one
    integer code in [0, 53]: ``(c0+1) + 3*(c1+1) + 9*(c2+1) + 27*sent``."""
    code = 27 * sent.to(torch.int32)
    for k, c in enumerate(comps):
        code = code + (3 ** k) * (c + 1)
    return code


def decode_record_code(row: torch.Tensor
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Invert ``encode_record_code`` on a received field-dtype row:
    ``(comps, valid)`` with int32 components."""
    code = torch.round(row).to(torch.int32)
    valid = code >= 27
    base = torch.where(valid, code - 27, code)
    comps = [base % 3 - 1, base // 3 % 3 - 1, base // 9 - 1]
    return comps, valid


def _stable_argsort(t: torch.Tensor) -> torch.Tensor:
    return torch.argsort(t.to(torch.int32), stable=True)


def _put(lane: torch.Tensor, slot: torch.Tensor,
         values: torch.Tensor) -> torch.Tensor:
    """``lane`` with ``values`` written at ``slot``, where a slot equal
    to the lane's length is dropped: no data-dependent shape, so no
    device-to-host sync on the card."""
    ext = torch.cat([lane, lane.new_zeros(1)])
    ext.index_put_((slot,), values)
    return ext[:lane.shape[0]]


def migrate_shard(fields: Dict[str, List[torch.Tensor]],
                  valid: List[torch.Tensor],
                  offsets: List[Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]],
                  mesh_counts: Dim3, budget: int,
                  axis_order: Tuple[int, ...] = (0, 1, 2),
                  probe: Optional[WireProbe] = None,
                  ranks: Optional[Sequence[int]] = None
                  ) -> Tuple[Dict[str, List[torch.Tensor]],
                             List[torch.Tensor], List[torch.Tensor]]:
    """Migrate every shard's particles to their destination shards (JAX
    ``migrate_shard``, with lists of shards, x fastest, in place of the
    one traced shard).

    ``fields[q][i]``: shard i's ``(capacity,)`` tensor of field q, one
    common floating dtype. ``valid[i]``: its live slots. ``offsets[i]``:
    its per-axis destination offsets ``(offx, offy, offz)`` in {-1, 0,
    +1}. ``budget``: record slots a message. Returns new ``(fields,
    valid, overflow)``, ``overflow[i]`` the float32 count of particles
    shard i dropped this migration (send budget exceeded, or no free
    slot for an arrival). ``probe`` records every message between two
    mesh positions. ``ranks``: each position's owner on a mesh that spans
    processes (every list None at the positions other ranks hold, in
    the arguments and the results)."""
    counts = Dim3.of(mesh_counts)
    names = sorted(fields)
    if not names:
        raise ValueError("migrate_shard needs at least one field")
    n = len(valid)
    own = [i for i in range(n) if valid[i] is not None]
    dt = fields[names[0]][own[0]].dtype
    for q in names:
        if any(fields[q][i].dtype != dt for i in own):
            raise ValueError(f"migrate_shard fields must share one dtype: "
                             f"{q!r} is not {dt}")
    budget = int(budget)
    if budget < 1:
        raise ValueError(f"budget must be >= 1, got {budget}")
    capacity = fields[names[0]][own[0]].shape[0]
    probe = active_probe(probe)
    me = this_rank() if ranks is not None else None
    work = [None if valid[i] is None else {q: fields[q][i] for q in names}
            for i in range(n)]
    offs = [None if valid[i] is None else [o.to(dt) for o in offsets[i]]
            for i in range(n)]
    valid = [None if v is None else v.to(torch.bool) for v in valid]
    overflow = [None if v is None else
                torch.zeros((), dtype=torch.float32, device=v.device)
                for v in valid]
    rows_n = migration_record_rows(len(names))

    for a in axis_order:
        name = AXIS_NAME[a]
        # every shard's two messages of this axis, before any arrives
        bufs = {}
        leaving = [None] * n
        for i in own:
            out = torch.zeros_like(valid[i])
            for side in (1, -1):
                leave = valid[i] & (offs[i][a] == side)
                out = out | leave
                idx = _stable_argsort(~leave)[:budget]
                sent = leave[idx]
                overflow[i] = overflow[i] + torch.clamp(
                    leave.sum() - budget, min=0).to(torch.float32)
                rows = [work[i][q][idx] for q in names]
                comps = [torch.zeros(idx.shape, dtype=torch.int32,
                                     device=idx.device) if b == a
                         else torch.clamp(torch.round(offs[i][b][idx]).to(
                             torch.int32), -1, 1) for b in range(3)]
                rows.append(encode_record_code(comps, sent).to(dt))
                bufs[i, side] = torch.stack(rows)
            leaving[i] = out
        msgs = _messages(ranks)
        if msgs is not None:
            for i in range(n):
                for k, side in enumerate((1, -1)):
                    j = mesh_neighbor(i, counts, a, -side)
                    if ranks[i] == ranks[j]:
                        continue
                    if ranks[j] == me:
                        msgs.send(bufs[j, side], ranks[i], 2 * i + k)
                    elif ranks[i] == me:
                        def land(buf, j=j, side=side):
                            bufs[j, side] = buf
                        msgs.recv((rows_n, budget), dt, valid[i].device,
                                  ranks[j], 2 * i + k, land)
            msgs.run()
        for i in own:
            # the +1 message comes from the -1 neighbour, and back
            incoming = []
            for side in (1, -1):
                j = mesh_neighbor(i, counts, a, -side)
                buf = bufs[j, side]
                if j != i and probe is not None:
                    probe.moved(name, buf.dtype, buf.dtype, buf.dtype,
                                _nbytes(buf), j, i)
                incoming.append(buf.to(valid[i].device))
            v = valid[i] & ~leaving[i]
            buf = torch.cat(incoming, dim=1)
            inc_comps, inc_valid = decode_record_code(buf[len(names)])
            free_order = _stable_argsort(v)
            free_count = capacity - v.sum()
            rank = torch.cumsum(inc_valid.to(torch.int64), 0) - 1
            ok = inc_valid & (rank < free_count)
            # arrivals without a free slot go to slot `capacity`, one past
            # the lanes, and are cut off with it (JAX: mode="drop")
            slot = torch.where(ok, free_order[torch.clamp(rank, 0,
                                                          capacity - 1)],
                               capacity)
            overflow[i] = overflow[i] + (inc_valid.sum()
                                         - ok.sum()).to(torch.float32)
            for k, q in enumerate(names):
                work[i][q] = _put(work[i][q], slot, buf[k])
            offs[i] = [_put(offs[i][b], slot, inc_comps[b].to(dt))
                       for b in range(3)]
            valid[i] = _put(v, slot, torch.ones_like(inc_valid))
    out = {q: [None if work[i] is None else work[i][q] for i in range(n)]
           for q in names}
    return out, valid, overflow
