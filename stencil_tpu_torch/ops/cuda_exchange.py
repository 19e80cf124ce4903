"""The hand-written remote-write halo exchange (B4), with its plain twin,
its launch tables and the per-card streams that order its sweeps.

PyTorch-port counterpart of ``stencil_tpu/parallel/pallas_exchange.py``
``_exchange_axis_pallas`` (:57): one axis sweep in which every shard of
a mesh stores its two boundary slabs straight into its periodic
neighbours' halos (``csrc/exchange_dma.cu``). The whole exchange,
``exchange_shard_cuda``, lives in ``parallel/cuda_exchange.py``.

==  ==========================================  =======================  ========================
B   TPU kernel                                  wrapper                  plain twin
==  ==========================================  =======================  ========================
B4  pallas_exchange.py:57 ``_exchange_axis_pallas``  ``exchange_axis_cuda``  ``exchange_axis_plain``
==  ==========================================  =======================  ========================

The module rules of ``ops/cuda_stencil.py`` hold: CPU shards go to the
plain twin; CUDA shards launch the kernel or raise — a shard whose card
cannot reach a neighbour's card raises too, and nothing is ever staged
through the host or handed to ``copy_`` instead.

One launch per card and sweep. ``plan_card_sweeps`` (pure) lays out,
per card, a launch table with one row per (quantity, shard) held there:
the shard's pointer, its two neighbours' pointers and the slab geometry
in the widest unit that divides them all. ``ExchangePlan`` uploads the
tables once per set of buffers (``exchange_plan`` caches them by the
buffers' pointers, shapes, strides and dtypes, the sweeps and the mesh),
enabling peer access as it does; a call with the same buffers then
costs one launch per card and sweep (``start_sweeps``), each adding one
to ``LAUNCHES["exchange_axis"]``. A one-shard axis is swept by the same
kernel, each shard its own neighbour.

Ordering. The TPU kernel meets its neighbours at a semaphore barrier
before it writes. On the card every card runs the sweeps on a side
stream of its own (``card_stream``), and events carry the barrier's
meaning: the side streams first wait for the work already queued on the
current stream of every card of the mesh (the previous readers of the
halos about to be written, and the writers of the slabs about to be
read); with several cards, every card's sweep s lands before any card's
sweep s+1 starts; and ``CardJoin.exit`` makes each card's current
stream wait for every card's side stream. No kernel waits on a flag
another launch sets.

Across processes (``ranks``: a mesh that spans ranks) each rank plans
and launches its own cards only: a table row for each shard it holds,
where a neighbour another rank owns gets its pointer mapped through CUDA
IPC (``parallel/ipc.share``, both of a domain's buffers alike, since the
plan cache keys by pointer). Between ranks the events become the
device-side counters of ``parallel/ipc.PeerFlags`` (``ipc.b4_schedule``):
a card signals READY once its current streams' earlier work is done (its
halos may be written) and waits for every other rank's card's READY
before its first sweep; it waits for every other card's SWEPT of sweep s
before sweep s + 1 and, after the last, before the exchange is joined
back. Within a rank the events stay as they are. On CPU shards the twin
moves the slabs that cross between ranks as messages
(``multihost.RankMessages``).
"""

from __future__ import annotations

import ctypes
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Sequence, Set, Tuple

import torch

from ..geometry import Dim3
from ..parallel.mesh import mesh_neighbor, this_rank

#: launches per wrapper since the last ``reset_launch_counts``; only a
#: kernel launch counts, never a call that went to the plain twin
LAUNCHES = {"exchange_axis": 0}

# grid axis index -> tensor dimension of a (z,y,x)-ordered shard
_AXIS_TO_DIM = {0: 2, 1: 1, 2: 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# the peer-access helper
# ---------------------------------------------------------------------------
_peers: Set[Tuple[int, int]] = set()


def enable_peer_access(dev: torch.device, peer: torch.device) -> None:
    """Let kernels on card ``dev`` store into memory of card ``peer``
    (``cudaDeviceEnablePeerAccess``; a no-op for one card, and already-on
    is accepted). Raises when the hardware cannot reach the peer: the
    port never stages a remote write through the host."""
    from . import _build

    a, b = torch.device(dev).index, torch.device(peer).index
    if a == b or (a, b) in _peers:
        return
    fn = _build.load(_LIB).peer_access_enable
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    err = fn(a, b)
    if err == -1:
        raise RuntimeError(f"cuda:{a} cannot access the memory of cuda:{b} "
                           f"(cudaDeviceCanAccessPeer is 0): the remote-"
                           f"write kernels need peer access")
    if err != 0:
        raise RuntimeError(f"enabling peer access cuda:{a} -> cuda:{b} "
                           f"failed: CUDA error {err}")
    _peers.add((a, b))


# ---------------------------------------------------------------------------
# B4: one axis sweep
# ---------------------------------------------------------------------------
def _check_sweep(shards: Sequence[torch.Tensor], axis: int, r_lo: int,
                 r_hi: int, counts: Dim3) -> List[torch.Tensor]:
    arrs = list(shards)
    if len(arrs) != counts.flatten():
        raise ValueError(f"{len(arrs)} shards for a {tuple(counts)} mesh")
    held = [t for t in arrs if t is not None]
    shape, dtype = held[0].shape, held[0].dtype
    for t in held:
        if t.shape != shape or t.dtype != dtype or t.dim() != 3:
            raise ValueError("exchange_axis: every shard must be a padded "
                             "(Z, Y, X) tensor of one shape and dtype")
    interior = shape[_AXIS_TO_DIM[axis]] - r_lo - r_hi
    if min(r_lo, r_hi) < 0 or interior < max(r_lo, r_hi, 1):
        raise ValueError(f"exchange_axis: axis {axis} of {tuple(shape)} "
                         f"cannot carry halos ({r_lo}, {r_hi})")
    return arrs


def exchange_axis_plain(shards: Sequence[torch.Tensor], axis: int,
                        r_lo: int, r_hi: int, counts: Dim3,
                        ranks: Optional[Sequence[int]] = None
                        ) -> Sequence[torch.Tensor]:
    """B4's twin: one sweep along grid ``axis`` (0 x, 1 y, 2 z) over the
    padded (z,y,x) shards of a mesh (x fastest), in place: shard i's
    right neighbour's lo halo ``[0, r_lo)`` <- its ``[interior, r_lo +
    interior)``, its left neighbour's hi halo ``[r_lo + interior,
    alloc)`` <- its ``[r_lo, r_lo + r_hi)``, full cross sections
    (pallas_exchange.py:84-109). Every source is interior and every
    destination halo, so the copies may run in any order. ``ranks``:
    each position's owner on a mesh that spans processes (None at the
    positions of ``shards`` other ranks own); a slab whose two ends lie
    on two ranks is a message, all of the sweep's in one batch."""
    counts = Dim3.of(counts)
    arrs = _check_sweep(shards, axis, r_lo, r_hi, counts)
    dim = _AXIS_TO_DIM[axis]
    interior = next(t for t in arrs if t is not None).shape[dim] - r_lo - r_hi
    msgs = None
    if ranks is not None:
        from ..parallel.multihost import RankMessages

        msgs = RankMessages()
    for i, src in enumerate(arrs):
        # (rows, the neighbour written, its first halo row, my first row)
        for k, (r, j, at, frm) in enumerate((
                (r_lo, mesh_neighbor(i, counts, axis, 1), 0, interior),
                (r_hi, mesh_neighbor(i, counts, axis, -1), r_lo + interior,
                 r_lo))):
            if not r:
                continue
            dst = arrs[j]
            if src is not None and dst is not None:
                dst.narrow(dim, at, r).copy_(src.narrow(dim, frm, r))
            elif src is not None:
                msgs.send(src.narrow(dim, frm, r), ranks[j], 2 * j + k)
            elif dst is not None:
                view = dst.narrow(dim, at, r)
                msgs.recv(view.shape, view.dtype, view.device, ranks[i],
                          2 * j + k, view.copy_)
    if msgs is not None:
        msgs.run()
    return shards


_LIB = "exchange_dma"
_LAUNCHER = "exchange_table_launch"
_SIGNATURE = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

#: the int64 columns of one launch-table row (``struct Entry`` of
#: ``csrc/exchange_dma.cu``): the shard's pointer, its right and left
#: neighbours' pointers, then the two slabs' geometry in units
ENTRY_FIELDS = ("src", "right", "left", "lo_src_off", "lo_dst_off",
                "lo_run", "hi_src_off", "hi_dst_off", "hi_run", "stride",
                "runs")


def widest_unit(*byte_counts: int) -> int:
    """The widest of 1, 2, 4, 8 and 16 bytes that divides every count
    (and pointer) given."""
    return math.gcd(16, *byte_counts)


def _geometry(shape: Sequence[int], itemsize: int, axis: int, r_lo: int,
              r_hi: int, unit: int) -> Dict[str, int]:
    dim = _AXIS_TO_DIM[axis]
    alloc = shape[dim]
    interior = alloc - r_lo - r_hi
    per = math.prod(shape[dim + 1:]) * itemsize // unit
    return {"unit": unit, "lo_src_off": interior * per, "lo_dst_off": 0,
            "lo_run": r_lo * per, "hi_src_off": r_lo * per,
            "hi_dst_off": (r_lo + interior) * per, "hi_run": r_hi * per,
            "stride": alloc * per, "runs": math.prod(shape[:dim])}


@dataclass(frozen=True)
class CardSweep:
    """One B4 launch: one sweep of every (quantity, shard) held on
    ``card``. ``keys[k]`` is the (quantity, shard) of table row
    ``rows[k]`` (``ENTRY_FIELDS`` order, in ``unit``-byte units);
    ``most`` is the largest slab of any row, in units."""
    card: Hashable
    unit: int
    keys: Tuple[Tuple[int, int], ...]
    rows: Tuple[Tuple[int, ...], ...]
    most: int


def plan_card_sweeps(ptrs: Sequence[Sequence[int]],
                     shapes: Sequence[Sequence[int]],
                     itemsizes: Sequence[int], cards: Sequence[Hashable],
                     axis: int, r_lo: int, r_hi: int, counts: Dim3
                     ) -> List[CardSweep]:
    """The launch tables of one sweep along grid ``axis``, one per card
    in order of first appearance: ``ptrs[q][i]`` is the pointer of shard
    i (x fastest) of quantity q, ``shapes[q]``/``itemsizes[q]`` its
    padded (Z, Y, X) shape and element bytes, ``cards[i]`` the card that
    holds shard i (of every quantity), or None where another process
    holds it (its pointers are then the IPC-mapped ones, used only as
    neighbours' targets). A card's table has one row per
    (quantity, shard) it holds, with the shard's right and left
    neighbours along ``axis`` (``mesh_neighbor``; itself on a one-shard
    axis); its unit is the widest that divides every pointer and every
    cell row of its rows. Pure: plain integers in, plain integers out."""
    counts = Dim3.of(counts)
    n = counts.flatten()
    if len(cards) != n:
        raise ValueError(f"{len(cards)} shards for a {tuple(counts)} mesh")
    dim = _AXIS_TO_DIM[axis]
    right = [mesh_neighbor(i, counts, axis, 1) for i in range(n)]
    left = [mesh_neighbor(i, counts, axis, -1) for i in range(n)]
    held: Dict[Hashable, List[Tuple[int, int]]] = {
        c: [] for c in cards if c is not None}
    for q, qp in enumerate(ptrs):
        if len(qp) != n:
            raise ValueError(f"quantity {q}: {len(qp)} shards for a "
                             f"{tuple(counts)} mesh")
        for i in range(n):
            if cards[i] is not None:
                held[cards[i]].append((q, i))
    out = []
    for card, keys in held.items():
        vals = []
        for q, i in keys:
            inner = math.prod(shapes[q][dim + 1:]) * itemsizes[q]
            vals += [inner, ptrs[q][i], ptrs[q][right[i]], ptrs[q][left[i]]]
        unit = widest_unit(*vals)
        rows = []
        most = 0
        for q, i in keys:
            shape = shapes[q]
            if math.prod(shape) * itemsizes[q] // unit >= 2 ** 31:
                raise ValueError(f"exchange_axis: a {tuple(shape)} shard of "
                                 f"{itemsizes[q]}-byte cells holds 2^31 "
                                 f"{unit}-byte units or more (32-bit "
                                 f"offsets)")
            g = _geometry(shape, itemsizes[q], axis, r_lo, r_hi, unit)
            rows.append((ptrs[q][i], ptrs[q][right[i]], ptrs[q][left[i]],
                         *(g[k] for k in ENTRY_FIELDS[3:])))
            most = max(most, g["runs"] * max(g["lo_run"], g["hi_run"]))
        out.append(CardSweep(card, unit, tuple(keys), tuple(rows), most))
    return out


Sweep = Tuple[int, int, int]     # (grid axis, r_lo, r_hi)


class ExchangePlan:
    """The B4 launches of one exchange (``sweeps`` in order over every
    quantity's shards ``fields[q][i]``), planned once per set of
    buffers: ``launches[s]`` holds sweep s's ``CardSweep`` per card. On
    CUDA shards it also enables peer access between every shard's card
    and its neighbours' and uploads each card's launch table (every
    sweep's rows, back to back) into that card's memory. ``ranks``: each
    position's owner on a mesh that spans processes (``fields[q][i]``
    None where another rank holds it); on the card the plan is then made
    collectively: the other ranks' shards are mapped (``ipc.share``) and
    ``flags`` is the mesh's ``ipc.PeerFlags`` (None in one process)."""

    def __init__(self, fields: Sequence[Sequence[torch.Tensor]],
                 sweeps: Sequence[Sweep], counts: Dim3,
                 ranks: Optional[Sequence[int]] = None) -> None:
        counts = Dim3.of(counts)
        fields = [list(s) for s in fields]
        for shards in fields:
            for axis, r_lo, r_hi in sweeps:
                _check_sweep(shards, axis, r_lo, r_hi, counts)
        devices = [None if t is None else t.device for t in fields[0]]
        for shards in fields:
            if [None if t is None else t.device for t in shards] != devices:
                raise ValueError("exchange: shard i of every quantity must "
                                 "lie on one device")
        local = [d for d in devices if d is not None]
        kinds = {d.type for d in local}
        self.cuda = kinds == {"cuda"}
        if not self.cuda and kinds != {"cpu"}:
            raise ValueError("exchange_axis_cuda: shards on "
                             f"{sorted({str(d) for d in local})}; all "
                             f"must be on CUDA devices (or all on the CPU)")
        if not all(t.is_contiguous() for s in fields for t in s
                   if t is not None):
            raise ValueError("exchange_axis_cuda: shards must be contiguous")
        self.flags = None
        self.remote_cards: Dict[int, torch.device] = {}
        if ranks is not None and self.cuda:
            ptrs = self._share(fields, ranks, devices, local[0])
        else:
            ptrs = [[t.data_ptr() for t in s] for s in fields]
        shapes = [tuple(next(t for t in s if t is not None).shape)
                  for s in fields]
        items = [next(t for t in s if t is not None).element_size()
                 for s in fields]
        self.sweeps = tuple(sweeps)
        self.cards = list(dict.fromkeys(local))
        self.launches = [plan_card_sweeps(ptrs, shapes, items, devices, a,
                                          lo, hi, counts)
                         for a, lo, hi in sweeps]
        self.tables: Dict[torch.device, torch.Tensor] = {}
        self.args: List[List[Tuple]] = []
        if self.cuda:
            self._upload(devices, counts)

    def _share(self, fields, ranks, devices, lead) -> List[List[int]]:
        """The pointers of every position's shards, the other ranks'
        mapped into this process (a collective), and the mesh's flag
        channel."""
        from ..parallel import ipc

        where = ipc.mesh_devices(devices)
        self.remote_cards = {i: where[i] for i, d in enumerate(devices)
                             if d is None}
        self.flags = ipc.channel(ranks, where)
        if _PLANS.clear not in ipc._ON_RELEASE:
            ipc.on_release(_PLANS.clear)
        got = ipc.share({("b4", q, i): t for q, s in enumerate(fields)
                         for i, t in enumerate(s)}, lead)
        return [[got[("b4", q, i)] for i in range(len(s))]
                for q, s in enumerate(fields)]

    def _upload(self, devices, counts: Dim3) -> None:
        for i, d in enumerate(devices):
            if d is None:
                continue
            for a, _, _ in self.sweeps:
                for step in (1, -1):
                    j = mesh_neighbor(i, counts, a, step)
                    enable_peer_access(d, devices[j] if devices[j] is not None
                                       else self.remote_cards[j])
        rows: Dict[torch.device, list] = {c: [] for c in self.cards}
        for per_card in self.launches:
            for cs in per_card:
                rows[cs.card] += cs.rows
        for c in self.cards:
            # queued on the current stream from pinned memory (nothing
            # waits for the card); start_sweeps orders the side stream
            # after it
            t = torch.tensor(rows[c], dtype=torch.int64).pin_memory().to(
                c, non_blocking=True)
            t.record_stream(card_stream(c))
            self.tables[c] = t
        row_bytes = 8 * len(ENTRY_FIELDS)
        offset = {c: 0 for c in self.cards}
        for per_card in self.launches:
            args = []
            for cs in per_card:
                base = self.tables[cs.card].data_ptr()
                args.append((cs.card, base + offset[cs.card] * row_bytes,
                             len(cs.rows), cs.most, cs.unit,
                             cs.card.index))
                offset[cs.card] += len(cs.rows)
            self.args.append(args)


#: plans by key (the buffers' pointers, shapes, strides and dtypes, the
#: sweeps, the mesh counts and owners), least recently used first
_PLANS: "OrderedDict[tuple, ExchangePlan]" = OrderedDict()
PLAN_CACHE_SIZE = 64


def _plan_key(fields, sweeps, counts, ranks) -> tuple:
    return (tuple(sweeps), tuple(counts), ranks,
            tuple(None if t is None else
                  (t.data_ptr(), t.shape, t.stride(), t.dtype)
                  for s in fields for t in s))


def exchange_plan(fields: Sequence[Sequence[torch.Tensor]],
                  sweeps: Sequence[Sweep], counts: Dim3,
                  ranks: Optional[Sequence[int]] = None) -> ExchangePlan:
    """The cached ``ExchangePlan`` of these buffers and sweeps: built on
    the first call for a key and whenever a buffer is replaced (a new
    pointer, shape, stride or dtype changes the key), else returned as
    it is. Across ranks every rank builds it at the same call (a
    collective): the buffers it shared stay alive until
    ``ipc.release``, so a pointer seen before names the same buffer on
    every rank, and ``release`` forgets every plan."""
    key = _plan_key(fields, sweeps, counts,
                    None if ranks is None else tuple(ranks))
    plan = _PLANS.get(key)
    if plan is not None:
        _PLANS.move_to_end(key)
        return plan
    plan = ExchangePlan(fields, sweeps, counts, ranks)
    _PLANS[key] = plan
    while len(_PLANS) > PLAN_CACHE_SIZE:
        _PLANS.popitem(last=False)
    return plan


# one side stream and two reusable events per card
_SIDE: Dict[torch.device, torch.cuda.Stream] = {}
_EVENTS: Dict[Tuple[torch.device, str], "torch.cuda.Event"] = {}


def card_stream(card: torch.device) -> "torch.cuda.Stream":
    """The stream on which card ``card`` runs B4's sweeps."""
    s = _SIDE.get(card)
    if s is None:
        s = _SIDE[card] = torch.cuda.Stream(card)
    return s


def _event(card: torch.device, what: str) -> "torch.cuda.Event":
    e = _EVENTS.get((card, what))
    if e is None:
        e = _EVENTS[(card, what)] = torch.cuda.Event()
    return e


def _record(card: torch.device, what: str, stream) -> "torch.cuda.Event":
    e = _event(card, what)
    e.record(stream)
    return e


class CardJoin:
    """The started sweeps of one exchange on the cards' side streams;
    ``exit()`` makes every card's current stream wait for them."""

    def __init__(self, cards: Sequence[torch.device]) -> None:
        self.cards = cards

    def exit(self) -> None:
        done = [_record(c, "done", card_stream(c)) for c in self.cards]
        for c in self.cards:
            cur = torch.cuda.current_stream(c)
            for e in done:
                cur.wait_event(e)


_fn = None


def _launch_card(args: Tuple, stream: "torch.cuda.Stream") -> None:
    """One B4 launch on ``stream``: ``args`` = (card, table pointer,
    rows, most, unit, device index) from ``ExchangePlan.args``."""
    global _fn
    if _fn is None:
        from . import _build

        fn = getattr(_build.load(_LIB), _LAUNCHER)
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
        _fn = fn
    err = _fn(*args[1:], stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"{_LAUNCHER} failed: CUDA error {err}")


def member_views(fields: Sequence[Sequence[torch.Tensor]]
                 ) -> List[List[torch.Tensor]]:
    """The (Z, Y, X) quantities B4 sweeps: each quantity's shards as
    they are, or, where a shard carries leading dimensions (an
    ensemble's ``(N, Zp, Yp, Xp)`` member axis), one quantity per
    member of the member views ``shard[k]`` — contiguous (Z, Y, X)
    tensors of the batched one, so N members are N more rows of the
    same launch table and the launches do not depend on N. The views
    keep the batched tensor's addresses, so the plan cache
    (``exchange_plan``) hits as long as the batched tensor is written in
    place; a batched shard must be contiguous."""
    out: List[List[torch.Tensor]] = []
    for shards in fields:
        first = next(t for t in shards if t is not None)
        if first.dim() == 3:
            out.append(list(shards))
            continue
        if not all(t.is_contiguous() for t in shards if t is not None):
            raise ValueError("exchange_axis_cuda: batched shards must be "
                             "contiguous")
        flat = [None if t is None else t.reshape((-1,) + tuple(t.shape[-3:]))
                for t in shards]
        for k in range(math.prod(first.shape[:-3])):
            out.append([None if t is None else t[k] for t in flat])
    return out


def start_sweeps(fields: Sequence[Sequence[torch.Tensor]],
                 sweeps: Sequence[Sweep], counts: Dim3,
                 ranks: Optional[Sequence[int]] = None
                 ) -> Optional[CardJoin]:
    """Queue ``sweeps`` (each (axis, r_lo, r_hi), in order) over every
    quantity's padded shards ``fields[q][i]`` in place. On CUDA: one B4
    launch per card and sweep, on the card's side stream, after the work
    already queued on the current stream of every card of the mesh
    (the previous readers of the halos about to be written, the writers
    of the slabs about to be read); with several cards, every card's
    sweep s lands before any card's sweep s+1 starts (one event per
    card). Returns the ``CardJoin`` whose ``exit()`` joins the side
    streams back. On the CPU the sweeps run at once through the twin,
    and None is returned. ``ranks``: each position's owner on a mesh
    that spans processes; each rank then sweeps its own cards, ordered
    against the other ranks' by ``ipc.b4_schedule``'s flags. A shard
    with leading dimensions (an ensemble's member axis) is swept as its
    member views (``member_views``): the same launches as one member."""
    counts = Dim3.of(counts)
    fields = member_views(fields)
    if all(t.device.type == "cpu" for s in fields for t in s
           if t is not None):
        for axis, r_lo, r_hi in sweeps:
            for shards in fields:
                exchange_axis_plain(shards, axis, r_lo, r_hi, counts, ranks)
        return None
    plan = exchange_plan(fields, sweeps, counts, ranks)
    cards = plan.cards
    ready = [_record(c, "ready", torch.cuda.current_stream(c)) for c in cards]
    for c in cards:
        side = card_stream(c)
        for e in ready:
            side.wait_event(e)
    from ..parallel import ipc

    # each card's schedule (``ipc.b4_schedule``): in one process its
    # launches alone; across ranks with the READY and SWEPT flags
    flags = plan.flags
    me = this_rank()
    remote = ({} if flags is None else
              {c: i for c, i in flags.leads.items() if c[0] != me})
    value = flags.tick(ipc.READY) if flags is not None else 0
    swept = [flags.tick(ipc.SWEPT) if flags is not None else 0
             for _ in plan.args]
    stages = {}
    for c in cards:
        key = ipc.card_key(me, c)
        own = flags.leads[key] if flags is not None else 0
        stages[c] = _stages(ipc.b4_schedule(key, {**remote, key: own},
                                            value, swept))

    def launcher(c):
        def launch(s):
            _launch_card(next(a for a in plan.args[s] if a[0] == c),
                         card_stream(c))
            LAUNCHES["exchange_axis"] += 1
        return launch

    # stage s holds sweep s on every card (across ranks a last one: the
    # closing waits)
    for s in range(len(stages[cards[0]])):
        _after_local_sweep(cards, s if s < len(plan.args) else 0)
        for c in cards:
            ipc.run_schedule(flags, stages[c][s], card_stream(c), launcher(c))
    return CardJoin(cards)


def _after_local_sweep(cards: Sequence[torch.device], s: int) -> None:
    """Before sweep ``s`` > 0 with several cards of this process: every
    card's side stream waits for every other card's sweep s - 1."""
    if not s or len(cards) < 2:
        return
    swept = [_record(c, "swept", card_stream(c)) for c in cards]
    for c in cards:
        side = card_stream(c)
        for d, e in zip(cards, swept):
            if d != c:
                side.wait_event(e)


def _stages(ops: list) -> List[list]:
    """A card's B4 schedule cut before each sweep's waits (or launch):
    stage s holds sweep s; a last stage, the waits after the last sweep.
    Every card of a rank runs stage s before any runs stage s + 1, so
    that the events between a rank's cards are recorded in order."""
    out: List[list] = [[]]
    launched = False
    for op in ops:
        if launched and op.op in ("wait", "launch"):
            out.append([])
            launched = False
        launched = launched or op.op == "launch"
        out[-1].append(op)
    return out


def exchange_axis_cuda(shards: Sequence[torch.Tensor], axis: int, r_lo: int,
                       r_hi: int, counts: Dim3) -> Sequence[torch.Tensor]:
    """B4: one sweep along grid ``axis`` over the padded shards of a
    mesh, in place — ``exchange_axis_plain``'s function, with one launch
    per card storing every shard's two slabs into its neighbours'
    tensors, joined with the cards' current streams before and after.
    Any dtype; every shard contiguous, one shape."""
    join = start_sweeps([shards], [(axis, r_lo, r_hi)], counts)
    if join is not None:
        join.exit()
    return shards
