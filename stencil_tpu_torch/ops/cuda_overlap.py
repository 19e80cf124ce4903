"""The hand-written overlapped Jacobi step (B7), with its plain twin.

PyTorch-port counterpart of ``stencil_tpu/ops/pallas_overlap.py``
``jacobi7_overlap_pallas`` (:55): one Jacobi step plus the spheres on
the interior-resident (Z, Y, X) shards of an x-unsharded mesh, where
every shard sends its four face slabs to its neighbours while its
interior is computed, and the y rows and z planes are recomputed from
the landed slabs (``csrc/jacobi_overlap.cu``: launch A sends and
computes the interior, launch B the faces).

==  ==========================================  ========================  =========================
B   TPU kernel                                  wrapper                   plain twin
==  ==========================================  ========================  =========================
B7  pallas_overlap.py:55 ``jacobi7_overlap_pallas``  ``jacobi7_overlap_cuda``  ``jacobi7_overlap_plain``
==  ==========================================  ========================  =========================

The module rules of ``ops/cuda_stencil.py`` hold: CPU shards go to the
plain twin; CUDA shards launch the kernels or raise; float32 or
bfloat16 (a bfloat16 instance of each launch that rounds after every
operation, as the JAX kernel computes a bfloat16 shard). A
step adds one to ``LAUNCHES["jacobi7_overlap"]`` per shard (its launch
A and its launch B).

Ordering on the card (``ShardOrdering``, which ``OverlapRecv`` extends
with B7's receive slabs): each shard launches on a CUDA
stream of its own (``ShardStreams``), even where
shards share a card, and two rules carried by CUDA events replace the
TPU kernel's barrier and DMA waits: (a) shard i's launch A writes into
shard j's receive slabs only after j's launch B of the previous step has
read them; (b) shard j's launch B starts only after the launch A of
every shard that writes into its slabs. A run of steps joins the shard
streams with the cards' current streams once at its start and once at
its end (``ShardOrdering.session``); a call outside a session joins
around its one step. B13/B14 (``ops/cuda_mhd_overlap.py``) share the
same ordering.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from ..geometry import Dim3
from ..parallel.mesh import mesh_neighbor
from .cuda_exchange import enable_peer_access
from .cuda_stencil import (_check, _check_cuda, _sphere_args, impose_spheres,
                           is_bf16)
from .stencil_kernels import sixth

#: steps per shard since the last ``reset_launch_counts`` (each step is
#: launch A and launch B); only a kernel launch counts, never a call
#: that went to the plain twin
LAUNCHES = {"jacobi7_overlap": 0}

SLAB_NAMES = ("zlo", "zhi", "ylo", "yhi")


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class ShardStreams:
    """One CUDA stream per shard of a mesh (``devices[i]`` holds shard
    i; a device may repeat, and each repeat gets a stream of its own;
    None where another process holds the shard, which gets none), with
    the event joins between them and the cards' current streams."""

    def __init__(self, devices: Sequence[Optional[torch.device]]) -> None:
        self.devices = [None if d is None else torch.device(d)
                        for d in devices]
        self.streams = [None if d is None else torch.cuda.Stream(d)
                        for d in self.devices]
        self.cards = list(dict.fromkeys(d for d in self.devices
                                        if d is not None))

    def __getitem__(self, i: int) -> torch.cuda.Stream:
        return self.streams[i]

    def __len__(self) -> int:
        return len(self.streams)

    def enter(self) -> None:
        """Every shard's stream waits for the work queued so far on the
        current stream of every card of the mesh."""
        events = [torch.cuda.current_stream(d).record_event()
                  for d in self.cards]
        for s in self.streams:
            if s is not None:
                for e in events:
                    s.wait_event(e)

    def exit(self) -> None:
        """The current stream of every card of the mesh waits for every
        shard's stream."""
        events = [s.record_event() for s in self.streams if s is not None]
        for d in self.cards:
            cur = torch.cuda.current_stream(d)
            for e in events:
                cur.wait_event(e)


def send_targets(i: int, counts: Dim3) -> Dict[str, int]:
    """The shard whose receive slab each of shard i's four sends fills:
    its plane Z-1 is the z+1 neighbour's ``zlo``, its plane 0 the z-1
    neighbour's ``zhi``, its row Y-1 the y+1 neighbour's ``ylo``, its
    row 0 the y-1 neighbour's ``yhi`` (itself on a one-shard axis)."""
    return {"zlo": mesh_neighbor(i, counts, 2, 1),
            "zhi": mesh_neighbor(i, counts, 2, -1),
            "ylo": mesh_neighbor(i, counts, 1, 1),
            "yhi": mesh_neighbor(i, counts, 1, -1)}


def _check_mesh(interiors: Sequence[torch.Tensor], counts: Dim3,
                what: str) -> Tuple[int, int, int]:
    if counts.x != 1:
        raise ValueError(f"{what}: x must not be sharded (mesh "
                         f"{tuple(counts)})")
    if len(interiors) != counts.flatten():
        raise ValueError(f"{what}: {len(interiors)} shards for a "
                         f"{tuple(counts)} mesh")
    held = [t for t in interiors if t is not None]
    shape, dtype = held[0].shape, held[0].dtype
    for t in held:
        _check(t, what)
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{what}: shards of {dtype} {tuple(shape)} "
                             f"and {t.dtype} {tuple(t.shape)}")
    Z, Y, X = shape
    if Z < 4 or Y < 2:
        raise ValueError(f"{what}: needs Z >= 4, Y >= 2, got {(Z, Y)}")
    return Z, Y, X


#: the ``kind`` of an event of ``ShardOrdering`` in an ordering schedule
#: (``ordering_a_schedule``): ``sent[slot]`` and ``read[slot]``, where
#: any other kind is a device-side counter of ``ipc.PeerFlags``
EV_SENT, EV_READ = "ev-sent", "ev-read"


def ordering_a_schedule(i: int, targets: Sequence[int], remote: Dict,
                        card, sent: int, read_before: int) -> List:
    """Position i's launch A as ``ShardOrdering.launch_a`` carries it
    out, a list of ``ipc.FlagOp``. Rule (a) between positions of this
    process: wait for ``read[j]`` of every other target j that is not
    ``remote`` (its launch B of the last B phase, value ``read_before``;
    none before the first); between ranks ``ipc.overlap_a_schedule``'s
    flags and launch; ``sent[i]`` recorded as ``sent`` right after the
    launch. An event's value is the phase that records it; the card
    ignores it, and ``analysis/schedule.py`` replays it."""
    from ..parallel import ipc

    ops = []
    if read_before:
        ops += [ipc.FlagOp("wait", EV_READ, j, read_before, card)
                for j in targets if j != i and j not in remote]
    for op in ipc.overlap_a_schedule(i, targets, remote, card, sent,
                                     read_before):
        ops.append(op)
        if op.op == "launch":
            ops.append(ipc.FlagOp("signal", EV_SENT, i, sent, card))
    return ops


def ordering_b_schedule(j: int, sources: Sequence[int], remote: Dict,
                        card, sent: int, read: int) -> List:
    """Position j's launch B as ``ShardOrdering.launch_b`` carries it
    out. Rule (b) between positions of this process: wait for
    ``sent[i]`` of every other source i that is not ``remote`` (its
    launch A of this phase, value ``sent``); between ranks
    ``ipc.overlap_b_schedule``'s flags and launch; ``read[j]`` recorded
    as ``read`` right after the launch."""
    from ..parallel import ipc

    ops = [ipc.FlagOp("wait", EV_SENT, i, sent, card)
           for i in sources if i != j and i not in remote]
    for op in ipc.overlap_b_schedule(j, sources, remote, card, sent, read):
        ops.append(op)
        if op.op == "launch":
            ops.append(ipc.FlagOp("signal", EV_READ, j, read, card))
    return ops


class ShardOrdering:
    """The ordering of a mesh's remote-write launches on the card: one
    CUDA stream per shard (``ShardStreams``) and the events of rules (a)
    and (b). ``targets[i]`` is the set of shards whose receive buffers
    shard i's launch A writes (itself included on a one-shard axis);
    ``sources[j]`` the shards that write into shard j's. On the CPU
    (``devices`` all CPU) it holds no streams, and only ``session``
    applies.

    ``ranks``: each position's owner on a mesh that spans processes
    (``devices[i]`` None where another rank holds the shard). This
    process then holds streams and events for its own shards only, and
    between shards of two ranks rules (a) and (b) are the device-side
    counters of the mesh's ``ipc.PeerFlags`` (``ipc.overlap_a_schedule``,
    ``ipc.overlap_b_schedule``): a launch A signals SENT to each remote
    target's card, a launch B waits for each remote source's SENT of the
    same phase and signals READ back, and the next launch A waits for
    that READ. ``begin_a`` and ``begin_b`` open each phase (one call of
    a wrapper over every shard); made collectively on the card. Both
    kinds of order are the schedules ``ordering_a_schedule`` and
    ``ordering_b_schedule`` give, which ``launch_a`` and ``launch_b``
    carry out and the schedule checker replays."""

    def __init__(self, devices: Sequence[Optional[torch.device]],
                 targets: Sequence[Sequence[int]],
                 ranks: Optional[Sequence[int]] = None) -> None:
        n = len(devices)
        self.targets = [sorted(set(t)) for t in targets]
        self.sources = [sorted({i for i in range(n) if j in self.targets[i]})
                        for j in range(n)]
        self.local = [i for i, d in enumerate(devices) if d is not None]
        self.ranks = None if ranks is None else tuple(ranks)
        self.streams: Optional[ShardStreams] = None
        self.flags = None
        self.remote: Dict[int, tuple] = {}
        self.card: Dict[int, tuple] = {}
        #: this object's SENT value of the current A phase, its READ value
        #: of the current B phase, and the B value the current A phase
        #: waits for (0 before the first B phase): the channel's ticks on
        #: a mesh that spans processes, else phase counts
        self._sent_value = self._b_value = self._read_value = 0
        self.active = False
        if torch.device(devices[self.local[0]]).type != "cuda":
            return
        self.streams = ShardStreams(devices)
        self.sent = [torch.cuda.Event() for _ in range(n)]
        self.read = [torch.cuda.Event() for _ in range(n)]
        where = devices
        if ranks is not None:
            from ..parallel import ipc

            where = ipc.mesh_devices(devices)
            self.flags = ipc.channel(ranks, where)
            self.remote = self.flags.remote()
            self.card = {i: ipc.card_key(ranks[i], where[i])
                         for i in self.local}
        for i in self.local:
            for j in self.targets[i]:
                enable_peer_access(where[i], where[j])

    def begin_a(self) -> None:
        """Open an A phase (every shard's launch A of one step)."""
        from ..parallel import ipc

        self._read_value = self._b_value
        self._sent_value = (self._sent_value + 1 if self.flags is None
                            else self.flags.tick(ipc.SENT))

    def begin_b(self) -> None:
        """Open a B phase (every shard's launch B of one step)."""
        from ..parallel import ipc

        self._b_value = (self._b_value + 1 if self.flags is None
                         else self.flags.tick(ipc.READ))

    @contextlib.contextmanager
    def session(self) -> Iterator["ShardOrdering"]:
        """A run of steps: the shard streams wait for the cards'
        current streams once at the start, and the current streams for
        the shard streams once at the end; between steps only rules (a)
        and (b) order the launches."""
        if self.streams is not None:
            self.streams.enter()
        self.active = True
        try:
            yield self
        finally:
            self.active = False
            if self.streams is not None:
                self.streams.exit()

    def _carry(self, ops, s: torch.cuda.Stream
               ) -> Iterator[torch.cuda.Stream]:
        """Carry out an ordering schedule on stream ``s``: its steps
        before the launch, then the launch (the caller's block, on
        ``s``), then its steps after."""
        k = next(n for n, op in enumerate(ops) if op.op == "launch")
        self._run(ops[:k], s)
        with torch.cuda.stream(s):
            yield s
        self._run(ops[k + 1:], s)

    def _run(self, ops, s: torch.cuda.Stream) -> None:
        from ..parallel import ipc

        for op in ops:
            if op.kind in (EV_SENT, EV_READ):
                ev = (self.sent if op.kind == EV_SENT else self.read)[op.slot]
                if op.op == "wait":
                    s.wait_event(ev)
                else:
                    ev.record(s)
            else:
                ipc.run_schedule(self.flags, [op], s)

    @contextlib.contextmanager
    def launch_a(self, i: int) -> Iterator[torch.cuda.Stream]:
        """The block launches shard i's launch A on its stream, after
        rule (a): every other target's previous launch B."""
        yield from self._carry(ordering_a_schedule(
            i, self.targets[i], self.remote, self.card.get(i),
            self._sent_value, self._read_value), self.streams[i])

    @contextlib.contextmanager
    def launch_b(self, j: int) -> Iterator[torch.cuda.Stream]:
        """The block launches shard j's launch B on its stream, after
        rule (b): the launch A of every other shard that writes into
        j."""
        yield from self._carry(ordering_b_schedule(
            j, self.sources[j], self.remote, self.card.get(j),
            self._sent_value, self._b_value), self.streams[j])

    @contextlib.contextmanager
    def own_session(self) -> Iterator[None]:
        """A session around one call, unless one is open already."""
        if self.active:
            yield
            return
        with self.session():
            yield

    def share(self, buffers: Sequence[Optional[Dict[str, torch.Tensor]]]
              ) -> List[Dict[str, int]]:
        """Per position, the pointer of each of its receive ``buffers``
        (``buffers[i]``: name -> tensor, the same names at every
        position; None where another rank holds position i): this
        process's own, or the other rank's mapped through CUDA IPC
        (``ipc.share``, a collective) on a mesh that spans processes on
        the card."""
        if self.flags is None:
            return [None if b is None else
                    {k: t.data_ptr() for k, t in b.items()} for b in buffers]
        from ..parallel import ipc

        names = sorted(next(b for b in buffers if b is not None))
        got = ipc.share({("recv", i, k): None if b is None else b[k]
                         for i, b in enumerate(buffers) for k in names},
                        self.streams[self.local[0]].device)
        return [{k: got[("recv", i, k)] for k in names}
                for i in range(len(buffers))]


class OverlapRecv(ShardOrdering):
    """The persistent receive slabs of every shard of a mesh — ``slabs[i]
    = {"zlo": (1, Y, X), "zhi": (1, Y, X), "ylo": (Z, 1, X), "yhi": (Z,
    1, X)}`` on shard i's device — and, on the card, the shards' streams
    and the events of rules (a) and (b) (``ShardOrdering``). ``ranks``:
    each position's owner on a mesh that spans processes (``interiors``
    and ``slabs`` None at the positions other ranks hold); ``ptrs[i][k]``
    is the pointer launch A stores slab k of position i through, mapped
    from its owner on the card."""

    def __init__(self, interiors: Sequence[Optional[torch.Tensor]],
                 counts: Dim3, ranks: Optional[Sequence[int]] = None
                 ) -> None:
        self.counts = Dim3.of(counts)
        Z, Y, X = _check_mesh(interiors, self.counts, "OverlapRecv")
        shapes = {"zlo": (1, Y, X), "zhi": (1, Y, X), "ylo": (Z, 1, X),
                  "yhi": (Z, 1, X)}
        self.slabs = [None if t is None else
                      {k: torch.zeros(s, dtype=t.dtype, device=t.device)
                       for k, s in shapes.items()} for t in interiors]
        self.send_to = [send_targets(i, self.counts)
                        for i in range(len(interiors))]
        super().__init__([None if t is None else t.device
                          for t in interiors],
                         [list(t.values()) for t in self.send_to], ranks)
        self.ptrs = (self.share(self.slabs) if self.streams is not None
                     else None)


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------
def gather_overlap_slabs(interiors: Sequence[Optional[torch.Tensor]],
                         counts: Dim3,
                         ranks: Optional[Sequence[int]] = None
                         ) -> List[Optional[Dict[str, torch.Tensor]]]:
    """Each shard's four landed slabs, read from its neighbours: what
    every launch A of a step leaves in the receive buffers. ``ranks``:
    each position's owner on a mesh that spans processes (``interiors``
    None at the positions other ranks hold, and so is their entry of
    the result); a slab between two ranks is a message, all in one
    batch."""
    counts = Dim3.of(counts)
    out = [None if c is None else {} for c in interiors]
    msgs = None
    if ranks is not None:
        from ..parallel.multihost import RankMessages

        msgs = RankMessages()
    held = next(c for c in interiors if c is not None)
    Z, Y, X = held.shape
    shapes = {"zlo": (1, Y, X), "zhi": (1, Y, X), "ylo": (Z, 1, X),
              "yhi": (Z, 1, X)}
    for i, c in enumerate(interiors):
        sends = (None if c is None else
                 {"zlo": c[-1:], "zhi": c[:1], "ylo": c[:, Y - 1:Y],
                  "yhi": c[:, :1]})
        for n, (k, j) in enumerate(send_targets(i, counts).items()):
            tag = 4 * j + n
            if c is not None and interiors[j] is not None:
                out[j][k] = sends[k].to(interiors[j].device, copy=True)
            elif c is not None:
                msgs.send(sends[k], ranks[j], tag)
            elif interiors[j] is not None:
                def land(buf, j=j, k=k):
                    out[j][k] = buf
                msgs.recv(shapes[k], held.dtype, interiors[j].device,
                          ranks[i], tag, land)
    if msgs is not None:
        msgs.run()
    return out


def jacobi7_overlap_shard_plain(interior: torch.Tensor,
                                slabs: Dict[str, torch.Tensor], origin_zyx,
                                hot_c, cold_c, sph_r: int) -> torch.Tensor:
    """B7's twin on one shard and its landed slabs, in the TPU kernel's
    orders: phase 3 everywhere (clamped placeholders at the faces, as
    in JAX), then the y rows of phase 5a (all z), then the z planes of
    phase 5b, then the spheres at the shard's origin (no modulo)."""
    c = interior
    Z, Y, X = c.shape
    six = sixth(c.dtype, c.device)
    zlo, zhi, ylo, yhi = (slabs[k] for k in SLAB_NAMES)
    zm = torch.cat([c[:1], c[:-1]], dim=0)
    zp = torch.cat([c[1:], c[-1:]], dim=0)
    ym = torch.cat([c[:, :1], c[:, :-1]], dim=1)
    yp = torch.cat([c[:, 1:], c[:, -1:]], dim=1)
    new = (zm + zp + ym + yp + torch.roll(c, 1, 2) + torch.roll(c, -1, 2)) \
        * six
    for row, nbr, slab in ((0, 1, ylo), (Y - 1, Y - 2, yhi)):
        r = c[:, row:row + 1]
        rzm = torch.cat([r[:1], r[:-1]], dim=0)
        rzp = torch.cat([r[1:], r[-1:]], dim=0)
        new[:, row:row + 1] = (rzm + rzp + c[:, nbr:nbr + 1] + slab
                               + torch.roll(r, 1, 2)
                               + torch.roll(r, -1, 2)) * six
    for plane, zin, zslab in ((0, 1, zlo), (Z - 1, Z - 2, zhi)):
        p = c[plane]
        pym = torch.cat([ylo[plane], p[:-1]], dim=0)
        pyp = torch.cat([p[1:], yhi[plane]], dim=0)
        new[plane] = (pym + pyp + c[zin] + zslab[0] + torch.roll(p, 1, 1)
                      + torch.roll(p, -1, 1)) * six
    return impose_spheres(new, hot_c, cold_c, sph_r,
                          origin_zyx=tuple(int(v) for v in origin_zyx))


def jacobi7_overlap_plain(interiors: Sequence[Optional[torch.Tensor]],
                          origins: Sequence, hot_c, cold_c, sph_r: int,
                          counts: Dim3,
                          ranks: Optional[Sequence[int]] = None
                          ) -> Tuple[List[Optional[torch.Tensor]],
                                     List[Optional[Dict[str, torch.Tensor]]]]:
    """B7's twin over every shard of the mesh: (new shards, each shard's
    landed slabs); None at the positions other ranks hold (``ranks``,
    ``gather_overlap_slabs``)."""
    slabs = gather_overlap_slabs(interiors, counts, ranks)
    return ([None if c is None else
             jacobi7_overlap_shard_plain(c, s, o, hot_c, cold_c, sph_r)
             for c, s, o in zip(interiors, slabs, origins)], slabs)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------
_LIB = "jacobi_overlap"
_SIGNATURE = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p]


def jacobi7_overlap_cuda(interiors: Sequence[torch.Tensor], origins: Sequence,
                         hot_c, cold_c, sph_r: int, counts: Dim3,
                         out: Optional[Sequence[torch.Tensor]] = None,
                         recv: Optional[OverlapRecv] = None,
                         ranks: Optional[Sequence[int]] = None
                         ) -> Tuple[List[torch.Tensor], OverlapRecv]:
    """B7: one overlapped Jacobi step plus the spheres on every (Z, Y,
    X) float32 or bfloat16 shard of an x-unsharded mesh (``interiors[i]``
    at global origin ``origins[i]`` = (z, y, x), x fastest), Z >= 4, Y >=
    2.
    ``out``: the shards' output tensors (not aliasing the inputs);
    ``recv``: the mesh's persistent ``OverlapRecv`` (made here if None,
    with ``ranks``). Returns (out, recv); ``recv.slabs`` then hold the
    landed slabs. On a mesh that spans processes (``recv.ranks``) the
    shards, ``out`` and the result are None at the positions other
    ranks hold; launch A stores into their receive slabs through CUDA
    IPC, and each rank counts its own shards' launches."""
    what = "jacobi7_overlap_cuda"
    counts = Dim3.of(counts)
    arrs = list(interiors)
    Z, Y, X = _check_mesh(arrs, counts, what)
    if out is None:
        out = [None if t is None else torch.empty_like(t) for t in arrs]
    out = list(out)
    for t, o in zip(arrs, out):
        if t is None:
            continue
        if (o.shape != t.shape or o.dtype != t.dtype or o.device != t.device
                or not o.is_contiguous() or o.data_ptr() == t.data_ptr()):
            raise ValueError(f"{what}: out must be contiguous {t.dtype} "
                             f"tensors of the shards' shape and devices, "
                             f"not aliasing them")
    if recv is None:
        recv = OverlapRecv(arrs, counts, ranks)
    own = recv.local
    if all(arrs[i].device.type == "cpu" for i in own):
        new, slabs = jacobi7_overlap_plain(arrs, origins, hot_c, cold_c,
                                           sph_r, counts, recv.ranks)
        for i in own:
            out[i].copy_(new[i])
            for k in SLAB_NAMES:
                recv.slabs[i][k].copy_(slabs[i][k])
        return out, recv
    for i in own:
        _check_cuda(arrs[i], what)
        _check_cuda(out[i], what)
    if recv.streams is None or recv.counts != counts:
        raise ValueError(f"{what}: recv was made for another mesh")
    from . import _build

    spheres = (*_sphere_args(hot_c, cold_c, sph_r), is_bf16(arrs[own[0]]))
    orgs = [tuple(int(v) for v in o) for o in origins]
    with recv.own_session():
        # launch A: sends and the interior, after rule (a)
        recv.begin_a()
        for i in own:
            t = arrs[i]
            tg = recv.send_to[i]
            with recv.launch_a(i):
                _build.launch(_LIB, "jacobi7_overlap_inner_launch",
                              _SIGNATURE, t.device, t.data_ptr(),
                              out[i].data_ptr(),
                              *(recv.ptrs[tg[k]][k] for k in SLAB_NAMES),
                              Z, Y, X, *orgs[i], *spheres)
        # launch B: the faces, after rule (b)
        recv.begin_b()
        for j in own:
            t = arrs[j]
            with recv.launch_b(j):
                _build.launch(_LIB, "jacobi7_overlap_faces_launch",
                              _SIGNATURE, t.device, t.data_ptr(),
                              out[j].data_ptr(),
                              *(recv.slabs[j][k].data_ptr()
                                for k in SLAB_NAMES), Z, Y, X, *orgs[j],
                              *spheres)
    LAUNCHES["jacobi7_overlap"] += len(own)
    return out, recv
