"""Stores into another process's card memory, and their ordering.

The cross-process mechanism of the remote-write kernels (B4, B7, B13/
B14) on a mesh that spans ranks. There is no JAX module to mirror: on a
TPU, ``pltpu.make_async_remote_copy`` writes into the neighbour chip's
memory over the ICI and a semaphore tells the neighbour it has landed,
whichever process owns that chip. On the card the same two things are
CUDA IPC and device-side counters (``csrc/ipc.cu``):

* **Buffer sharing** (``share``, a collective). A rank exports the
  buffers its neighbours must write into: the ``cudaIpcGetMemHandle``
  handle of each buffer's ``cudaMalloc`` block and the buffer's offset in
  it travel through the process group (``all_gather_object``); every
  other rank maps each block once (``cudaIpcOpenMemHandle``), cached by
  (rank, handle), and adds the offset. A mapped pointer is an ordinary
  device pointer, so the kernels store through it unchanged. The
  exporter keeps every exported tensor alive, so that the caching
  allocator never hands its block to another tensor while another
  process may store into it, until ``release`` (a collective): every
  rank closes its mappings, the ranks meet at a barrier, and only then
  drop the exported tensors and what was planned on the mappings.
* **Flags** (``PeerFlags``, one channel a mesh). On every card that
  holds a position of this rank, a zeroed array of ``KINDS x n`` 32-bit
  counters, shared like a buffer. Counter (kind, p) of a card's array is
  written only by the stream that runs position p's work (for B4, the
  first position a card holds stands for the card), with
  ``cuStreamWriteValue32`` after that stream's launch — whose default
  form fences the launch's stores first —, and read only by streams of
  that card, with ``cuStreamWaitValue32`` (``GEQ``). Values come from
  per-kind tick counters that every rank advances in the same program
  order, so they agree across ranks without a message; they only grow,
  so no wait is ever satisfied by an earlier step's signal. The
  schedules (``b4_schedule``, ``overlap_a_schedule``,
  ``overlap_b_schedule``) are pure: they say which counter each card
  signals and waits for, and ``run_schedule`` carries them out on a
  stream.

Refusals, never fallbacks: a card without stream memory operations, or
PyTorch's ``expandable_segments`` allocator (whose blocks
``cudaIpcGetMemHandle`` cannot name), raises here; nothing is ever
staged through the host instead. On CPU shards this module is not used:
the CPU paths move the same slabs through ``multihost.RankMessages``.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Dict, Hashable, Iterable, List, Optional, Sequence, Tuple

import torch

from .mesh import this_rank

_LIB = "ipc"
_NO_ENTRY = -1000000

#: the counter kinds: B4's "my halos may be written" (READY) and "my
#: sweep has landed" (SWEPT), a card's lead position signalling; B7's and
#: B13's "my launch A has stored" (SENT) and "my launch B has read my
#: receive buffers" (READ), a position signalling
READY, SWEPT, SENT, READ = range(4)
KINDS = 4

_fns: Dict[str, object] = {}

#: flag operations queued and blocks mapped by this process (what a run
#: reads to show which cross-process path it took)
STATS = {"signals": 0, "waits": 0, "mapped": 0}

#: tensors this process exported, by pointer, alive until ``release``
_EXPORTED: Dict[int, torch.Tensor] = {}
#: this process's mappings of other processes' blocks: (rank, handle)
#: -> the block's base in this process
_OPENED: Dict[Tuple[int, bytes], int] = {}
#: flag channels by mesh (``channel``)
_CHANNELS: Dict[tuple, "PeerFlags"] = {}
#: what ``release`` must forget besides (plan caches holding mapped
#: pointers), each a callable
_ON_RELEASE: List = []


def _fn(name: str, argtypes):
    f = _fns.get(name)
    if f is None:
        from ..ops import _build

        f = getattr(_build.load(_LIB), name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _fns[name] = f
    return f


def _check(err: int, what: str) -> None:
    if err == 0:
        return
    if err == _NO_ENTRY:
        raise RuntimeError(f"{what}: the CUDA driver does not export it")
    if err < 0:
        raise RuntimeError(f"{what} failed: CUDA driver error {-err}")
    raise RuntimeError(f"{what} failed: CUDA error {err}")


def check_allocator() -> None:
    """Raise when PyTorch's caching allocator runs with
    ``expandable_segments``: its blocks are not ``cudaMalloc`` blocks,
    and ``cudaIpcGetMemHandle`` cannot name them."""
    conf = ",".join(os.environ.get(k, "") for k in
                    ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"))
    if "expandable_segments:true" in conf.replace(" ", "").lower():
        raise RuntimeError(
            "CUDA IPC cannot share buffers of the expandable_segments "
            "allocator (PYTORCH_CUDA_ALLOC_CONF names it); unset it to run "
            "the remote-write paths on a mesh that spans processes")


_MEM_OPS: Dict[int, Tuple[int, int]] = {}
_MEM_OPS_OK: set = set()


def stream_mem_ops(device) -> Tuple[int, int]:
    """The card's v1 stream-memory-operation attributes, (32-bit,
    64-bit): ``CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_MEM_OPS_V1`` and its
    64-bit twin (92, 93). They describe the deprecated v1 entry points:
    a driver that runs the v2 operations by default may report 0 here,
    so ``check_stream_mem_ops`` tries the operations themselves."""
    idx = torch.device(device).index
    got = _MEM_OPS.get(idx)
    if got is None:
        a, b = ctypes.c_int(0), ctypes.c_int(0)
        fn = _fn("stream_mem_ops", [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)])
        _check(fn(idx, ctypes.byref(a), ctypes.byref(b)),
               "cuDeviceGetAttribute")
        got = _MEM_OPS[idx] = (a.value, b.value)
    return got


def check_stream_mem_ops(device) -> None:
    """Raise unless card ``device`` runs 32-bit stream memory operations:
    a ``cuStreamWriteValue32`` of 1 and a ``cuStreamWaitValue32`` (GEQ
    1) on a counter of the card, on a stream of its own, must both be
    accepted and leave the counter at 1. The flags are written and
    waited for on the device, and the port never turns them into a host
    barrier."""
    device = torch.device(device)
    if device.index in _MEM_OPS_OK:
        return
    write = _fn("flag_write", [ctypes.c_void_p, ctypes.c_ulonglong,
                               ctypes.c_uint])
    wait = _fn("flag_wait", [ctypes.c_void_p, ctypes.c_ulonglong,
                             ctypes.c_uint])
    counter = torch.zeros(1, dtype=torch.int32, device=device)
    s = torch.cuda.Stream(device)
    s.wait_stream(torch.cuda.current_stream(device))
    errs = (write(s.cuda_stream, counter.data_ptr(), 1),
            wait(s.cuda_stream, counter.data_ptr(), 1))
    s.synchronize()
    if any(errs) or int(counter.item()) != 1:
        raise RuntimeError(
            f"{device} does not run stream memory operations "
            f"(cuStreamWriteValue32/cuStreamWaitValue32 returned {errs}, "
            f"counter {int(counter.item())}; v1 attributes "
            f"{stream_mem_ops(device)}): the remote-write paths across "
            f"processes order their stores with them")
    _MEM_OPS_OK.add(device.index)


def export(t: torch.Tensor) -> Tuple[bytes, int]:
    """(IPC handle of the block holding ``t``, ``t``'s byte offset in
    it); ``t`` stays alive until ``release``."""
    check_allocator()
    h = ctypes.create_string_buffer(64)
    off = ctypes.c_longlong(0)
    fn = _fn("ipc_export", [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_longlong)])
    with torch.cuda.device(t.device):
        _check(fn(t.data_ptr(), h, ctypes.byref(off)), "cudaIpcGetMemHandle")
    _EXPORTED[t.data_ptr()] = t
    return h.raw, off.value


def open_block(rank: int, handle: bytes, device) -> int:
    """The base, in this process, of the block ``rank`` exported as
    ``handle``: mapped into card ``device`` at the first call, then
    cached (a block may be opened once a process)."""
    key = (rank, handle)
    base = _OPENED.get(key)
    if base is None:
        p = ctypes.c_void_p()
        fn = _fn("ipc_open", [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)])
        with torch.cuda.device(device):
            _check(fn(handle, ctypes.byref(p)), "cudaIpcOpenMemHandle")
        base = _OPENED[key] = p.value
        STATS["mapped"] += 1
    return base


def share(tensors: Dict[Hashable, Optional[torch.Tensor]], device
          ) -> Dict[Hashable, int]:
    """A collective over the process group: every rank names the same
    keys, with its own tensors and None where another rank owns the
    buffer. Returns, per key, a pointer this process can store through:
    its own tensor's ``data_ptr``, or the other rank's buffer mapped
    into card ``device``. Each rank's own tensors are synchronized
    first, so that nothing queued on them (a zeroing) can land after a
    peer's store."""
    from .multihost import all_gather_objects

    me = this_rank()
    mine = {k: t for k, t in tensors.items() if t is not None}
    for d in {t.device for t in mine.values()}:
        torch.cuda.synchronize(d)
    exported = {k: export(t) for k, t in mine.items()}
    out = {k: t.data_ptr() for k, t in mine.items()}
    for rank, got in enumerate(all_gather_objects(exported)):
        if rank == me:
            continue
        for k, (h, off) in got.items():
            if k in tensors and tensors[k] is None:
                out[k] = open_block(rank, h, device) + off
    missing = [k for k in tensors if k not in out]
    if missing:
        raise ValueError(f"share: no rank holds {missing[:4]}")
    return out


def mesh_devices(devices: Sequence[Optional[torch.device]]
                 ) -> List[torch.device]:
    """Every position's device: ``devices[i]`` where this process holds
    position i, its owner's where ``devices[i]`` is None (a
    collective)."""
    from .multihost import all_gather_objects

    held = {i: str(d) for i, d in enumerate(devices) if d is not None}
    where: Dict[int, str] = {}
    for got in all_gather_objects(held):
        where.update(got)
    return [torch.device(where[i]) for i in range(len(devices))]


def release() -> None:
    """A collective: close every mapping of another process's block,
    meet the other ranks at a barrier, then drop the exported tensors,
    the flag channels and every plan built on mapped pointers. Call it
    before the buffers of a remote-write path go away; at process exit
    the driver closes what is left."""
    import torch.distributed as dist

    if _OPENED or _EXPORTED:
        torch.cuda.synchronize()
    fn = _fn("ipc_close", [ctypes.c_void_p]) if _OPENED else None
    for base in _OPENED.values():
        _check(fn(base), "cudaIpcCloseMemHandle")
    _OPENED.clear()
    dist.barrier()
    _EXPORTED.clear()
    _CHANNELS.clear()
    for forget in _ON_RELEASE:
        forget()


def on_release(forget) -> None:
    """Have ``release`` call ``forget()`` (a cache of mapped pointers)."""
    _ON_RELEASE.append(forget)


# ---------------------------------------------------------------------------
# the flag schedules (pure)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FlagOp:
    """One step of a stream's flag schedule: ``op`` "signal" (write
    ``value`` into counter (``kind``, ``slot``) of card ``card``'s array),
    "wait" (hold the stream until that counter of its own card ``card``
    is at least ``value``) or "launch" (``slot`` is the sweep or the
    position launched; kind and card unused)."""
    op: str
    kind: int
    slot: int
    value: int
    card: Hashable


def b4_schedule(me: Hashable, leads: Dict[Hashable, int], ready: int,
                swept: Sequence[int]) -> List[FlagOp]:
    """B4's flag schedule for card ``me`` in one exchange: ``leads``
    maps every card of the mesh that another rank drives to the lead
    position that stands for it, and ``me`` to its own; ``ready`` is the
    exchange's READY value, ``swept[s]`` sweep s's SWEPT value. The card
    signals READY (its previous readers of its halos are done) and waits
    for every other card's; before sweep s + 1 it waits for every other
    card's sweep s; after the last it waits for it again, so that the
    work queued after the exchange sees every store into its halos."""
    others = sorted((c for c in leads if c != me), key=str)
    own = leads[me]
    ops = [FlagOp("signal", READY, own, ready, c) for c in others]
    ops += [FlagOp("wait", READY, leads[c], ready, me) for c in others]
    for s, v in enumerate(swept):
        if s:
            ops += [FlagOp("wait", SWEPT, leads[c], swept[s - 1], me)
                    for c in others]
        ops.append(FlagOp("launch", -1, s, 0, me))
        ops += [FlagOp("signal", SWEPT, own, v, c) for c in others]
    if swept:
        ops += [FlagOp("wait", SWEPT, leads[c], swept[-1], me)
                for c in others]
    return ops


def overlap_a_schedule(i: int, targets: Iterable[int], remote: Dict[int,
                       Hashable], card: Hashable, sent: int, read_before: int
                       ) -> List[FlagOp]:
    """Position i's launch A (B7, B13) with its cross-rank flags:
    ``remote`` maps each position another rank drives to its card. Rule
    (a): before storing into a remote target j's receive buffers, wait
    until j's launch B has read them ``read_before`` times (every B
    phase so far; none before the first); after the launch, signal SENT
    = ``sent`` (this A phase) to each remote target's card, once a
    card."""
    tg = sorted({j for j in targets if j in remote})
    ops = []
    if read_before:
        ops += [FlagOp("wait", READ, j, read_before, card) for j in tg]
    ops.append(FlagOp("launch", -1, i, 0, card))
    ops += [FlagOp("signal", SENT, i, sent, c)
            for c in sorted({remote[j] for j in tg}, key=str)]
    return ops


def overlap_b_schedule(j: int, sources: Iterable[int], remote: Dict[int,
                       Hashable], card: Hashable, sent: int, read: int
                       ) -> List[FlagOp]:
    """Position j's launch B with its cross-rank flags. Rule (b): wait
    until every remote source i's launch A of this phase (SENT =
    ``sent``) has stored into j's buffers; after the launch, signal READ
    = ``read`` (this B phase) to each remote source's card, once a
    card."""
    src = sorted({i for i in sources if i in remote})
    ops = [FlagOp("wait", SENT, i, sent, card) for i in src]
    ops.append(FlagOp("launch", -1, j, 0, card))
    ops += [FlagOp("signal", READ, j, read, c)
            for c in sorted({remote[i] for i in src}, key=str)]
    return ops


# ---------------------------------------------------------------------------
# the flag channel of a mesh
# ---------------------------------------------------------------------------
def card_key(rank: int, device) -> Tuple[int, str]:
    return (int(rank), str(torch.device(device)))


class PeerFlags:
    """The counters of one mesh (``ranks[i]``, ``devices[i]``: position
    i's owner and card): a zeroed int32 array of ``KINDS x n`` counters
    on every card of this rank, shared with the others (``share``), and
    the per-kind ticks. Made collectively (``channel``)."""

    def __init__(self, ranks: Sequence[int], devices: Sequence) -> None:
        me = this_rank()
        self.n = len(ranks)
        self.ranks = tuple(ranks)
        self.cards = [card_key(r, d) for r, d in zip(ranks, devices)]
        local = {c: torch.device(d) for c, d in zip(self.cards, devices)
                 if c[0] == me}
        for d in local.values():
            check_stream_mem_ops(d)
        self.lead_device = next(iter(local.values()))
        arrays = {c: torch.zeros(KINDS * self.n, dtype=torch.int32, device=d)
                  for c, d in local.items()}
        #: each card's first position, which stands for it in B4's flags
        self.leads: Dict[Hashable, int] = {}
        for i, c in enumerate(self.cards):
            self.leads.setdefault(c, i)
        self.ptr = share({("flags",) + c: arrays.get(c)
                          for c in self.leads}, self.lead_device)
        self.ticks = [0] * KINDS

    def tick(self, kind: int) -> int:
        """The next value of ``kind`` (every rank calls this in the same
        order, so the values agree)."""
        self.ticks[kind] += 1
        return self.ticks[kind]

    def remote(self) -> Dict[int, Hashable]:
        """Each position another rank drives, with its card."""
        me = this_rank()
        return {i: c for i, c in enumerate(self.cards) if c[0] != me}

    def addr(self, card: Hashable, kind: int, slot: int) -> int:
        """The device address of counter (``kind``, ``slot``) of
        ``card``'s array, in this process."""
        return self.ptr[("flags",) + card] + 4 * (kind * self.n + slot)


def run_schedule(flags: Optional[PeerFlags], ops: Sequence[FlagOp], stream,
                 launch=None) -> None:
    """Carry out a schedule on ``stream`` (a stream of the card its
    waits name): ``launch(slot)`` queues each "launch" step, and the
    mesh's ``flags`` address its signals and waits (a schedule without
    either, one process's, needs no flags)."""
    for op in ops:
        if op.op == "launch":
            launch(op.slot)
            continue
        name = "flag_write" if op.op == "signal" else "flag_wait"
        fn = _fn(name, [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_uint])
        _check(fn(stream.cuda_stream, flags.addr(op.card, op.kind, op.slot),
                  op.value), "cuStreamWriteValue32" if op.op == "signal"
               else "cuStreamWaitValue32")
        STATS["signals" if op.op == "signal" else "waits"] += 1


def channel(ranks: Sequence[int], devices: Sequence) -> PeerFlags:
    """The flag channel of a mesh, made at its first use (a collective:
    every rank of the mesh reaches it at the same point)."""
    key = (tuple(ranks), tuple(str(torch.device(d)) for d in devices))
    got = _CHANNELS.get(key)
    if got is None:
        got = _CHANNELS[key] = PeerFlags(ranks, devices)
    return got
