"""The hand-written remote-write halo exchange (B4), with its plain twin,
and the per-shard CUDA streams that order remote writes.

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
plain twin; CUDA shards launch the kernel (one launch per shard, each
adding one to ``LAUNCHES["exchange_axis"]``) or raise — a shard whose
card cannot reach a neighbour's card raises too, and nothing is ever
staged through the host or handed to ``copy_`` instead.

Ordering. The TPU kernel meets its neighbours at a semaphore barrier
before it writes. On the card every shard launches on a CUDA stream of
its own (``ShardStreams``; shards that share a card get distinct
streams, so the ordering below is real there too), and events between
those streams carry the barrier's meaning: ``enter`` makes each shard's
stream wait for the work already queued on the current stream of every
card of the mesh (the previous readers of the halos about to be
written, and the writers of the slabs about to be read), ``join``
makes every shard's stream wait for every other's work so far, and
``exit`` makes each card's current stream wait for every shard's
stream. No kernel waits on a flag another launch sets.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from ..geometry import Dim3
from ..parallel.mesh import mesh_neighbor

#: launches per wrapper since the last ``reset_launch_counts``; only a
#: kernel launch counts, never a call that went to the plain twin
LAUNCHES = {"exchange_axis": 0}

# grid axis index -> tensor dimension of a (z,y,x)-ordered shard
_AXIS_TO_DIM = {0: 2, 1: 1, 2: 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# per-shard streams and the peer-access helper
# ---------------------------------------------------------------------------
class ShardStreams:
    """One CUDA stream per shard of a mesh (``devices[i]`` holds shard
    i; a device may repeat, and each repeat gets a stream of its own),
    with the event joins between them and the cards' current streams."""

    def __init__(self, devices: Sequence[torch.device]) -> None:
        self.devices = [torch.device(d) for d in devices]
        self.streams = [torch.cuda.Stream(d) for d in self.devices]
        self.cards = list(dict.fromkeys(self.devices))

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
            for e in events:
                s.wait_event(e)

    def join(self) -> None:
        """Every shard's stream waits for every shard's work so far."""
        events = [s.record_event() for s in self.streams]
        for i, s in enumerate(self.streams):
            for j, e in enumerate(events):
                if j != i:
                    s.wait_event(e)

    def exit(self) -> None:
        """The current stream of every card of the mesh waits for every
        shard's stream."""
        events = [s.record_event() for s in self.streams]
        for d in self.cards:
            cur = torch.cuda.current_stream(d)
            for e in events:
                cur.wait_event(e)


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
    shape, dtype = arrs[0].shape, arrs[0].dtype
    for t in arrs:
        if t.shape != shape or t.dtype != dtype or t.dim() != 3:
            raise ValueError("exchange_axis: every shard must be a padded "
                             "(Z, Y, X) tensor of one shape and dtype")
    interior = shape[_AXIS_TO_DIM[axis]] - r_lo - r_hi
    if min(r_lo, r_hi) < 0 or interior < max(r_lo, r_hi, 1):
        raise ValueError(f"exchange_axis: axis {axis} of {tuple(shape)} "
                         f"cannot carry halos ({r_lo}, {r_hi})")
    return arrs


def exchange_axis_plain(shards: Sequence[torch.Tensor], axis: int,
                        r_lo: int, r_hi: int, counts: Dim3
                        ) -> Sequence[torch.Tensor]:
    """B4's twin: one sweep along grid ``axis`` (0 x, 1 y, 2 z) over the
    padded (z,y,x) shards of a mesh (x fastest), in place: shard i's
    right neighbour's lo halo ``[0, r_lo)`` <- its ``[interior, r_lo +
    interior)``, its left neighbour's hi halo ``[r_lo + interior,
    alloc)`` <- its ``[r_lo, r_lo + r_hi)``, full cross sections
    (pallas_exchange.py:84-109). Every source is interior and every
    destination halo, so the copies may run in any order."""
    counts = Dim3.of(counts)
    arrs = _check_sweep(shards, axis, r_lo, r_hi, counts)
    dim = _AXIS_TO_DIM[axis]
    interior = arrs[0].shape[dim] - r_lo - r_hi
    for i, src in enumerate(arrs):
        if r_lo:
            right = arrs[mesh_neighbor(i, counts, axis, 1)]
            right.narrow(dim, 0, r_lo).copy_(src.narrow(dim, interior, r_lo))
        if r_hi:
            left = arrs[mesh_neighbor(i, counts, axis, -1)]
            left.narrow(dim, r_lo + interior, r_hi).copy_(
                src.narrow(dim, r_lo, r_hi))
    return shards


_LIB = "exchange_dma"
_LL = ctypes.c_longlong
_SIGNATURE = ([ctypes.c_void_p] * 3 + [_LL] * 8 + [ctypes.c_int]
              + [ctypes.c_void_p])


def sweep_geometry(shape: Sequence[int], itemsize: int, axis: int,
                   r_lo: int, r_hi: int, ptrs: Sequence[int] = ()
                   ) -> Dict[str, int]:
    """The kernel's view of one sweep of a padded ``shape``: the unit
    (the widest of 1, 2, 4, 8, 16 bytes that divides the bytes of one
    cell row across the swept axis, and so every run, offset and
    stride, and every pointer), and in units the two slabs' source and
    destination offsets and run lengths, the stride between runs and
    the number of runs."""
    dim = _AXIS_TO_DIM[axis]
    alloc = shape[dim]
    interior = alloc - r_lo - r_hi
    runs = math.prod(shape[:dim])
    inner = math.prod(shape[dim + 1:]) * itemsize
    g = math.gcd(16, inner, *ptrs)
    unit = 1 << (g.bit_length() - 1)
    per = inner // unit
    return {"unit": unit, "lo_src_off": interior * per, "lo_dst_off": 0,
            "lo_run": r_lo * per, "hi_src_off": r_lo * per,
            "hi_dst_off": (r_lo + interior) * per, "hi_run": r_hi * per,
            "stride": alloc * per, "runs": runs}


def exchange_axis_cuda(shards: Sequence[torch.Tensor], axis: int, r_lo: int,
                       r_hi: int, counts: Dim3,
                       streams: Optional[ShardStreams] = None
                       ) -> Sequence[torch.Tensor]:
    """B4: one sweep along grid ``axis`` over the padded shards of a
    mesh, in place — ``exchange_axis_plain``'s function, with every
    shard's kernel storing both its slabs into its neighbours' tensors.
    On CUDA shard i launches on ``streams[i]``; with no ``streams`` the
    sweep makes its own and joins them with the cards' current streams
    before and after (a caller that runs several sweeps passes one
    ``ShardStreams`` and joins them itself). Any dtype; every shard
    contiguous, one shape."""
    counts = Dim3.of(counts)
    arrs = _check_sweep(shards, axis, r_lo, r_hi, counts)
    if all(t.device.type == "cpu" for t in arrs):
        return exchange_axis_plain(arrs, axis, r_lo, r_hi, counts)
    if not all(t.is_cuda for t in arrs):
        raise ValueError("exchange_axis_cuda: shards on "
                         f"{sorted({str(t.device) for t in arrs})}; all "
                         f"must be on CUDA devices (or all on the CPU)")
    if not all(t.is_contiguous() for t in arrs):
        raise ValueError("exchange_axis_cuda: shards must be contiguous")
    from . import _build

    own = streams is None
    if own:
        streams = ShardStreams([t.device for t in arrs])
        streams.enter()
    geo = sweep_geometry(arrs[0].shape, arrs[0].element_size(), axis,
                         r_lo, r_hi, [t.data_ptr() for t in arrs])
    for i, src in enumerate(arrs):
        right = arrs[mesh_neighbor(i, counts, axis, 1)]
        left = arrs[mesh_neighbor(i, counts, axis, -1)]
        enable_peer_access(src.device, right.device)
        enable_peer_access(src.device, left.device)
        with torch.cuda.stream(streams[i]):
            _build.launch(_LIB, "exchange_axis_launch", _SIGNATURE,
                          src.device, src.data_ptr(), right.data_ptr(),
                          left.data_ptr(), geo["lo_src_off"],
                          geo["lo_dst_off"], geo["lo_run"],
                          geo["hi_src_off"], geo["hi_dst_off"],
                          geo["hi_run"], geo["stride"], geo["runs"],
                          geo["unit"])
        LAUNCHES["exchange_axis"] += 1
    if own:
        streams.exit()
    return shards
