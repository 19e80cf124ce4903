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

    def exit(self) -> None:
        """The current stream of every card of the mesh waits for every
        shard's stream."""
        events = [s.record_event() for s in self.streams]
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
    shape, dtype = interiors[0].shape, interiors[0].dtype
    for t in interiors:
        _check(t, what)
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{what}: shards of {dtype} {tuple(shape)} "
                             f"and {t.dtype} {tuple(t.shape)}")
    Z, Y, X = shape
    if Z < 4 or Y < 2:
        raise ValueError(f"{what}: needs Z >= 4, Y >= 2, got {(Z, Y)}")
    return Z, Y, X


class ShardOrdering:
    """The ordering of a mesh's remote-write launches on the card: one
    CUDA stream per shard (``ShardStreams``) and the events of rules (a)
    and (b). ``targets[i]`` is the set of shards whose receive buffers
    shard i's launch A writes (itself included on a one-shard axis);
    ``sources[j]`` the shards that write into shard j's. On the CPU
    (``devices`` all CPU) it holds no streams, and only ``session``
    applies."""

    def __init__(self, devices: Sequence[torch.device],
                 targets: Sequence[Sequence[int]]) -> None:
        n = len(devices)
        self.targets = [sorted(set(t)) for t in targets]
        self.sources = [sorted({i for i in range(n) if j in self.targets[i]})
                        for j in range(n)]
        self.streams: Optional[ShardStreams] = None
        self.active = False
        if torch.device(devices[0]).type == "cuda":
            self.streams = ShardStreams(devices)
            self.sent = [torch.cuda.Event() for _ in range(n)]
            self.read = [torch.cuda.Event() for _ in range(n)]
            self._read_recorded = [False] * n
            for i, d in enumerate(devices):
                for j in self.targets[i]:
                    enable_peer_access(d, devices[j])

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

    @contextlib.contextmanager
    def launch_a(self, i: int) -> Iterator[torch.cuda.Stream]:
        """The block launches shard i's launch A on its stream, after
        rule (a): every other target's previous launch B."""
        s = self.streams[i]
        for j in self.targets[i]:
            if j != i and self._read_recorded[j]:
                s.wait_event(self.read[j])
        with torch.cuda.stream(s):
            yield s
        self.sent[i].record(s)

    @contextlib.contextmanager
    def launch_b(self, j: int) -> Iterator[torch.cuda.Stream]:
        """The block launches shard j's launch B on its stream, after
        rule (b): the launch A of every other shard that writes into
        j."""
        s = self.streams[j]
        for i in self.sources[j]:
            if i != j:
                s.wait_event(self.sent[i])
        with torch.cuda.stream(s):
            yield s
        self.read[j].record(s)
        self._read_recorded[j] = True

    @contextlib.contextmanager
    def own_session(self) -> Iterator[None]:
        """A session around one call, unless one is open already."""
        if self.active:
            yield
            return
        with self.session():
            yield


class OverlapRecv(ShardOrdering):
    """The persistent receive slabs of every shard of a mesh — ``slabs[i]
    = {"zlo": (1, Y, X), "zhi": (1, Y, X), "ylo": (Z, 1, X), "yhi": (Z,
    1, X)}`` on shard i's device — and, on the card, the shards' streams
    and the events of rules (a) and (b) (``ShardOrdering``)."""

    def __init__(self, interiors: Sequence[torch.Tensor], counts: Dim3
                 ) -> None:
        self.counts = Dim3.of(counts)
        Z, Y, X = _check_mesh(interiors, self.counts, "OverlapRecv")
        shapes = {"zlo": (1, Y, X), "zhi": (1, Y, X), "ylo": (Z, 1, X),
                  "yhi": (Z, 1, X)}
        self.slabs = [{k: torch.zeros(s, dtype=t.dtype, device=t.device)
                       for k, s in shapes.items()} for t in interiors]
        self.send_to = [send_targets(i, self.counts)
                        for i in range(len(interiors))]
        super().__init__([t.device for t in interiors],
                         [list(t.values()) for t in self.send_to])


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------
def gather_overlap_slabs(interiors: Sequence[torch.Tensor], counts: Dim3
                         ) -> List[Dict[str, torch.Tensor]]:
    """Each shard's four landed slabs, read from its neighbours: what
    every launch A of a step leaves in the receive buffers."""
    counts = Dim3.of(counts)
    out = [{} for _ in interiors]
    for i, c in enumerate(interiors):
        Y = c.shape[1]
        sends = {"zlo": c[-1:], "zhi": c[:1], "ylo": c[:, Y - 1:Y],
                 "yhi": c[:, :1]}
        for k, j in send_targets(i, counts).items():
            out[j][k] = sends[k].to(interiors[j].device, copy=True)
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


def jacobi7_overlap_plain(interiors: Sequence[torch.Tensor],
                          origins: Sequence, hot_c, cold_c, sph_r: int,
                          counts: Dim3
                          ) -> Tuple[List[torch.Tensor],
                                     List[Dict[str, torch.Tensor]]]:
    """B7's twin over every shard of the mesh: (new shards, each shard's
    landed slabs)."""
    slabs = gather_overlap_slabs(interiors, counts)
    return ([jacobi7_overlap_shard_plain(c, s, o, hot_c, cold_c, sph_r)
             for c, s, o in zip(interiors, slabs, origins)], slabs)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------
_LIB = "jacobi_overlap"
_SIGNATURE = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p]


def jacobi7_overlap_cuda(interiors: Sequence[torch.Tensor], origins: Sequence,
                         hot_c, cold_c, sph_r: int, counts: Dim3,
                         out: Optional[Sequence[torch.Tensor]] = None,
                         recv: Optional[OverlapRecv] = None
                         ) -> Tuple[List[torch.Tensor], OverlapRecv]:
    """B7: one overlapped Jacobi step plus the spheres on every (Z, Y,
    X) float32 or bfloat16 shard of an x-unsharded mesh (``interiors[i]``
    at global origin ``origins[i]`` = (z, y, x), x fastest), Z >= 4, Y >=
    2.
    ``out``: the shards' output tensors (not aliasing the inputs);
    ``recv``: the mesh's persistent ``OverlapRecv`` (made here if None).
    Returns (out, recv); ``recv.slabs`` then hold the landed slabs."""
    what = "jacobi7_overlap_cuda"
    counts = Dim3.of(counts)
    arrs = list(interiors)
    Z, Y, X = _check_mesh(arrs, counts, what)
    if out is None:
        out = [torch.empty_like(t) for t in arrs]
    out = list(out)
    for t, o in zip(arrs, out):
        if (o.shape != t.shape or o.dtype != t.dtype or o.device != t.device
                or not o.is_contiguous() or o.data_ptr() == t.data_ptr()):
            raise ValueError(f"{what}: out must be contiguous {t.dtype} "
                             f"tensors of the shards' shape and devices, "
                             f"not aliasing them")
    if recv is None:
        recv = OverlapRecv(arrs, counts)
    if all(t.device.type == "cpu" for t in arrs):
        new, slabs = jacobi7_overlap_plain(arrs, origins, hot_c, cold_c,
                                           sph_r, counts)
        for o, v, dst, src in zip(out, new, recv.slabs, slabs):
            o.copy_(v)
            for k in SLAB_NAMES:
                dst[k].copy_(src[k])
        return out, recv
    for t in arrs + out:
        _check_cuda(t, what)
    if recv.streams is None or recv.counts != counts:
        raise ValueError(f"{what}: recv was made for another mesh")
    from . import _build

    spheres = (*_sphere_args(hot_c, cold_c, sph_r), is_bf16(arrs[0]))
    orgs = [tuple(int(v) for v in o) for o in origins]
    n = len(arrs)
    with recv.own_session():
        # launch A: sends and the interior, after rule (a)
        for i, t in enumerate(arrs):
            tg = recv.send_to[i]
            with recv.launch_a(i):
                _build.launch(_LIB, "jacobi7_overlap_inner_launch",
                              _SIGNATURE, t.device, t.data_ptr(),
                              out[i].data_ptr(),
                              *(recv.slabs[tg[k]][k].data_ptr()
                                for k in SLAB_NAMES), Z, Y, X, *orgs[i],
                              *spheres)
        # launch B: the faces, after rule (b)
        for j, t in enumerate(arrs):
            with recv.launch_b(j):
                _build.launch(_LIB, "jacobi7_overlap_faces_launch",
                              _SIGNATURE, t.device, t.data_ptr(),
                              out[j].data_ptr(),
                              *(recv.slabs[j][k].data_ptr()
                                for k in SLAB_NAMES), Z, Y, X, *orgs[j],
                              *spheres)
    LAUNCHES["jacobi7_overlap"] += n
    return out, recv
