"""The exchanges the message checkers run (collectives, hlo, costmodel,
linkmap): each configuration of JAX's registry, at JAX's sizes, as a
function that makes its own seeded CPU shards and runs the port's
engine, in one process (every shard here) or as one rank of a world
whose every mesh position is a rank of its own (the other ranks' shards
None, the messages through ``torch.distributed``, which
``probes.DistShim`` records)."""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..geometry import Dim3, Radius
from .probes import POINT_TO_POINT

#: JAX's exchange targets' mesh and padded global (registry.py:371-372)
EXCHANGE_MESH = Dim3(2, 2, 2)
EXCHANGE_SHARD = (14, 14, 14)
PLAN_INTERIOR = 8


@dataclasses.dataclass
class ExchangeSpec:
    """``run(view, ranks)``: make the shards (all of them with ``view``
    None, else those ``ranks`` gives rank ``view``) and run the engine
    once (``ranks`` passed only with a view). ``shape``: "bijection"
    (every message goes to a neighbour along its axis, a permutation of
    each mesh line) or "gather" (every slab of a line reaches the
    line). ``allow``: the ``torch.distributed`` calls a rank may make.
    ``expected_bytes_per_shard``: the byte model's wire bytes a shard;
    ``traffic()``: the linkmap's per-(src, dst) matrix; ``by_link``:
    held link by link (else in total)."""
    counts: Dim3
    run: Callable[[Optional[int], Optional[List[int]]], None]
    shape: str = "bijection"
    allow: Tuple[str, ...] = POINT_TO_POINT
    expected_bytes_per_shard: Optional[int] = None
    traffic: Optional[Callable[[], object]] = None
    by_link: bool = True
    ranks: Optional[List[int]] = None

    def rank_list(self) -> List[int]:
        return self.ranks or list(range(self.counts.flatten()))


def _field(shape, dtype, i: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(1000 + i)
    return torch.randn(tuple(shape), generator=gen).to(dtype)


def shards_for(counts: Dim3, shape, dtype, view, ranks) -> List:
    """Seeded shards of every position (``view`` None) or of rank
    ``view``'s positions (None elsewhere)."""
    n = counts.flatten()
    return [_field(shape, dtype, i) if view is None or ranks[i] == view
            else None for i in range(n)]


def exchange_radius(kind: str) -> Radius:
    """JAX ``registry._exchange_radius``."""
    if kind == "r1":
        return Radius.constant(1)
    if kind == "r3":
        return Radius.constant(3)
    if kind == "asym":
        r = Radius.constant(0)
        r.set_dir((1, 0, 0), 2)
        r.set_dir((-1, 0, 0), 1)
        r.set_dir((0, 1, 0), 1)
        return r
    raise ValueError(f"unknown exchange radius kind {kind!r}")


def _sweep(shape, radius, counts, elem, layout="slab",
           alloc_radius=None) -> int:
    from .costmodel import sweep_wire_bytes

    return sum(sweep_wire_bytes(shape, radius, counts, elem, layout=layout,
                                alloc_radius=alloc_radius).values())


def slab_exchange(kind: str, layout: str = "slab") -> ExchangeSpec:
    """``exchange_shard[r1|r3|asym(,irr)]``: (14,)^3 padded shards on
    (2, 2, 2)."""
    from ..observatory.linkmap import sweep_traffic
    from ..parallel.exchange import exchange_shard

    radius = exchange_radius(kind)
    counts = EXCHANGE_MESH

    def run(view, ranks):
        sh = shards_for(counts, EXCHANGE_SHARD, torch.float32, view, ranks)
        exchange_shard(sh, radius, counts, wire_layout=layout,
                       ranks=ranks if view is not None else None)

    return ExchangeSpec(
        counts, run,
        expected_bytes_per_shard=_sweep(EXCHANGE_SHARD, radius, counts, 4,
                                        layout),
        traffic=lambda: sweep_traffic(EXCHANGE_SHARD, radius, counts, (4,),
                                      layout=layout))


def deep_tail_exchange(layout: str = "slab") -> ExchangeSpec:
    """``exchange_shard[deep-tail(,irr)]``: wire depth 1 on pads of 2,
    (12,)^3 padded shards."""
    from ..observatory.linkmap import sweep_traffic
    from ..parallel.exchange import exchange_shard

    radius = Radius.constant(1)
    alloc = radius.deepened(2)
    counts = EXCHANGE_MESH
    shape = (12, 12, 12)

    def run(view, ranks):
        sh = shards_for(counts, shape, torch.float32, view, ranks)
        exchange_shard(sh, radius, counts, alloc_radius=alloc,
                       wire_layout=layout,
                       ranks=ranks if view is not None else None)

    return ExchangeSpec(
        counts, run,
        expected_bytes_per_shard=_sweep(shape, radius, counts, 4, layout,
                                        alloc),
        traffic=lambda: sweep_traffic(shape, radius, counts, (4,),
                                      layout=layout, alloc_radius=alloc))


def packed_uneven(layout: str = "slab") -> ExchangeSpec:
    """``exchange_shard_packed[uneven(,irr)]``: a float32 and a bfloat16
    quantity, (10,)^3 capacity shards with remainders (1, 1, 1)."""
    from ..observatory.linkmap import sweep_traffic
    from ..parallel.exchange import exchange_shard_packed

    radius = Radius.constant(1)
    counts = EXCHANGE_MESH
    shape = (10, 10, 10)

    def run(view, ranks):
        fields = {"a": shards_for(counts, shape, torch.float32, view, ranks),
                  "b": shards_for(counts, shape, torch.bfloat16, view,
                                  ranks)}
        exchange_shard_packed(fields, radius, counts, rem=Dim3(1, 1, 1),
                              wire_layout=layout,
                              ranks=ranks if view is not None else None)

    return ExchangeSpec(
        counts, run,
        expected_bytes_per_shard=(_sweep(shape, radius, counts, 4, layout)
                                  + _sweep(shape, radius, counts, 2,
                                           layout)),
        traffic=lambda: sweep_traffic(shape, radius, counts, (4, 2),
                                      layout=layout))


def allgather_exchange() -> ExchangeSpec:
    """``exchange_shard_allgather``: (8,)^3 padded shards, radius 1."""
    from ..parallel.exchange import exchange_shard_allgather

    radius = Radius.constant(1)
    counts = EXCHANGE_MESH
    shape = (8, 8, 8)

    def run(view, ranks):
        sh = shards_for(counts, shape, torch.float32, view, ranks)
        exchange_shard_allgather(sh, radius, counts,
                                 ranks=ranks if view is not None else None)

    return ExchangeSpec(
        counts, run, shape="gather",
        expected_bytes_per_shard=_sweep(shape, radius, counts, 4),
        traffic=lambda: _allgather_traffic(shape, radius, counts),
        by_link=False)


def _allgather_traffic(shape, radius, counts):
    from ..observatory.linkmap import sweep_traffic

    return sweep_traffic(shape, radius, counts, (4,))


def interior_slabs(yzext: bool) -> ExchangeSpec:
    """``exchange_interior_slabs(,[yzext])``: (8,)^3 shards on (1, 2, 2),
    3 rows."""
    from ..parallel.exchange import (exchange_interior_slabs,
                                     interior_slab_bytes)

    counts = Dim3(1, 2, 2)
    shape = (8, 8, 8)

    def run(view, ranks):
        sh = shards_for(counts, shape, torch.float32, view, ranks)
        exchange_interior_slabs(sh, counts, rz=3, ry=3, radius_rows=3,
                                y_z_extended=yzext,
                                ranks=ranks if view is not None else None)

    return ExchangeSpec(
        counts, run,
        expected_bytes_per_shard=interior_slab_bytes(shape, counts, 3, 4,
                                                     y_z_extended=yzext))


def temporal_group(depths, layout: str = "slab") -> ExchangeSpec:
    """``temporal_shard_steps[s=...]``: one deep exchange and its
    sub-steps of ``jacobi7`` on 8^3 interiors of (2, 2, 2)."""
    from ..geometry import normalize_depths
    from ..ops.stencil_kernels import jacobi7
    from ..parallel.methods import Method
    from ..parallel.temporal import temporal_shard_steps
    from .costmodel import (asymmetric_group_bytes_per_shard,
                            deep_exchange_bytes_per_shard)
    from ..observatory.linkmap import method_traffic

    d = normalize_depths(depths)
    radius = Radius.constant(1)
    counts = EXCHANGE_MESH
    shape = (8 + 2 * d.z, 8 + 2 * d.y, 8 + 2 * d.x)

    def upd(blocks, dims, off, k, i):
        return {"q": jacobi7(blocks["q"], radius, dims)}

    def run(view, ranks):
        sh = shards_for(counts, shape, torch.float32, view, ranks)
        temporal_shard_steps({"q": sh}, radius, counts, Method.PpermuteSlab,
                             upd, d, wire_layout=layout,
                             ranks=ranks if view is not None else None)

    if d.x == d.y == d.z:
        expected = deep_exchange_bytes_per_shard((8, 8, 8), radius, counts,
                                                 4, d.x, wire_layout=layout)
    else:
        expected = asymmetric_group_bytes_per_shard(
            (8, 8, 8), radius, counts, 4, d, wire_layout=layout)
    return ExchangeSpec(
        counts, run, expected_bytes_per_shard=expected,
        traffic=lambda: method_traffic("PpermuteSlab", (8, 8, 8), radius,
                                       counts, (4,), d, wire_layout=layout))


def plan_exchange(method_name: str, s: int, layout: str = "slab",
                  wire_format=None) -> ExchangeSpec:
    """``tuning.plan[Method,s=..]`` and ``make_exchange[...]``: the
    tuner's candidate, ``make_exchange`` of ``method_name`` at depth
    ``s`` on (8 + 2s)^3 shards of (2, 2, 2)."""
    from ..observatory.linkmap import method_traffic
    from ..parallel.exchange import make_exchange
    from ..parallel.mesh import Mesh
    from ..parallel.methods import Method

    counts = EXCHANGE_MESH
    deep = Radius.constant(1).deepened(s)
    side = PLAN_INTERIOR + 2 * s
    shape = (side, side, side)
    n = counts.flatten()
    fmt = wire_format or "f32"
    spec = {"q": (shape, "float32")} if fmt != "f32" else None

    def run(view, ranks):
        if view is None:
            mesh = Mesh(counts, ["cpu"] * n)
            peers = None
        else:
            mesh = _rank_mesh(counts, ranks)
            peers = ranks
        ex = make_exchange(mesh, deep, Method[method_name],
                           wire_layout=layout, wire_format=wire_format,
                           fields_spec=spec)
        sh = shards_for(counts, shape, torch.float32, view, peers)
        ex({"q": sh})

    from .costmodel import sweep_wire_bytes

    expected = sum(sweep_wire_bytes(shape, deep, counts, 4,
                                    wire_format=wire_format,
                                    layout=layout).values())
    return ExchangeSpec(
        counts, run, shape="gather" if method_name == "AllGather"
        else "bijection", expected_bytes_per_shard=expected,
        traffic=lambda: method_traffic(method_name, (8, 8, 8),
                                       Radius.constant(1), counts, (4,), s,
                                       wire_layout=layout),
        by_link=method_name != "AllGather")


def _rank_mesh(counts: Dim3, ranks: Sequence[int]):
    """A ``Mesh`` whose position i ``ranks[i]`` owns (one CPU device a
    rank)."""
    from ..parallel.mesh import GlobalDevice, Mesh

    devs = [GlobalDevice(r, f"host{r}", torch.device("cpu")) for r in ranks]
    return Mesh(counts, devs)


def migrate_exchange(budget: int = 4, capacity: int = 16) -> ExchangeSpec:
    """``parallel.migrate.migrate_shard``: three float32 fields of 16
    particles a shard on (2, 2, 2), budget 4 (JAX registry.py:1569)."""
    from ..observatory.linkmap import migration_traffic
    from ..parallel.migrate import migrate_shard
    from .costmodel import migration_wire_bytes_per_shard

    counts = EXCHANGE_MESH
    n = counts.flatten()
    names = ("q", "x", "y")

    def run(view, ranks):
        fields = {q: [None] * n for q in names}
        valid, offs = [None] * n, [None] * n
        for i in range(n):
            if view is not None and ranks[i] != view:
                continue
            g = torch.Generator().manual_seed(77 + i)
            for q in names:
                fields[q][i] = torch.randn(capacity, generator=g)
            valid[i] = torch.rand(capacity, generator=g) < 0.75
            offs[i] = tuple(torch.randint(-1, 2, (capacity,), generator=g)
                            for _ in range(3))
        migrate_shard(fields, valid, offs, counts, budget,
                      ranks=ranks if view is not None else None)

    return ExchangeSpec(
        counts, run,
        expected_bytes_per_shard=migration_wire_bytes_per_shard(
            len(names), budget, counts, 4),
        traffic=lambda: migration_traffic(counts, len(names), budget, 4))


def ensemble_exchange(members: int = 4) -> ExchangeSpec:
    """``serving.ensemble.exchange[N=4]``: the slab exchange of a
    4-member ensemble's (N, 14, 14, 14) shards on (2, 2, 2): exactly N
    times one member's bytes."""
    from ..observatory.linkmap import sweep_traffic
    from ..parallel.exchange import exchange_shard

    radius = Radius.constant(1)
    counts = EXCHANGE_MESH

    def run(view, ranks):
        sh = shards_for(counts, (members,) + EXCHANGE_SHARD, torch.float32,
                        view, ranks)
        exchange_shard(sh, radius, counts,
                       ranks=ranks if view is not None else None)

    def traffic():
        tm = sweep_traffic(EXCHANGE_SHARD, radius, counts, (4 * members,))
        return tm

    return ExchangeSpec(
        counts, run,
        expected_bytes_per_shard=members * _sweep(EXCHANGE_SHARD, radius,
                                                  counts, 4),
        traffic=traffic)


def accumulate_exchange() -> ExchangeSpec:
    """The PIC deposit's adjoint (``accumulate_shard``) on (10,)^3 padded
    shards of (2, 2, 2), radius 1: the reverse sweep's matrix."""
    from ..observatory.linkmap import sweep_traffic
    from ..parallel.exchange import accumulate_shard

    radius = Radius.constant(1)
    counts = EXCHANGE_MESH
    shape = (10, 10, 10)

    def run(view, ranks):
        sh = shards_for(counts, shape, torch.float32, view, ranks)
        accumulate_shard(sh, radius, counts,
                         ranks=ranks if view is not None else None)

    return ExchangeSpec(
        counts, run,
        expected_bytes_per_shard=_sweep(shape, radius, counts, 4),
        traffic=lambda: sweep_traffic(shape, radius, counts, (4,),
                                      reverse=True))


def pic_step(grid: int = 16, particles: int = 64) -> ExchangeSpec:
    """``models.pic.step``: one NGP float32 PIC step on (2, 2, 2) of one
    process (the deposit's accumulate, the exchange, the migration), as
    ``linkmap.pic_traffic`` bills it."""
    from ..models.pic import PARTICLE_FIELDS, RADIUS, Pic
    from ..observatory.linkmap import pic_traffic

    counts = EXCHANGE_MESH

    def make():
        return Pic(grid, grid, grid, particles, mesh_shape=tuple(counts),
                   devices=["cpu"] * counts.flatten(), dtype=torch.float32,
                   deposition="ngp", seed=3)

    def run(view, ranks):
        if view is not None:
            raise NotImplementedError("the PIC step's rank views are held "
                                      "by the multi-rank tests")
        make().step()

    def traffic():
        p = make()
        local = p.dd.local_size
        return pic_traffic((local.z, local.y, local.x),
                           Radius.constant(RADIUS), counts, 4,
                           len(PARTICLE_FIELDS), p.budget)

    return ExchangeSpec(counts, run, traffic=traffic)


def probe_messages(spec: ExchangeSpec):
    """The messages of one run in one process (``WireProbe``)."""
    from ..parallel.exchange import WireProbe, recording

    probe = WireProbe()
    with torch.no_grad(), recording(probe):
        spec.run(None, None)
    return probe


def rank_calls(spec: ExchangeSpec):
    """Every rank's ``torch.distributed`` calls, each rank's view run
    under ``probes.DistShim``."""
    from .probes import rank_views

    ranks = spec.rank_list()
    with torch.no_grad():
        return rank_views(lambda r: spec.run(r, ranks), ranks)


# ---------------------------------------------------------------------------
# dispatches: the entry points JAX jits and donates, run eagerly
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DispatchSpec:
    """One dispatch of an entry point JAX compiles and donates:
    ``dispatch()`` advances its carry in place; ``carry()`` the carry's
    tensors (read before and after); ``pairs()`` paired curr/next
    buffers that must agree in shape, dtype and device; ``devices`` the
    shards' devices (the transfer guard's); ``known``: a ROADMAP item
    that records a known break of the donation invariant (the finding is
    then a warning citing it); ``known_allocations``: one that records
    carry-sized temporaries only (the carry itself stays in place)."""
    dispatch: Callable[[], object]
    carry: Callable[[], List[torch.Tensor]]
    pairs: Optional[Callable[[], List[Tuple[torch.Tensor,
                                            torch.Tensor]]]] = None
    devices: Sequence = ("cpu",)
    known: Optional[str] = None
    known_allocations: Optional[str] = None
    model: object = None
    mesh: object = None
    launches: Optional[Callable[[], int]] = None


def _all(v) -> List[torch.Tensor]:
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, dict):
        return [t for x in v.values() for t in _all(x)]
    if isinstance(v, (list, tuple)):
        return [t for x in v for t in _all(x)]
    return []


def jacobi_dispatch(kernel: str = "xla", exchange_every=None,
                    segment: int = 0, device: str = "cpu",
                    size: int = 16, mesh=(1, 2, 2), methods=None
                    ) -> DispatchSpec:
    """``models.jacobi.step_n``: ``Jacobi3D.run(2)`` (``segment`` > 0: a
    ``make_segment(segment, probe_every=2)`` run) on a (1, 2, 2) mesh."""
    from ..models.jacobi import Jacobi3D

    n = mesh[0] * mesh[1] * mesh[2]
    kw = {} if methods is None else {"methods": methods}
    if kernel == "overlap":
        kernel, kw["overlap"] = "halo", True
    m = Jacobi3D(size, size, size, kernel=kernel,
                 exchange_every=exchange_every, mesh_shape=mesh,
                 devices=[device] * n, **kw)
    m.init()
    if segment:
        seg = m.make_segment(segment, probe_every=2)
        if not seg:
            raise RuntimeError(f"no segment on {m.kernel_path}: {seg!r}")
        run = seg.run
    else:
        def run():
            m.run(2)
    # the interior-resident paths copy the interior in and out of the
    # padded field a call (ROADMAP N10); a segment's probe reads each
    # field through one field-sized temporary (ROADMAP N13)
    resident = m.kernel_path in ("wrap", "halo", "overlap")
    return DispatchSpec(run, lambda: _all(m.dd.curr), devices=[device] * n,
                        known_allocations=(
                            "ROADMAP N10" if resident else
                            "ROADMAP N13" if segment else None),
                        model=m, mesh=m.dd.mesh)


def astaroth_dispatch(exchange_every: int = 1, segment: int = 0
                      ) -> DispatchSpec:
    """``models.astaroth.iter_n``: ``Astaroth(8, 8, 16).run(1)`` on
    ``xla`` over (1, 1, 2) (JAX registry.py:1874); ``segment`` > 0: a
    ``make_segment(segment, probe_every=2)`` run of
    ``xla-temporal[s=exchange_every]`` (JAX registry.py:1759)."""
    from ..models.astaroth import Astaroth

    m = Astaroth(8, 8, 16, kernel="xla", mesh_shape=(1, 1, 2),
                 exchange_every=exchange_every, devices=["cpu"] * 2)
    m.init()
    if segment:
        seg = m.make_segment(segment, probe_every=2)
        if not seg:
            raise RuntimeError(f"no segment on {m.kernel_path}: {seg!r}")
        run = seg.run
    else:
        def run():
            m.run(1)
    return DispatchSpec(run,
                        lambda: _all(m.dd.curr) + _all(getattr(m, "_w",
                                                               None)),
                        known="ROADMAP N14", model=m, mesh=m.dd.mesh)


def astaroth_segment_cost(s: int = 2, k: int = 4):
    """``models.astaroth.segment[temporal,s=2,k=4,cost]``: per chunk of
    lcm(3, s) substeps the groups start at RK substeps (g s) % 3, and a
    group starting where alpha != 0 ships the 8 accumulators w in the
    same deep exchange (JAX registry.py:1785-1816)."""
    import math

    from ..models.astaroth import FIELDS, RK3_ALPHA
    from .costmodel import CostModelSpec, FlopsSpec, \
        deep_exchange_bytes_per_shard

    spec = astaroth_dispatch(s, k)
    dd = spec.model.dd
    local = dd.local_size
    deep1 = deep_exchange_bytes_per_shard((local.z, local.y, local.x),
                                          dd.radius, dd.mesh_counts, 4, s)
    period = math.lcm(3, s)
    qs = [len(FIELDS) * (2 if RK3_ALPHA[(g * s) % 3] != 0.0 else 1)
          for g in range(period // s)]
    chunks = k // (period // 3)
    expected = chunks * sum(qs) * deep1 * dd.mesh_counts.flatten()
    io = 2 * sum(t.numel() * t.element_size() for t in spec.carry())
    return CostModelSpec(spec.dispatch, expected,
                         FlopsSpec(spec.dispatch, io))


def exchange_dispatch(method_name: str) -> DispatchSpec:
    """``parallel.exchange.make_exchange[Method]``: one exchange of one
    quantity's (12,)^3 shards on (2, 2, 2), in place."""
    from ..parallel.exchange import make_exchange
    from ..parallel.mesh import Mesh
    from ..parallel.methods import Method

    counts = EXCHANGE_MESH
    mesh = Mesh(counts, ["cpu"] * counts.flatten())
    ex = make_exchange(mesh, Radius.constant(1), Method[method_name])
    fields = {"q": shards_for(counts, (12, 12, 12), torch.float32, None,
                              None)}
    return DispatchSpec(lambda: ex(fields), lambda: _all(fields),
                        mesh=mesh)


def domain_segment_dispatch() -> DispatchSpec:
    """``distributed.make_segment``: a 4-step segment of a ``jacobi7``
    shard step over a realized (1, 2, 2) domain."""
    from ..distributed import DistributedDomain
    from ..ops.stencil_kernels import jacobi7, write_interior

    dd = DistributedDomain(16, 16, 16, devices=["cpu"] * 4)
    dd.set_radius(1)
    dd.set_mesh_shape((1, 2, 2))
    dd.add_data("q", torch.float32)
    dd.realize()
    for t in _all(dd.curr):
        t.copy_(torch.rand(t.shape, generator=torch.Generator()
                           .manual_seed(5)))

    def step(fields):
        dd.exchange()
        for i, t in enumerate(fields["q"]):
            write_interior(t, jacobi7(t, dd.radius, dd.shard_size(i)),
                           dd.radius)
        return fields

    seg = dd.make_segment(step, 4, probe_every=2)
    return DispatchSpec(seg.run, lambda: _all(dd.curr),
                        known_allocations="ROADMAP N13", mesh=dd.mesh)


def ensemble_dispatch(what: str, members: int = 4) -> DispatchSpec:
    """``serving.ensemble.step|segment|set_lane[N=4]`` of an
    ``EnsembleJacobi`` of 4 members at 16^3 on (1, 2, 2)."""
    import numpy as np

    from ..serving.ensemble import EnsembleJacobi

    e = EnsembleJacobi(members, 16, 16, 16, mesh_shape=(1, 2, 2),
                       devices=["cpu"] * 4)
    e.init()
    if what == "step":
        run = lambda: e.run(1)  # noqa: E731
    elif what == "segment":
        run = lambda: e.run_segment(2)  # noqa: E731
        return DispatchSpec(run, e.state_tensors,
                            known_allocations="ROADMAP N13",
                            mesh=e.dd.mesh)
    else:
        lane = np.random.default_rng(4).random((16, 16, 16)).astype(
            np.float32)
        run = lambda: e.set_member_interior("temp", 1, lane)  # noqa: E731
    return DispatchSpec(run, e.state_tensors, mesh=e.dd.mesh)


def pic_dispatch(segment: int = 0) -> DispatchSpec:
    """``models.pic.step`` (``segment`` > 0: ``make_segment``) on
    (2, 2, 2), NGP float32, 64 particles."""
    from ..models.pic import Pic

    p = Pic(16, 16, 16, 64, mesh_shape=(2, 2, 2), devices=["cpu"] * 8,
            dtype=torch.float32, deposition="ngp", seed=3)
    run = p.make_segment(segment, probe_every=2).run if segment else p.step
    return DispatchSpec(run, lambda: _all(p.state) + _all(p.dd.curr),
                        known="ROADMAP N12", mesh=p.dd.mesh, model=p)


def health_dispatch() -> DispatchSpec:
    """``resilience.health.step+probe``: a Jacobi ``xla`` step on
    (1, 2, 2), then the health sentinel's probe of the field (queued on
    the device, no host read)."""
    from ..models.jacobi import Jacobi3D
    from ..resilience.health import HealthSentinel

    m = Jacobi3D(16, 16, 16, kernel="xla", mesh_shape=(1, 2, 2),
                 devices=["cpu"] * 4)
    m.init()
    sentinel = HealthSentinel(m.dd)
    step = [0]

    def run():
        m.run(1)
        step[0] += 1
        sentinel.probe(m.dd.curr, step[0])

    return DispatchSpec(run, lambda: _all(m.dd.curr),
                        known_allocations="ROADMAP N13", mesh=m.dd.mesh)


def precision_of(spec: DispatchSpec):
    """The precision checker's view of a dispatch (float32 storage and
    compute, no narrowing wire)."""
    from .precision import PrecisionSpec

    return PrecisionSpec(spec.dispatch, spec.mesh)


def exchange_precision(method_name: str, wire_format=None,
                       layout: str = "slab"):
    """``analysis.precision.parallel.exchange.make_exchange[...]``: one
    exchange of (12,)^3 float32 shards of (2, 2, 2) through
    ``make_exchange`` with the wire format and layout."""
    from ..parallel.exchange import make_exchange
    from ..parallel.mesh import Mesh
    from ..parallel.methods import Method
    from .precision import PrecisionSpec

    counts = EXCHANGE_MESH
    mesh = Mesh(counts, ["cpu"] * counts.flatten())
    fmt = wire_format or "f32"
    ex = make_exchange(mesh, Radius.constant(1), Method[method_name],
                       wire_format=wire_format, wire_layout=layout,
                       fields_spec={"q": ((12, 12, 12), "float32")}
                       if fmt != "f32" else None)
    fields = {"q": shards_for(counts, (12, 12, 12), torch.float32, None,
                              None)}
    return PrecisionSpec(lambda: ex(fields), mesh, wire=ex.wire_format)


def fleet_dispatch() -> DispatchSpec:
    """``serving.fleet.admission``: a (18, 21, 13) request bucketed into
    (24, 24, 24) must share the native bucket request's fingerprint (one
    engine-cache slot), and the bucket-shaped ensemble step it reuses is
    the dispatch (4 members on (2, 2, 2))."""
    from ..serving.ensemble import EnsembleJacobi
    from ..serving.queue import CampaignRequest, request_fingerprint
    from ..serving.slo import GridBucketer

    devs = ["cpu"] * EXCHANGE_MESH.flatten()
    bucketer = GridBucketer(((24, 24, 24),))
    padded, was = bucketer.apply(CampaignRequest(
        tenant="lint", campaign="pad", grid=(18, 21, 13),
        mesh_shape=tuple(EXCHANGE_MESH)))
    native = CampaignRequest(tenant="lint", campaign="native",
                             grid=(24, 24, 24),
                             mesh_shape=tuple(EXCHANGE_MESH))
    if not was or tuple(padded.grid) != (24, 24, 24):
        raise AssertionError(f"grid bucketing admitted (18, 21, 13) at "
                             f"{tuple(padded.grid)}, not (24, 24, 24)")
    if request_fingerprint(padded, devs) != request_fingerprint(native,
                                                                devs):
        raise AssertionError("a padded admission does not share the "
                             "native bucket's fingerprint: the pre-pad "
                             "grid leaked into the admission key")
    e = EnsembleJacobi(4, *padded.grid, mesh_shape=tuple(EXCHANGE_MESH),
                       devices=devs)
    e.init()
    return DispatchSpec(lambda: e.run(1), e.state_tensors, mesh=e.dd.mesh)


def attributed(spec: DispatchSpec, k: int = 4) -> DispatchSpec:
    """``observatory.attribution``: the dispatch inside
    ``PerfAttributor.dispatch`` (a host clock and a fence around it),
    which must add nothing the bare dispatch does not do."""
    from ..observatory.attribution import PerfAttributor
    from ..telemetry.metrics import MetricsRegistry
    from ..utils.timers import device_sync

    attr = PerfAttributor("lint", model_step_seconds=1e-3,
                          registry=MetricsRegistry())
    bare = spec.dispatch

    def run():
        with attr.dispatch(k, lambda: device_sync(spec.carry())):
            bare()

    return dataclasses.replace(spec, dispatch=run)


def step_hlo(spec: DispatchSpec):
    """The hlo checker's view of a whole dispatch in one process."""
    from .hlo import StepSpec

    return StepSpec(spec.dispatch)


def probe_step(what: str):
    """The probes alone: ``resilience.health.probe`` (``probe_mesh`` over
    a (1, 2, 2) Jacobi field), ``telemetry.probe+metrics`` (with the
    ``StepMetrics`` columns) and ``serving.ensemble.probe`` (4 members)."""
    from ..resilience.health import probe_mesh
    from ..telemetry.probe import StepMetrics
    from .hlo import StepSpec

    if what == "ensemble":
        from ..serving.ensemble import EnsembleJacobi, make_ensemble_probe

        e = EnsembleJacobi(4, 16, 16, 16, mesh_shape=(1, 2, 2),
                           devices=["cpu"] * 4)
        e.init()
        fn = make_ensemble_probe(e.dd.mesh, e.names)
        return StepSpec(lambda: fn(e.state))
    spec = jacobi_dispatch("xla")
    m = spec.model
    if what == "metrics":
        sm = StepMetrics(m.dd)
        extra = dict(zip(sm.names, sm.host_values(4)))
        return StepSpec(lambda: probe_mesh(m.dd.curr, m.dd.mesh, extra))
    return StepSpec(lambda: probe_mesh(m.dd.curr, m.dd.mesh))


def step_cost(spec: DispatchSpec, exchanges: int):
    """The costmodel checker's view of a dispatch that runs
    ``exchanges`` exchanges of its domain: its probed wire bytes against
    the domain's modeled bytes an exchange (every shard), and the FLOPs
    of one more dispatch."""
    from .costmodel import CostModelSpec, FlopsSpec

    dd = spec.model.dd
    # the domain's byte model: bytes a shard sends an exchange, per axis
    per = sum(dd.exchange_bytes_per_axis().values()) * \
        dd.mesh_counts.flatten()
    io = 2 * sum(t.numel() * t.element_size() for t in spec.carry())
    return CostModelSpec(spec.dispatch, exchanges * per,
                         FlopsSpec(spec.dispatch, io))


def pic_cost(segment: int = 0, probe_every: int = 2):
    """``models.pic.step[cost]`` / ``segment[k=4,cost|probe]``: the
    probed bytes of the steps against ``linkmap.pic_traffic``'s bill."""
    from ..models.pic import PARTICLE_FIELDS, RADIUS, Pic
    from ..observatory.linkmap import pic_traffic
    from .costmodel import CostModelSpec, FlopsSpec

    p = Pic(16, 16, 16, 64, mesh_shape=(2, 2, 2), devices=["cpu"] * 8,
            dtype=torch.float32, deposition="ngp", seed=3)
    local = p.dd.local_size
    per = pic_traffic((local.z, local.y, local.x), Radius.constant(RADIUS),
                      EXCHANGE_MESH, 4, len(PARTICLE_FIELDS),
                      p.budget).total()
    run = (p.make_segment(segment, probe_every=probe_every).run
           if segment else p.step)
    io = 2 * sum(t.numel() * t.element_size() for t in _all(p.state))
    return CostModelSpec(run, max(segment, 1) * per, FlopsSpec(run, io))
