"""The targets the port's checkers run, under JAX's registry names.

PyTorch-port counterpart of ``stencil_tpu/analysis/registry.py``. Every
target here has a counterpart in JAX's registry of the same name, checked
by the checker of the same name on what the port runs (``entries.py``
builds the runs at JAX's sizes, on the CPU over the plain twins). A JAX
target with no counterpart is listed in :data:`NO_COUNTERPART` with the
reason. Targets that exist only on the card (``card.py``: the kernels'
footprints, their builds' registers and spills, their occupancy, the
donation and transfer of the kernel paths) are the ``cuda.`` group.

:func:`load_targets` reads a fixture file's ``TARGETS`` instead (the
negative controls under ``tests/fixtures/torch_lint/``).
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from typing import Callable, Dict, List

from ..geometry import Dim3, Radius
from . import entries as E
from .collectives import CollectiveTarget
from .costmodel import CostModelTarget
from .dma import DmaTarget
from .donation import DonationTarget
from .footprint import StencilOpSpec, StencilOpTarget
from .hlo import HloTarget
from .precision import PrecisionTarget
from .recompile import RecompileTarget
from .schedule import (DEFAULT_REPLAY, ScheduleSpec, ScheduleTarget,
                       b4_programs, b7_targets, b13_targets,
                       local_programs, overlap_spec)
from .tiling import PLANS, SIZES, TILING_EXPECT, TilingTarget
from .transfer import TransferTarget
from .vmem import VmemTarget, small_plan
from ..observatory.linkmap import LinkmapTarget

#: JAX registry targets the port has no counterpart for, each with why
NO_COUNTERPART: Dict[str, str] = {
    "parallel.exchange.make_exchange[jit,packed]":
        "the port compiles no program; the eager packed exchange is held "
        "by the collectives and costmodel targets of "
        "exchange_shard_packed[uneven]",
    "parallel.exchange.make_exchange[jit,packed,hlo]":
        "the port compiles no program; the eager packed exchange's calls "
        "are held by parallel.exchange.exchange_shard_packed[uneven,hlo] "
        "and tuning.plan[PpermutePacked,s=1,hlo], which builds it "
        "through make_exchange",
    "parallel.exchange.make_exchange[jit,packed,cost]":
        "the port compiles no program; the packed engine's bytes through "
        "make_exchange are held by tuning.plan[PpermutePacked,s=1,cost]",
    "observatory.linkmap.hierarchical[dcn]":
        "the DCN tier changes which link a message takes, not the "
        "matrix: the (2,2,2) matrix is held link by link by "
        "observatory.linkmap.exchange[r1], and the DCN planner's "
        "placement by tests/test_torch_multihost.py",
}


# ---------------------------------------------------------------------------
# footprint (JAX registry.py:65-137, :1835)
# ---------------------------------------------------------------------------
def _op_spec(fn, radius: int, n_inputs: int = 1) -> StencilOpSpec:
    """An op over an 8^3 interior padded one row deeper than its
    declared radius (so that a read one row too far shows)."""
    pad = radius + 1
    side = 8 + 2 * pad
    return StencilOpSpec(fn, (side, side, side), Radius.constant(radius),
                         Dim3(8, 8, 8), pad_lo=Dim3(pad, pad, pad),
                         n_inputs=n_inputs)


def _footprint_targets() -> List:
    from ..models.astaroth import FIELDS, MhdParams, mhd_rates
    from ..ops import fd6
    from ..ops import stencil_kernels as sk

    n8 = Dim3(8, 8, 8)
    out = [
        StencilOpTarget("ops.stencil_kernels.jacobi7", lambda: _op_spec(
            lambda p: sk.jacobi7(p, Radius.constant(2), n8), 1)),
        StencilOpTarget("ops.stencil_kernels.laplacian27", lambda: _op_spec(
            lambda p: sk.laplacian27(p, Radius.constant(2), n8), 1)),
    ]

    def rates():
        prm = MhdParams()
        inv = (1.0 / prm.dsx, 1.0 / prm.dsy, 1.0 / prm.dsz)
        lo = Dim3(4, 4, 4)

        def fn(*padded):
            import torch

            data = {q: fd6.FieldData(p * 0.01, inv, lo, n8)
                    for q, p in zip(FIELDS, padded)}
            r = mhd_rates(data, prm, torch.float32)
            return tuple(r[q] for q in FIELDS)
        return _op_spec(fn, fd6.RADIUS, len(FIELDS))

    out.append(StencilOpTarget("models.astaroth.mhd_rates", rates))
    lo = Dim3(4, 4, 4)
    for a, ax in enumerate("xyz"):
        out.append(StencilOpTarget(
            f"ops.fd6.der1[{ax}]", lambda a=a: _op_spec(
                lambda p: fd6.der1(p, a, 1.0, lo, n8), fd6.RADIUS)))
        out.append(StencilOpTarget(
            f"ops.fd6.der2[{ax}]", lambda a=a: _op_spec(
                lambda p: fd6.der2(p, a, 1.0, lo, n8), fd6.RADIUS)))
    for a, b in ((0, 1), (0, 2), (1, 2)):
        out.append(StencilOpTarget(
            f"ops.fd6.der_cross[{'xyz'[a]}{'xyz'[b]}]",
            lambda a=a, b=b: _op_spec(
                lambda p: fd6.der_cross(p, a, b, 1.0, 1.0, lo, n8),
                fd6.RADIUS)))
    for a, ax in enumerate("xyz"):
        out.append(StencilOpTarget(
            f"ops.stencil_kernels.central_diff[{ax}]", lambda a=a: _op_spec(
                lambda p: sk.central_diff(p, a, Radius.constant(2), n8),
                1)))
    return out


# ---------------------------------------------------------------------------
# dma and schedule (JAX registry.py:140-362)
# ---------------------------------------------------------------------------
_MESH122 = Dim3(1, 2, 2)
_OWN4 = list(range(4))

#: the schedules: JAX's kernel name -> (spec builder, pinned
#: max_in_flight, consumed by the segment builder)
_SCHEDULES: Dict[str, tuple] = {
    "parallel.pallas_exchange.exchange_shard_pallas": (
        lambda k: ScheduleSpec("ops.cuda_exchange.exchange_axis_cuda",
                               lambda r: b4_programs(Dim3(2, 2, 2), 3, r),
                               replay=k), 168, False),
    "ops.pallas_overlap.jacobi7_overlap_pallas": (
        lambda k: overlap_spec("ops.cuda_overlap.jacobi7_overlap_cuda",
                               _MESH122, b7_targets(_MESH122), _OWN4, k),
        8, True),
    "ops.pallas_mhd_overlap.mhd_substep_overlap": (
        lambda k: overlap_spec("ops.cuda_mhd_overlap.mhd_substep_overlap",
                               _MESH122, b13_targets(_MESH122, 3), _OWN4,
                               k), 12, False),
    "ops.pallas_mhd_overlap.mhd_substep_overlap[pair]": (
        lambda k: overlap_spec(
            "ops.cuda_mhd_overlap.mhd_substep_overlap[pair]", _MESH122,
            b13_targets(_MESH122, 6), _OWN4, k), 12, False),
    "ops.pallas_halo.jacobi7_halo_pallas": (
        lambda k: ScheduleSpec("ops.cuda_halo.jacobi7_halo_cuda",
                               lambda r: local_programs(4, r), replay=k,
                               expect_remote=False), 0, False),
}


def _schedule(name: str, k: int = DEFAULT_REPLAY):
    build, pin, fused = _SCHEDULES[name]

    def make():
        spec = build(k)
        spec.expect_max_in_flight = pin
        spec.fused_by_megastep = fused
        return spec
    return make


def _segment_schedule() -> ScheduleSpec:
    """The ``overlap`` segment of one process (``Jacobi3D``'s gate): B7
    on (1, 2, 2), every relation an event, replayed k = 4 times."""
    return overlap_spec("parallel.megastep.segment[overlap]", _MESH122,
                        b7_targets(_MESH122), None, DEFAULT_REPLAY,
                        expect_max_in_flight=8, fused_by_megastep=True)


def _dma_schedule_targets() -> List:
    out = [DmaTarget(name, _schedule(name, 2)) for name in _SCHEDULES]
    out += [ScheduleTarget(f"analysis.schedule.{name[:-1]},k=4]"
                           if name.endswith("]")
                           else f"analysis.schedule.{name}[k=4]",
                           _schedule(name)) for name in _SCHEDULES]
    out.append(ScheduleTarget(
        "analysis.schedule.parallel.megastep.segment[overlap,k=4]",
        _segment_schedule))
    return out


# ---------------------------------------------------------------------------
# the message checkers: collectives, hlo, costmodel, linkmap
# ---------------------------------------------------------------------------
#: JAX's exchange configurations: name stem -> ExchangeSpec builder
_EXCHANGES: Dict[str, Callable] = {
    "parallel.exchange.exchange_shard[r1": lambda: E.slab_exchange("r1"),
    "parallel.exchange.exchange_shard[r3": lambda: E.slab_exchange("r3"),
    "parallel.exchange.exchange_shard[asym":
        lambda: E.slab_exchange("asym"),
    "parallel.exchange.exchange_shard[deep-tail": E.deep_tail_exchange,
    "parallel.exchange.exchange_shard_packed[uneven": E.packed_uneven,
    "parallel.temporal.temporal_shard_steps[s=2":
        lambda: E.temporal_group(2),
    "parallel.temporal.temporal_shard_steps[s=4":
        lambda: E.temporal_group(4),
    "parallel.temporal.temporal_shard_steps[s=1.1.2":
        lambda: E.temporal_group((1, 1, 2)),
    "serving.ensemble.exchange[N=4": E.ensemble_exchange,
}
_IRR: Dict[str, Callable] = {
    "parallel.exchange.exchange_shard[r1":
        lambda: E.slab_exchange("r1", "irredundant"),
    "parallel.exchange.exchange_shard[r3":
        lambda: E.slab_exchange("r3", "irredundant"),
    "parallel.exchange.exchange_shard[asym":
        lambda: E.slab_exchange("asym", "irredundant"),
    "parallel.exchange.exchange_shard[deep-tail":
        lambda: E.deep_tail_exchange("irredundant"),
    "parallel.exchange.exchange_shard_packed[uneven":
        lambda: E.packed_uneven("irredundant"),
    "parallel.temporal.temporal_shard_steps[s=2":
        lambda: E.temporal_group(2, "irredundant"),
}


def _message_targets() -> List:
    out: List = []

    def add(cls, name, build):
        out.append(cls(name, build))

    for stem, build in _EXCHANGES.items():
        add(CollectiveTarget, stem + "]", build)
        if not stem.endswith("[r3") and "s=4" not in stem:
            add(HloTarget, stem + ",hlo]", build)
        add(CostModelTarget, stem + ",cost]", build)
    for stem, build in _IRR.items():
        add(CollectiveTarget, stem + ",irr]", build)
        if not stem.endswith("[r3"):
            add(HloTarget, stem + ",irr,hlo]", build)
        add(CostModelTarget, stem + ",irr,cost]", build)
    add(CollectiveTarget, "parallel.exchange.exchange_shard_allgather",
        E.allgather_exchange)
    add(HloTarget, "parallel.exchange.exchange_shard_allgather[hlo]",
        E.allgather_exchange)
    add(CostModelTarget, "parallel.exchange.exchange_shard_allgather[cost]",
        E.allgather_exchange)
    for yz, tag in ((True, "[yzext"), (False, "")):
        stem = "parallel.exchange.exchange_interior_slabs" + tag
        add(CollectiveTarget, stem + ("]" if yz else ""),
            lambda y=yz: E.interior_slabs(y))
        add(CostModelTarget, stem + (",cost]" if yz else "[cost]"),
            lambda y=yz: E.interior_slabs(y))
    add(HloTarget, "parallel.exchange.exchange_interior_slabs[yzext,hlo]",
        lambda: E.interior_slabs(True))
    add(CollectiveTarget, "parallel.migrate.migrate_shard",
        E.migrate_exchange)
    add(HloTarget, "parallel.migrate.migrate_shard[hlo]", E.migrate_exchange)
    add(CostModelTarget, "parallel.migrate.migrate_shard[cost]",
        E.migrate_exchange)
    # the tuner's candidates (JAX registry.py:991-1026)
    for method in ("PpermuteSlab", "PpermutePacked"):
        for s in (1, 2, 4, 8):
            add(HloTarget, f"tuning.plan[{method},s={s},hlo]",
                lambda m=method, d=s: E.plan_exchange(m, d))
            add(CostModelTarget, f"tuning.plan[{method},s={s},cost]",
                lambda m=method, d=s: E.plan_exchange(m, d))
    add(HloTarget, "tuning.plan[AllGather,s=1,hlo]",
        lambda: E.plan_exchange("AllGather", 1))
    add(CostModelTarget, "tuning.plan[AllGather,s=1,cost]",
        lambda: E.plan_exchange("AllGather", 1))
    for method, s in (("PpermuteSlab", 2), ("PpermutePacked", 4)):
        stem = f"tuning.plan[{method},s={s},layout=irredundant"
        add(HloTarget, stem + ",hlo]",
            lambda m=method, d=s: E.plan_exchange(m, d, "irredundant"))
        add(CostModelTarget, stem + ",cost]",
            lambda m=method, d=s: E.plan_exchange(m, d, "irredundant"))
    add(HloTarget, "tuning.plan[PallasDMA,s=1,hlo]",
        lambda: E.plan_exchange("PallasDMA", 1))
    add(HloTarget, "parallel.pallas_exchange.exchange_shard_pallas[hlo]",
        lambda: E.plan_exchange("PallasDMA", 1))
    # make_exchange's wire formats and layouts (JAX registry.py:1916-2060)
    for method, key, fmt, layout in (
            ("PpermuteSlab", "wire=bf16", "bf16", "slab"),
            ("PpermuteSlab", "layout=irredundant", None, "irredundant"),
            ("PpermutePacked", "wire=bf16", "bf16", "slab"),
            ("PpermutePacked", "layout=irredundant", None, "irredundant"),
            ("PpermuteSlab", "wire=e4m3", "e4m3", "slab"),
            ("PpermuteSlab", "wire=e4m3,layout=irredundant", "e4m3",
             "irredundant")):
        stem = f"parallel.exchange.make_exchange[{method},{key}"
        build = (lambda m=method, f=fmt, lay=layout:
                 E.plan_exchange(m, 1, lay, wire_format=f))
        add(HloTarget, stem + ",hlo]", build)
        add(CostModelTarget, stem + ",bytes]", build)
    # whole steps in one process: no torch.distributed call at all
    for name, build in (
            ("serving.ensemble.step[N=4,hlo]",
             lambda: E.step_hlo(E.ensemble_dispatch("step"))),
            ("serving.ensemble.probe[N=4,hlo]",
             lambda: E.probe_step("ensemble")),
            ("serving.fleet.bucket_step[hlo]",
             lambda: E.step_hlo(E.fleet_dispatch())),
            ("resilience.health.probe[hlo]", lambda: E.probe_step("health")),
            ("resilience.health.step+probe[hlo]",
             lambda: E.step_hlo(E.health_dispatch())),
            ("telemetry.probe+metrics[hlo]",
             lambda: E.probe_step("metrics")),
            ("telemetry.step+probe+metrics[hlo]",
             lambda: E.step_hlo(_metrics_segment())),
            ("parallel.megastep.segment[k=4,hlo]",
             lambda: E.step_hlo(_segment())),
            ("observatory.attribution.segment[hlo]",
             lambda: E.step_hlo(E.attributed(_segment()))),
            ("observatory.attribution.pic_step[hlo]",
             lambda: E.step_hlo(E.attributed(E.pic_dispatch(), 1))),
            ("models.pic.step[hlo]", lambda: E.step_hlo(E.pic_dispatch())),
            ("models.pic.probe[hlo]", _pic_probe),
            ("models.pic.segment[k=4,hlo]",
             lambda: E.step_hlo(E.pic_dispatch(4))),
            ("models.astaroth.segment[temporal,s=2,k=4,hlo]",
             lambda: E.step_hlo(_astaroth_segment()))):
        add(HloTarget, name, build)
    for name, build in (
            ("telemetry.step+probe+metrics[cost]",
             lambda: E.step_cost(_metrics_segment(), 1)),
            ("parallel.megastep.segment[k=4,cost]",
             lambda: E.step_cost(_segment(), 4)),
            ("observatory.attribution.segment[cost]",
             lambda: E.step_cost(E.attributed(_segment()), 4)),
            ("models.pic.step[cost]", E.pic_cost),
            ("models.pic.segment[k=4,cost]", lambda: E.pic_cost(4)),
            ("models.pic.segment[k=4,probe]", lambda: E.pic_cost(4, 1)),
            ("models.astaroth.segment[temporal,s=2,k=4,cost]",
             _astaroth_segment_cost)):
        add(CostModelTarget, name, build)
    # linkmap (JAX observatory/linkmap.py targets)
    for name, build in (
            ("observatory.linkmap.exchange[r1]",
             lambda: E.slab_exchange("r1")),
            ("observatory.linkmap.exchange[r3]",
             lambda: E.slab_exchange("r3")),
            ("observatory.linkmap.exchange[asym]",
             lambda: E.slab_exchange("asym")),
            ("observatory.linkmap.exchange[r1,irr]",
             lambda: E.slab_exchange("r1", "irredundant")),
            ("observatory.linkmap.exchange[r3,irr]",
             lambda: E.slab_exchange("r3", "irredundant")),
            ("observatory.linkmap.packed[uneven]", E.packed_uneven),
            ("observatory.linkmap.plan[PpermuteSlab,s=2]",
             lambda: E.plan_exchange("PpermuteSlab", 2)),
            ("observatory.linkmap.plan[PpermutePacked,s=4]",
             lambda: E.plan_exchange("PpermutePacked", 4)),
            ("observatory.linkmap.plan[PpermuteSlab,s=1.1.2]",
             lambda: E.temporal_group((1, 1, 2))),
            ("observatory.linkmap.allgather", E.allgather_exchange),
            ("observatory.linkmap.migrate", E.migrate_exchange),
            ("observatory.linkmap.pic_step", E.pic_step)):
        add(LinkmapTarget, name, build)
    return out


def _segment():
    """``parallel.megastep.segment[k=4]``: a 4-step ``xla`` segment of
    Jacobi 16^3 on (2, 2, 2), probing every other step."""
    return E.jacobi_dispatch("xla", segment=4, mesh=(2, 2, 2))


def _metrics_segment():
    """``telemetry.step+probe+metrics``: a one-step segment with the
    ``StepMetrics`` columns."""
    from ..models.jacobi import Jacobi3D
    from ..telemetry.probe import StepMetrics

    m = Jacobi3D(16, 16, 16, kernel="xla", mesh_shape=(2, 2, 2),
                 devices=["cpu"] * 8)
    m.init()
    seg = m.make_segment(1, metrics=StepMetrics(m.dd))
    return E.DispatchSpec(seg.run, lambda: E._all(m.dd.curr), model=m,
                          mesh=m.dd.mesh)


def _pic_probe():
    """``models.pic.probe``: the PIC probe alone (rho, the seven particle
    lanes and the overflow column, ``make_sentinel``'s reduction)."""
    from ..resilience.health import probe_mesh
    from .hlo import StepSpec

    p = E.pic_dispatch().model
    names = p._probe_names
    return StepSpec(lambda: probe_mesh({q: p.state[q] for q in names},
                                       p.dd.mesh, p._probe_extra(p.state)))


def _astaroth_segment():
    return E.astaroth_dispatch(exchange_every=2, segment=4)


def _astaroth_segment_cost():
    return E.astaroth_segment_cost(2, 4)


# ---------------------------------------------------------------------------
# donation, transfer, recompile, precision
# ---------------------------------------------------------------------------
def _dispatch_targets() -> List:
    D = {
        "models.jacobi.step_n[xla": lambda: E.jacobi_dispatch("xla"),
        "models.jacobi.step_n[xla-temporal[s=2]":
            lambda: E.jacobi_dispatch("xla", 2),
        "models.astaroth.iter_n[": E.astaroth_dispatch,
        "parallel.exchange.make_exchange[PpermuteSlab":
            lambda: E.exchange_dispatch("PpermuteSlab"),
        "parallel.exchange.make_exchange[PpermutePacked":
            lambda: E.exchange_dispatch("PpermutePacked"),
        "parallel.exchange.make_exchange[AllGather":
            lambda: E.exchange_dispatch("AllGather"),
        "parallel.megastep.segment[k=4": _segment,
        "distributed.make_segment[": E.domain_segment_dispatch,
        "serving.ensemble.step[N=4": lambda: E.ensemble_dispatch("step"),
        "serving.ensemble.segment[N=4,k=2":
            lambda: E.ensemble_dispatch("segment"),
        "serving.ensemble.set_lane[N=4":
            lambda: E.ensemble_dispatch("set_lane"),
        "models.pic.step[": E.pic_dispatch,
        "models.pic.segment[k=4": lambda: E.pic_dispatch(4),
        "serving.fleet.admission[": E.fleet_dispatch,
        "resilience.health.step+probe[": E.health_dispatch,
        "observatory.attribution.segment[":
            lambda: E.attributed(_segment()),
        "observatory.attribution.pic_step[":
            lambda: E.attributed(E.pic_dispatch(), 1),
    }
    donation = ("models.jacobi.step_n[xla",
                "models.jacobi.step_n[xla-temporal[s=2]",
                "models.astaroth.iter_n[",
                "parallel.exchange.make_exchange[PpermuteSlab",
                "parallel.exchange.make_exchange[PpermutePacked",
                "parallel.exchange.make_exchange[AllGather",
                "parallel.megastep.segment[k=4", "distributed.make_segment[",
                "serving.ensemble.step[N=4", "serving.ensemble.segment[N=4,k=2",
                "serving.ensemble.set_lane[N=4", "models.pic.step[",
                "models.pic.segment[k=4")
    transfer = ("models.jacobi.step_n[xla", "models.astaroth.iter_n[",
                "parallel.exchange.make_exchange[PpermutePacked",
                "parallel.megastep.segment[k=4", "serving.ensemble.step[N=4",
                "serving.ensemble.segment[N=4,k=2", "serving.fleet.admission[",
                "models.pic.step[", "resilience.health.step+probe[",
                "observatory.attribution.segment[",
                "observatory.attribution.pic_step[")
    recompile = ("models.jacobi.step_n[xla", "models.astaroth.iter_n[",
                 "parallel.exchange.make_exchange[PpermutePacked",
                 "parallel.megastep.segment[k=4", "serving.ensemble.step[N=4",
                 "serving.ensemble.segment[N=4,k=2", "serving.fleet.admission[",
                 "models.pic.step[", "observatory.attribution.segment[")

    def name(stem, tag):
        return stem + (f",{tag}]" if not stem.endswith("[") else f"{tag}]")

    out: List = []
    out += [DonationTarget(name(s, "donation"), D[s]) for s in donation]
    out += [TransferTarget(name(s, "transfer"), D[s]) for s in transfer]
    out += [RecompileTarget(name(s, "recompile"), D[s]) for s in recompile]
    return out


def _precision_targets() -> List:
    P = "analysis.precision."
    out = []
    for method, key, fmt, layout in (
            ("PpermuteSlab", "", None, "slab"),
            ("PpermuteSlab", ",wire=bf16", "bf16", "slab"),
            ("PpermuteSlab", ",layout=irredundant", None, "irredundant"),
            ("PpermutePacked", "", None, "slab"),
            ("PpermutePacked", ",wire=bf16", "bf16", "slab"),
            ("PpermutePacked", ",layout=irredundant", None, "irredundant"),
            ("PpermuteSlab", ",wire=e4m3", "e4m3", "slab"),
            ("PpermuteSlab", ",wire=e4m3,layout=irredundant", "e4m3",
             "irredundant")):
        out.append(PrecisionTarget(
            f"{P}parallel.exchange.make_exchange[{method}{key}]",
            lambda m=method, f=fmt, lay=layout: E.exchange_precision(
                m, f, lay)))
    for name, build in (
            ("models.jacobi.step_n", lambda: E.jacobi_dispatch("xla")),
            ("models.astaroth.iter_n", E.astaroth_dispatch),
            ("models.astaroth.segment", _astaroth_segment),
            ("parallel.megastep.segment", _segment),
            ("distributed.segment", E.domain_segment_dispatch),
            ("models.pic.step", E.pic_dispatch),
            ("models.pic.segment", lambda: E.pic_dispatch(4)),
            ("serving.ensemble.step_n",
             lambda: E.ensemble_dispatch("step")),
            ("serving.ensemble.segment",
             lambda: E.ensemble_dispatch("segment"))):
        out.append(PrecisionTarget(P + name,
                                   lambda b=build: E.precision_of(b())))
    return out


# ---------------------------------------------------------------------------
# vmem and tiling
# ---------------------------------------------------------------------------
def _plan_targets() -> List:
    out: List = []
    for kernel, build in PLANS.items():
        name = kernel if kernel.endswith("]") or kernel in (
            "ops.pallas_stencil.jacobi7_pallas",
            "ops.pallas_stencil.laplace6_pallas",
            "ops.pallas_stencil.jacobi7_wrap_pallas",
            "ops.pallas_mhd.mhd_substep_wrap_pallas",
            "ops.pallas_mhd.mhd_substep01_wrap_pallas",
            "ops.pallas_halo.mhd_substep_halo_pallas",
            "ops.pallas_halo.mhd_substep01_halo_pallas") \
            else kernel + "[vmem]"
        out.append(VmemTarget(name, lambda b=build: small_plan(b)))
        for n in SIZES:
            out.append(TilingTarget(
                f"analysis.tiling.{kernel}[{n}]",
                lambda b=build, n=n: b(n), TILING_EXPECT[(kernel, n)]))
    return out


def default_targets(card: bool = True) -> List:
    """Every registered target (``card``: the ``cuda.`` group too, which
    ``run_targets`` skips where no sm_90 card is)."""
    from .card import card_targets

    out = (_footprint_targets() + _dma_schedule_targets()
           + _message_targets() + _dispatch_targets()
           + _precision_targets() + _plan_targets())
    if card:
        out += card_targets()
    return out


def load_targets(path) -> List:
    """The ``TARGETS`` list of a fixture module at ``path``."""
    p = Path(path)
    if not p.is_file():
        raise OSError(f"no fixture file {p}")
    name = f"_torch_lint_fixture_{p.stem}"
    spec = importlib.util.spec_from_file_location(name, p)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(name, None)
    targets = getattr(mod, "TARGETS", None)
    if not targets:
        raise ValueError(f"{p} defines no TARGETS")
    return list(targets)
