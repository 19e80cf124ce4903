"""The port's analysis checkers: registry, CLI and 13 checkers.

PyTorch-port counterpart of ``stencil_tpu/analysis``. JAX's checkers read
traced jaxprs and lowered StableHLO; the port runs eager PyTorch and
hand-written kernels, so each of its checkers proves the same invariant
on what the port runs, at small sizes on the CPU over the plain twins
and, for the ``cuda.`` targets, over the kernels on the card:

* ``footprint``   — a stencil op or kernel reads no cell beyond its
  declared Radius in any of the 26 directions (NaN poisoned halo boxes);
* ``dma``         — every remote store waits, in its own stream, for
  the reader of the buffer's previous contents, and every flag wait has
  its signal;
* ``collectives`` — every message meets its receive, and along each
  axis the messages form a permutation of each mesh line;
* ``hlo``         — every exchange moves point-to-point messages only
  (a recording ``torch.distributed``), a whole step none at all;
* ``costmodel``   — the probed wire bytes equal the byte model exactly,
  with FLOPs by JAX's weights over the aten ops;
* ``vmem``        — each kernel's launch fits a Hopper block at its own
  ragged small shape; on the card the builds' registers and spills;
* ``donation``    — an entry JAX donates updates its carry in place;
* ``transfer``    — no host sync in a hot path (the op log; on the card
  the sync-debug guard too);
* ``recompile``   — no kernel build after the first dispatch, and a
  dispatch-stable carry;
* ``tiling``      — each planner's launch at 256^3 and 512^3 fits 227 KB
  a block and covers its output once (a pinned verdict table); on the
  card the occupancy at the planned launch;
* ``linkmap``     — the per-(src, dst) traffic matrix equals the probed
  messages link by link;
* ``schedule``    — the remote-write flag and event schedules certified
  replay-safe over many interleavings (``ScheduleCertificate``, which
  the Jacobi ``overlap`` segment consumes);
* ``precision``   — the dtype flow: accumulation floor, declared
  conversions only, per-axis wire dtypes (``PrecisionCertificate``).

Run ``python -m stencil_tpu_torch.analysis`` (exit 1 on an error
finding, 2 on a usage error; ``--json``, ``--only``, ``--list``), or
:func:`run_targets` over :func:`registry.default_targets`.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional, Sequence

from .report import ERROR, WARNING, Finding, Report

CHECKERS = ("footprint", "dma", "collectives", "hlo", "costmodel",
            "vmem", "donation", "transfer", "recompile", "tiling",
            "linkmap", "schedule", "precision")

CHECKER_DOC = {
    "footprint": "26-direction reads (NaN-poisoned halo boxes) vs the "
                 "declared Radius; slab filler unread on the card",
    "dma": "every remote store waits for its buffer's last reader; every "
           "flag wait has its signal",
    "collectives": "every message meets its receive; messages permute "
                   "each mesh line",
    "hlo": "point-to-point messages only (recorded torch.distributed); "
           "whole steps call none",
    "costmodel": "probed wire bytes == the byte model exactly; FLOPs by "
                 "JAX's weights",
    "vmem": "launches fit a Hopper block at ragged small shapes; build "
            "registers and spills on the card",
    "donation": "donated entries update their carry in place (data_ptr, "
                "allocations)",
    "transfer": "no host sync in hot paths (aten op log; sync-debug "
                "guard on the card)",
    "recompile": "no kernel build after the first dispatch; "
                 "dispatch-stable carry",
    "tiling": "planned launches at 256^3/512^3 fit 227 KB and cover "
              "their output once; card occupancy",
    "linkmap": "per-link traffic matrix == probed messages, link by link",
    "schedule": "flag/event schedules certified replay-safe "
                "(happens-before over interleavings, k-fold replay)",
    "precision": "dtype flow: >= f32 accumulation, declared converts "
                 "only, exact per-axis wire dtypes",
}

__all__ = ["CHECKERS", "CHECKER_DOC", "ERROR", "WARNING", "Finding",
           "Report", "run_targets"]


def _dispatch(kind: str):
    from . import (collectives, costmodel, dma, donation, footprint, hlo,
                   precision, recompile, schedule, tiling, transfer, vmem)
    from ..observatory import linkmap

    table = {
        "footprint": footprint.check_footprint,
        "dma": dma.check_dma,
        "collectives": collectives.check_collectives,
        "hlo": hlo.check_hlo,
        "costmodel": costmodel.check_costmodel,
        "vmem": vmem.check_vmem,
        "donation": donation.check_donation,
        "transfer": transfer.check_transfer,
        "recompile": recompile.check_recompile,
        "tiling": tiling.check_tiling,
        "linkmap": linkmap.check_linkmap,
        "schedule": schedule.check_schedule,
        "precision": precision.check_precision,
    }
    return table[kind]


def _card_check(target):
    """The checker of a ``cuda.`` target (its own kind)."""
    from . import vmem

    inner = target.inner
    if isinstance(inner, vmem.BuildTarget):
        return vmem.check_build(inner)
    if isinstance(inner, vmem.OccupancyTarget):
        return vmem.check_occupancy(inner)
    return _dispatch(inner.checker)(inner)


def run_targets(targets: Iterable,
                checkers: Optional[Sequence[str]] = None) -> Report:
    """Run each target through its checker; aggregate into a Report. A
    checker returns ``findings`` or ``(findings, metrics)``; metrics
    land in ``report.metrics["<checker>:<target>"]``, per-checker wall
    time in ``report.checker_seconds``. A ``cuda.`` target where no
    sm_90 card is present is skipped with a metric saying why."""
    from .vmem import card_available

    enabled = set(checkers) if checkers else set(CHECKERS)
    unknown = enabled - set(CHECKERS)
    if unknown:
        raise ValueError(f"unknown checkers {sorted(unknown)}; "
                         f"available: {list(CHECKERS)}")
    report = Report()
    no_card = None
    for target in targets:
        kind = getattr(target, "checker", None)
        if kind not in CHECKERS:
            report.findings.append(Finding(
                "runner", getattr(target, "name", repr(target)),
                f"unknown target kind {type(target).__name__}"))
            continue
        if kind not in enabled:
            continue
        report.targets_checked.append(target.name)
        card = getattr(target, "card", False)
        if card:
            no_card = no_card if no_card is not None else (
                card_available() or "")
            if no_card:
                report.metrics[f"{kind}:{target.name}"] = {
                    "skipped": f"needs an sm_90 card ({no_card})"}
                continue
        t0 = time.perf_counter()
        try:
            result = (_card_check(target) if card
                      else _dispatch(kind)(target))
        except Exception as e:  # noqa: BLE001 - a crash is a finding
            result = [Finding(kind, target.name,
                              f"checker crashed: {type(e).__name__}: {e}")]
        report.checker_seconds[kind] = (
            report.checker_seconds.get(kind, 0.0)
            + time.perf_counter() - t0)
        if isinstance(result, tuple):
            findings, metrics = result
            if metrics:
                report.metrics[f"{kind}:{target.name}"] = metrics
        else:
            findings = result
        report.extend(findings)
    return report
