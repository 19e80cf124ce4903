"""Measurement-driven exchange autotuning with a persistent plan cache.

PyTorch-port counterpart of ``stencil_tpu/tuning``. The reference
measures the machine and routes every halo message over the fastest
transport for its pair (reference: src/stencil.cu:371-458); this
package turns the static priority list of ``parallel/methods.py`` into
a measured decision, in four steps:

1. **measure** (:mod:`.measure`) — ring shifts calibrate the link's
   alpha-beta coefficients; short loops of the deployed exchange engines
   time whole candidate configurations;
2. **fit** (:mod:`.fit`) — least squares over the ring-shift samples;
3. **plan** (:mod:`.plan`) — the calibrated cost model
   (``analysis/costmodel.configured_step_seconds``) ranks every
   feasible (method, overlap, depth, wire) candidate and prunes the
   sweep to the few worth timing; the measured winner becomes the
   :class:`Plan`;
4. **cache** (:mod:`.cache`) — the plan persists under a fingerprint of
   platform, mesh, grid, radius, dtypes and library version; a hit
   skips measurement.

Entry points: ``DistributedDomain.autotune()`` and ``Method.Auto`` at
``realize()``, ``python -m stencil_tpu_torch.tune`` and
``apps/bench_exchange.py --autotune``. ``FakeTimer`` makes the whole
search deterministic on the CPU.
"""

from __future__ import annotations

import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

from ..analysis.costmodel import (LinkCoefficients, configured_step_seconds,
                                  predict_exchange_every)
from ..utils.logging import LOG_INFO
from .cache import default_cache_path, invalidate_plan, load_plan, store_plan
from .fit import calibrate_link, coefficients_record, fit_alpha_beta
from .measure import CountingTimer, FakeTimer, MeshTimer
from .plan import (DEFAULT_DEPTHS, Candidate, MigrationCandidate, Plan,
                   TuneGeometry, candidate_space, fingerprint,
                   fingerprint_inputs, migration_candidate_space,
                   rank_migration_candidates, tiling_record)

__all__ = [
    "Candidate", "MigrationCandidate", "Plan", "TuneGeometry",
    "FakeTimer", "MeshTimer", "CountingTimer", "LinkCoefficients",
    "autotune_domain", "run_autotune", "candidate_space",
    "migration_candidate_space", "rank_migration_candidates",
    "tiling_record", "calibrate_link", "fit_alpha_beta", "fingerprint",
    "fingerprint_inputs", "default_cache_path", "load_plan", "store_plan",
    "invalidate_plan", "DEFAULT_DEPTHS", "geometry_from_domain",
    "inputs_from_domain",
]


def run_autotune(geom: TuneGeometry, inputs: Dict, timer,
                 read_cache: bool = True, write_cache: bool = True,
                 cache_path=None,
                 depths: Sequence = DEFAULT_DEPTHS,
                 overlap_options: Sequence[bool] = (False,),
                 max_measurements: int = 4,
                 runnable=None, topology: "Dict | None" = None,
                 wire_formats: Sequence[str] = ("f32",),
                 wire_layouts: Sequence[str] = ("slab",),
                 dcn_axis: "int | None" = None,
                 placement: str = "auto",
                 agree=None) -> Plan:
    """The search (JAX ``tuning/__init__.py:70-249``), the timer
    injected: cache lookup, alpha-beta calibration, model-ranked
    pruning to ``max_measurements`` timed candidates, the plan store.

    ``topology``: a measured topology-fingerprint record
    (``observatory.linkmap.measure_topology``) whose per-link
    coefficients replace the ring-shift calibration. ``dcn_axis``: the
    host-blocked axis; it adds the candidates that deepen only that axis
    and prices per-axis candidates per link. ``runnable`` filters the
    methods (default: every transport, as the port runs them all).
    ``agree``: on a mesh over processes, a collective that returns rank
    0's copy of a picklable value; every rank then ranks with rank 0's
    fitted coefficients, so that all time the same candidates (the
    timings are collective exchanges)."""
    fp = fingerprint(inputs)
    if read_cache:
        plan = load_plan(fp, cache_path)
        if plan is not None:
            plan.provenance = "cached"
            plan.measurements = 0
            LOG_INFO(f"autotune: plan cache hit for {fp[:12]}... -> "
                     f"{plan.config.key()} (no measurements)")
            return plan

    counted = CountingTimer(timer)

    # fit: measured alpha-beta per link class; the sweeps are sequential,
    # so for ranking the classes combine as the bottleneck link
    if topology is not None:
        from ..observatory.linkmap import topology_coefficients
        links = topology_coefficients(topology)
    else:
        links = {"ici": calibrate_link(counted.pingpong)}
        if getattr(counted, "has_dcn", False):
            links["dcn"] = calibrate_link(counted.pingpong_dcn)
    if agree is not None:
        # each rank's host clock fits its own coefficients: one rank's
        # fit must rank the candidates on every rank
        links = {k: LinkCoefficients(**v) for k, v in
                 agree(coefficients_record(links)).items()}
    coeffs = LinkCoefficients(
        alpha_s=max(c.alpha_s for c in links.values()),
        beta_bytes_per_s=min(c.beta_bytes_per_s for c in links.values()))

    # plan: rank every feasible candidate with the calibrated model
    sweep = list(depths)
    if dcn_axis is not None:
        name = "xyz"[dcn_axis]
        sweep += [{name: int(s)} for s in depths
                  if isinstance(s, int) and s > 1]
    cands = candidate_space(geom, depths=sweep,
                            overlap_options=overlap_options,
                            runnable=runnable, wire_formats=wire_formats,
                            wire_layouts=wire_layouts)
    if not cands:
        raise ValueError("no feasible exchange configuration for this "
                         "geometry (shards smaller than the radius?)")
    per_link = dict(links)
    if dcn_axis is not None and "dcn" not in per_link:
        from ..analysis.costmodel import DEFAULT_DCN_COEFFS
        per_link["dcn"] = DEFAULT_DCN_COEFFS

    def _predict(c: Candidate) -> float:
        if c.depths is not None and len(set(c.depths)) > 1:
            return configured_step_seconds(
                c.method, geom.shard_interior_zyx, geom.radius,
                geom.counts, geom.elem_sizes, c.depths, per_link,
                geom.dtype_groups, wire_format=c.wire_format,
                wire_layout=c.wire_layout, dcn_axis=dcn_axis)
        return configured_step_seconds(
            c.method, geom.shard_interior_zyx, geom.radius,
            geom.counts, geom.elem_sizes, c.exchange_every, coeffs,
            geom.dtype_groups, wire_format=c.wire_format,
            wire_layout=c.wire_layout)

    predicted = {c: _predict(c) for c in cands}
    ranked = sorted(cands, key=lambda c: predicted[c])

    best_depth: Optional[int] = None
    try:
        best_depth, _ = predict_exchange_every(
            geom.shard_interior_zyx, geom.radius, geom.counts,
            max(geom.elem_sizes), coeffs.alpha_s * 6,
            coeffs.beta_bytes_per_s, candidates=tuple(depths))
    except ValueError:
        pass

    survivors = ranked[:max(int(max_measurements), 1)]
    pruned = len(ranked) - len(survivors)

    # measure the survivors
    measured: List[Tuple[float, Candidate]] = []
    spread: Dict[Candidate, Tuple[float, float]] = {}
    for c in survivors:
        per_step = counted.exchange_round(c, geom) / c.exchange_every
        measured.append((per_step, c))
        windows = counted.last_windows
        if windows:
            spread[c] = (min(windows) / c.exchange_every,
                         max(windows) / c.exchange_every)
    win_s, winner = min(measured,
                        key=lambda t: (t[0], survivors.index(t[1])))

    costs = {}
    for c in cands:
        rec = {"predicted_s": predicted[c]}
        for s, mc in measured:
            if mc == c:
                rec["measured_s"] = s
        if c in spread:
            rec["measured_min_s"], rec["measured_max_s"] = spread[c]
        costs[c.key()] = rec

    plan = Plan(config=winner, fingerprint=fp,
                coefficients=coefficients_record(links),
                costs=costs, provenance="tuned",
                measurements=counted.calls,
                created=_time.time(),
                library_version=str(inputs.get("library_version", "")),
                fingerprint_inputs=dict(inputs),
                predicted_best_depth=best_depth,
                tiling=tiling_record(geom),
                placement=str(placement))
    LOG_INFO(f"autotune: measured {len(survivors)}/{len(cands)} "
             f"candidates (pruned {pruned} by the calibrated model; "
             f"depth crossover predicts s={best_depth}) -> "
             f"{winner.key()} at {win_s:.3e}s/step "
             f"[alpha={coeffs.alpha_s:.2e}s "
             f"beta={coeffs.beta_bytes_per_s:.2e}B/s]")
    if write_cache:
        store_plan(plan, cache_path)
    return plan


# ---------------------------------------------------------------------------
# DistributedDomain adapters


def geometry_from_domain(dd, dim) -> TuneGeometry:
    """Per-shard tuning geometry of a configured (not yet realized)
    ``DistributedDomain`` over the partition ``dim``."""
    from ..geometry import Dim3
    from ..numerics import div_ceil
    from ..topology import Boundary

    local = Dim3(*(div_ceil(dd.size[a], dim[a]) for a in range(3)))
    rem = dd.size % dim
    min_local = Dim3(*(local[a] - (1 if rem[a] else 0) for a in range(3)))
    return TuneGeometry(
        shard_interior_zyx=(local.z, local.y, local.x),
        min_interior_zyx=(min_local.z, min_local.y, min_local.x),
        radius=dd.radius, counts=Dim3.of(dim),
        elem_sizes=tuple(dd._dtypes[q].itemsize for q in dd._names),
        uneven=rem != Dim3(0, 0, 0),
        nonperiodic=dd.boundary == Boundary.NONE,
        dtype_strs=tuple(dtype_name(dd._dtypes[q]) for q in dd._names))


def dtype_name(dtype) -> str:
    """numpy's name of a torch dtype (``float32``; ``bfloat16`` as is),
    the spelling JAX's fingerprints carry."""
    return str(dtype).replace("torch.", "")


def inputs_from_domain(dd, dim) -> Dict:
    """Fingerprint inputs of a configured ``DistributedDomain``: the
    platform is ``"gpu"`` with the card's name on CUDA devices,
    ``"cpu"`` otherwise."""
    dev = dd._devices[0] if dd._devices else None
    platform, kind = "cpu", ""
    if dev is not None and dev.type == "cuda":
        import torch

        platform = "gpu"
        kind = torch.cuda.get_device_name(dev)
    depths = getattr(dd, "exchange_depths", None)
    return fingerprint_inputs(
        platform=platform, device_count=len(dd._devices),
        mesh_shape=list(dim), grid=list(dd.size), radius=dd.radius,
        quantities={q: dtype_name(dd._dtypes[q]) for q in dd._names},
        boundary=dd.boundary.name, n_slices=dd.n_slices,
        wire_format=getattr(dd, "wire_format", "f32"),
        wire_layout=getattr(dd, "wire_layout", "slab"),
        exchange_depths=tuple(depths) if depths is not None else None,
        placement=getattr(dd, "placement_mode", "auto"),
        device_kind=kind)


def autotune_domain(dd, timer=None, use_cache: bool = True,
                    force: bool = False, cache_path=None,
                    depths: Sequence = DEFAULT_DEPTHS,
                    overlap_options: Sequence[bool] = (False,),
                    max_measurements: int = 4,
                    topology_path=None,
                    wire_formats: Sequence[str] = ("f32",),
                    wire_layouts: Sequence[str] = ("slab",)) -> Plan:
    """Autotune a configured ``DistributedDomain`` (JAX
    ``tuning/__init__.py:288-383``; call ``DistributedDomain.autotune``).
    Chooses the partition realize() will use, builds the real
    :class:`MeshTimer` over a throwaway mesh of that shape in the
    deployed placement (unless a timer is injected), and runs the
    search. Does not apply the plan.
    ``topology_path`` (or ``$STENCIL_TOPOLOGY_CACHE``) arms the measured
    topology fingerprint (``observatory/linkmap.py``)."""
    import os as _os

    dim = dd._choose_partition_dim()
    geom = geometry_from_domain(dd, dim)
    inputs = inputs_from_domain(dd, dim)
    if topology_path is None and _os.environ.get("STENCIL_TOPOLOGY_CACHE"):
        topology_path = _os.environ["STENCIL_TOPOLOGY_CACHE"]
    if timer is None:
        from ..geometry import Dim3
        from ..numerics import div_ceil
        from ..parallel.mesh import Mesh

        local = Dim3(*(div_ceil(dd.size[a], dim[a]) for a in range(3)))
        # time the fabric realize() will deploy: the same placement
        placement = dd._choose_placement(dim, dd._discover_dcn_groups())
        mesh = Mesh(dim, placement.slot_order_for_mesh())
        timer = MeshTimer(mesh, local, [dd._dtypes[q] for q in dd._names],
                          rem=dd.size % dim, nonperiodic=geom.nonperiodic,
                          dcn_axis=(dd.dcn_axis if dd.n_slices > 1
                                    else None))
    # a mesh over processes: every rank measures the same topology and the
    # same candidates (the timings are collective) unless every rank has
    # the cached record, ranks with rank 0's fit, rank 0 alone writes the
    # caches, and every rank adopts rank 0's plan
    from ..parallel.mesh import this_rank

    me = this_rank()
    collective = any(g.rank != me for g in dd._global)
    agree = None
    if collective:
        from ..parallel.multihost import all_gather_objects

        def agree(obj):
            return all_gather_objects(obj)[0]
    topology = None
    if topology_path:
        from ..observatory.linkmap import (load_topology, measure_topology,
                                           save_topology,
                                           topology_fingerprint,
                                           topology_fingerprint_inputs)
        topo_inputs = topology_fingerprint_inputs(
            platform=inputs["platform"],
            device_count=inputs["device_count"],
            mesh_shape=inputs["mesh_shape"], n_slices=inputs["n_slices"])
        topology = load_topology(topology_fingerprint(topo_inputs),
                                 topology_path)
        if collective and not all(all_gather_objects(
                topology is not None)):
            topology = None
        if topology is None and hasattr(timer, "pingpong_axis"):
            topology = measure_topology(
                timer, inputs["mesh_shape"], topo_inputs,
                dcn_axis=(dd.dcn_axis if dd.n_slices > 1 else None))
            if collective:
                topology = agree(topology)
            if not topology["links"]:
                # no multi-device axis: nothing to fingerprint
                topology = None
            else:
                if not collective or me == 0:
                    save_topology(topology, topology_path)
                LOG_INFO(f"autotune: measured topology fingerprint "
                         f"{topology['fingerprint'][:12]}... "
                         f"({len(topology['links'])} links) -> "
                         f"{topology_path}")
        elif topology is not None:
            LOG_INFO(f"autotune: topology fingerprint hit "
                     f"{topology['fingerprint'][:12]}... (per-axis "
                     f"links replace the ring-shift calibration)")
    sweep = list(depths)
    dd_depths = getattr(dd, "exchange_depths", None)
    if dd_depths is not None and len(set(tuple(dd_depths))) > 1:
        # a configured per-axis depth is always ranked
        sweep.append(tuple(dd_depths))
    read = use_cache and not force
    if collective and read:
        read = all(all_gather_objects(
            load_plan(fingerprint(inputs), cache_path) is not None))
    plan = run_autotune(geom, inputs, timer, read_cache=read,
                        write_cache=use_cache and (not collective
                                                   or me == 0),
                        cache_path=cache_path,
                        depths=sweep, overlap_options=overlap_options,
                        max_measurements=max_measurements,
                        topology=topology, wire_formats=wire_formats,
                        wire_layouts=wire_layouts,
                        dcn_axis=(dd.dcn_axis if dd.n_slices > 1
                                  else None),
                        placement=getattr(dd, "placement_mode", "auto"),
                        agree=agree)
    if collective:
        plan = Plan.from_record(agree(plan.to_record()))
    return plan
