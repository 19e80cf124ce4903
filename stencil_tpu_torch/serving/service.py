"""The async multi-tenant campaign service.

PyTorch-port counterpart of ``stencil_tpu/serving/service.py``. One
:class:`CampaignService` owns a request queue, a cache of ensemble
engines keyed by problem fingerprint, and the persistent tuning-plan
cache. The worker loop:

1. **admit** — pop the oldest request plus every fingerprint-identical
   one (:meth:`..serving.queue.RequestQueue.pop_batch`) into one batch
   of at most ``width`` members;
2. **plan** — a plan-cache hit supplies the exchange configuration
   with ZERO measurements; a miss tunes once (injectable timer; depth
   pinned to 1 — the batched step exchanges every step) and persists
   the plan for every later fingerprint-identical request;
3. **engine** — the engine cache returns the already-built engine for a
   known fingerprint (its kernels already built: zero recompiles); only
   a brand-new fingerprint constructs an engine;
4. **run** — the segment loop advances ALL lanes per dispatch,
   probing per-member health, streaming snapshots through non-blocking
   event polling, checkpointing each campaign into its tenant
   namespace, and rolling back ONLY the tripped member's lane on a
   fault (bounded retries per campaign, then the campaign fails while
   its batch-mates keep running);
5. **preempt/resume** — :meth:`CampaignService.preempt` checkpoints
   every active campaign (tagged ``preempted``) and stops; resubmitting
   a campaign whose namespace holds checkpoints resumes it from the
   newest restorable step.

Observability is the port's telemetry layer (:mod:`..telemetry`):
events flow through the versioned :class:`~..telemetry.EventLog` into a
BOUNDED in-memory ring, spans (campaign.batch -> segment ->
compile/tune/checkpoint/rollback) export as Chrome trace JSON via
:meth:`CampaignService.export_trace`, and the metric surface
(:meth:`CampaignService.metrics_text` Prometheus text /
:meth:`~CampaignService.metrics_snapshot` JSON, served over HTTP by
``apps/serve.py --metrics-port``) carries the warm-path gates — zero
``stencil_service_recompiles_total``, zero
``stencil_service_tuner_measurements_total`` on cache hits.

The service runs on the card(s) it is given (``devices=None``: every
visible card); its ``start()`` worker thread makes the first card its
current device. It has one controller, as JAX's does: devices that span
processes raise at construction.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..analysis.recompile import (ASSERT_SINGLE_COMPILE_ENV,
                                  SingleCompileGuard)
from ..analysis.transfer import hot_loop_transfer_guard
from ..topology import Boundary
from ..utils.checkpoint import all_steps, validate_checkpoint_component
from ..utils.logging import LOG_INFO, LOG_WARN
from ..utils.timers import device_sync
from .ensemble import (EnsembleAstaroth, EnsembleJacobi, EnsembleSentinel,
                       request_domain, spans_ranks, storage_dtype)
from .queue import CampaignRequest, RequestQueue


class CampaignFailed(RuntimeError):
    """A campaign exhausted its per-tenant retry budget."""


class ReplicaCrashed(RuntimeError):
    """Deterministic chaos: this replica was hard-killed mid-batch
    (see :meth:`CampaignService.arm_crash_at`). Unlike preemption,
    NOTHING is checkpointed or resolved on the way out — in-RAM lane
    state newer than the last periodic checkpoint is lost, exactly
    like a real process death. The fleet recovers the replica's
    campaigns from their per-tenant checkpoint namespaces."""


def _block_state(eng) -> None:
    """Fence the ensemble's live state: a synchronize of its cards (the
    attribution clock must not credit queued work with seconds it merely
    deferred)."""
    device_sync(eng.state_tensors())


@dataclasses.dataclass
class ServiceStats:
    """Counters the CI service smoke asserts on."""

    batches: int = 0
    compiles: int = 0            # engine constructions (new fingerprint)
    plan_cache_hits: int = 0
    tuner_measurements: int = 0  # total timer invocations
    completed: int = 0
    failed: int = 0
    rollbacks: int = 0

    def to_record(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CampaignResult:
    """What a completed campaign hands back to its tenant."""

    tenant: str
    campaign: str
    steps: int
    rollbacks: int = 0
    resumed_from: Optional[int] = None
    preempted: bool = False
    #: (member_step, {quantity: global interior}) in step order
    snapshots: List = dataclasses.field(default_factory=list)
    #: {quantity: global interior} at the final step
    final: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Lane:
    """One campaign's slot in a running batch."""

    entry: object                # queue._Entry
    index: int                   # lane index in the ensemble
    ckpt_dir: str
    counter: int = 0             # member steps completed
    rollbacks: int = 0
    resumed_from: Optional[int] = None
    active: bool = True
    chaos_fired: bool = False
    snapshots: Dict[int, Dict[str, np.ndarray]] = \
        dataclasses.field(default_factory=dict)

    @property
    def request(self) -> CampaignRequest:
        return self.entry.request


class CampaignService:
    """Batched multi-tenant campaign server over one device set."""

    def __init__(self, root_dir: str, devices=None, width: int = 8,
                 tuner_timer=None, plan_cache_path=None,
                 window: int = 8, growth_factor: float = 1e6,
                 max_to_keep: int = 3, events_capacity: int = 4096,
                 run_id: Optional[str] = None, registry=None,
                 tracer=None, fuse_segments: bool = True,
                 flight_recorder_dir: Optional[str] = None,
                 attribute_perf: bool = True,
                 drift_tolerance: float = 0.5, drift_window: int = 3,
                 retune_on_drift: bool = False) -> None:
        if int(width) < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        if spans_ranks(devices):
            raise NotImplementedError(
                "CampaignService has one controller (as the JAX "
                "package's): its devices must not span processes — run "
                "one service per rank on that rank's cards, or a Fleet")
        #: megastep mode (default): each batch segment is ONE fused
        #: dispatch carrying the per-member probe trace in-graph
        #: (parallel/megastep.py) instead of a step loop + separate
        #: probe dispatch
        self._fuse = bool(fuse_segments)
        self.root = Path(root_dir)
        self.root.mkdir(parents=True, exist_ok=True)
        self.width = int(width)
        self._devices = devices
        self._tuner_timer = tuner_timer
        self._plan_cache_path = plan_cache_path
        self._window = int(window)
        self._growth_factor = float(growth_factor)
        self._max_to_keep = int(max_to_keep)
        self.queue = RequestQueue(devices,
                                  on_expired=self._on_request_expired)
        self.stats = ServiceStats()
        # unified telemetry: events through the versioned EventLog into
        # a BOUNDED ring (a long-running service holds flat memory over
        # millions of requests; `dropped` in the payload makes the
        # truncation visible), metrics through a per-service registry,
        # spans through a per-service tracer sharing the run id
        from ..telemetry import (EventLog, MetricsRegistry, RingSink,
                                 Tracer)
        self._ring = RingSink(events_capacity)
        self._elog = EventLog(run_id=run_id, sinks=(self._ring,))
        self.run_id = self._elog.run_id
        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None \
            else Tracer(run_id=self.run_id)
        self._register_metrics()
        self._engines: Dict[str, object] = {}
        #: fingerprints EVER built — a construction for a known
        #: fingerprint is a recompile (warm-path regression)
        self._built: set = set()
        self._sentinels: Dict[str, EnsembleSentinel] = {}
        #: recompile watchdog (analysis/recompile.py): armed via
        #: STENCIL_ASSERT_SINGLE_COMPILE=1 — a cached engine whose
        #: step/segment programs re-trace between dispatches raises
        #: instead of silently recompiling per batch
        self._compile_guard = (
            SingleCompileGuard()
            if os.environ.get(ASSERT_SINGLE_COMPILE_ENV) == "1"
            else None)
        # performance observatory: per-engine model-vs-measured
        # attribution (observatory/attribution.py — host wall clock,
        # the dispatched program is unchanged) and the bounded flight
        # recorder (observatory/recorder.py) dumped on sentinel trip,
        # preemption, and unhandled batch errors
        self._attribute = bool(attribute_perf)
        self._drift_tolerance = float(drift_tolerance)
        self._drift_window = int(drift_window)
        self._retune_on_drift = bool(retune_on_drift)
        self._attributors: Dict[str, object] = {}
        from ..observatory.recorder import ENV_FLIGHT_DIR, FlightRecorder
        self._flight_dir = (flight_recorder_dir
                            or os.environ.get(ENV_FLIGHT_DIR) or None)
        self.flight = None
        if self._flight_dir:
            self.flight = FlightRecorder(run_id=self.run_id,
                                         registry=self.metrics,
                                         tracer=self.tracer)
            self._elog.add_sink(self.flight)
        self._preempt = False
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        #: the card the worker thread makes current (None on the CPU)
        self._card = self._first_card(devices)
        # deterministic chaos thresholds (member steps), armed by the
        # fleet's fault plan; checked at segment boundaries
        self._crash_at_step: Optional[int] = None
        self._preempt_at_step: Optional[int] = None

    def _register_metrics(self) -> None:
        """Declare the service metric surface (names and labels are a
        stable contract, the JAX package's)."""
        m = self.metrics
        self._m_requests = m.counter(
            "stencil_service_requests_total",
            "campaign requests submitted, by tenant")
        self._m_queue_depth = m.gauge(
            "stencil_service_queue_depth",
            "requests waiting for admission")
        self._m_admission = m.histogram(
            "stencil_service_admission_latency_seconds",
            "submit-to-batch-start latency")
        self._m_batches = m.counter(
            "stencil_service_batches_total", "ensemble batches served")
        self._m_occupancy = m.gauge(
            "stencil_service_batch_occupancy_ratio",
            "members / width of the last admitted batch")
        self._m_compiles = m.counter(
            "stencil_service_compiles_total",
            "engine constructions (every build; recompiles_total "
            "counts the already-seen-fingerprint subset)")
        self._m_recompiles = m.counter(
            "stencil_service_recompiles_total",
            "engine constructions for an ALREADY-SEEN fingerprint — "
            "warm-path regressions; 0 on a healthy service")
        self._m_engine_hits = m.counter(
            "stencil_service_engine_cache_hits_total",
            "batches served by an already-built engine")
        self._m_engine_size = m.gauge(
            "stencil_service_engine_cache_size", "engines resident")
        self._m_plan_hits = m.counter(
            "stencil_service_plan_cache_hits_total",
            "exchange plans served from the persistent cache")
        self._m_plan_misses = m.counter(
            "stencil_service_plan_cache_misses_total",
            "fingerprints that had to tune (or run untuned)")
        self._m_tuner = m.counter(
            "stencil_service_tuner_measurements_total",
            "tuner timer invocations; 0 on the warm path")
        self._m_rollbacks = m.counter(
            "stencil_service_rollbacks_total",
            "member-isolated rollbacks, by tenant")
        self._m_campaigns = m.counter(
            "stencil_service_campaigns_total",
            "campaign outcomes, by tenant and outcome "
            "(completed|failed|preempted)")
        self._m_steps = m.counter(
            "stencil_service_member_steps_total",
            "member steps advanced across all lanes")
        self._m_steps_per_s = m.gauge(
            "stencil_service_member_steps_per_s",
            "member steps/s of the last served batch")
        self._m_checkpoints = m.counter(
            "stencil_service_checkpoints_total",
            "member checkpoints written")
        self._m_snapshots = m.counter(
            "stencil_service_snapshots_total",
            "streaming snapshots enqueued")
        self._m_fused_dispatch = m.counter(
            "stencil_run_fused_dispatch_total",
            "dispatches by the batch loop, labeled "
            "fused=true (one megastep covering k member steps) or "
            "fused=false (one stepwise run dispatch) — the fleet "
            "signal for campaigns still running stepwise")
        # unlabeled counters export an explicit 0 sample from birth
        # (prometheus_client semantics): the warm-path gates assert
        # recompiles/tuner-measurements == 0 against a series that
        # EXISTS, and a scraper sees the 0 baseline before the first
        # increment; labeled counters appear on first labeled inc
        for c in (self._m_batches, self._m_compiles,
                  self._m_recompiles, self._m_engine_hits,
                  self._m_plan_hits, self._m_plan_misses,
                  self._m_tuner, self._m_steps, self._m_checkpoints,
                  self._m_snapshots):
            c.inc(0)
        for fused in ("true", "false"):
            self._m_fused_dispatch.inc(0, fused=fused)

    # ------------------------------------------------------------------
    # telemetry surfaces
    # ------------------------------------------------------------------
    @property
    def events(self) -> List[Dict]:
        """The newest events (bounded ring — see ``events_capacity``)."""
        return self._ring.records()

    def metrics_text(self) -> str:
        """Prometheus text exposition of the service metrics — the
        surface the warm-path CI gates and tests assert on (external
        contract, not internal fields)."""
        return self.metrics.to_prometheus_text()

    def metrics_snapshot(self) -> Dict:
        """JSON-serializable metrics snapshot (the CI artifact)."""
        return self.metrics.snapshot()

    def export_trace(self, path: str) -> None:
        """Chrome trace-event JSON of this service's spans (Perfetto)."""
        self.tracer.export_chrome_trace(path)

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------
    def submit(self, req: CampaignRequest):
        """Queue a campaign; returns its :class:`~.queue.
        CampaignHandle`. If the campaign's tenant namespace already
        holds checkpoints (a preempted earlier run), it resumes from
        the newest restorable step."""
        handle = self.queue.submit(req)
        self._m_requests.inc(tenant=req.tenant)
        self._m_queue_depth.set(len(self.queue))
        self._log("submitted", tenant=req.tenant, campaign=req.campaign,
                  fingerprint=handle.fingerprint)
        return handle

    def drain(self) -> None:
        """Synchronously serve batches until the queue is empty (the
        test/CLI entry; :meth:`start` is the async one)."""
        while len(self.queue) and not self._stop:
            batch = self.queue.pop_batch(self.width)
            if not batch:
                break
            self._run_batch(batch)
        self._m_queue_depth.set(len(self.queue))

    def start(self) -> None:
        """Serve from a background worker thread until :meth:`stop`."""
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._stop = False

        def worker():
            # the current device is per thread: launch on the service's
            # card, whose streams the kernels' side streams order with
            if self._card is not None:
                import torch

                torch.cuda.set_device(self._card)
            while not self._stop:
                if not self.queue.wait_nonempty(timeout=0.05):
                    continue
                batch = self.queue.pop_batch(self.width)
                if batch:
                    self._run_batch(batch)

        self._thread = threading.Thread(target=worker,
                                        name="campaign-service",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop = True
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def preempt(self) -> None:
        """Fleet reclaim: the current batch checkpoints every active
        campaign (tagged ``preempted``) at the next segment boundary
        and the worker stops; resubmitting the campaigns resumes them
        from those checkpoints."""
        self._preempt = True
        self._stop = True

    def arm_crash_at(self, member_step: int) -> None:
        """Deterministic chaos: hard-crash this replica (raise
        :class:`ReplicaCrashed` out of the serving loop) at the first
        segment boundary where any lane's member step reaches
        ``member_step``. Periodic checkpoints written BEFORE the
        boundary survive; everything newer is lost — the recovery
        path the fleet's zero-loss gate exercises."""
        self._crash_at_step = int(member_step)

    def arm_preempt_at(self, member_step: int) -> None:
        """Deterministic chaos: trip the graceful preemption path
        (checkpoint every active campaign, tagged ``preempted``) at
        the first segment boundary where any lane reaches
        ``member_step`` — the fleet's migration primitive, made
        step-deterministic for bitwise tests."""
        self._preempt_at_step = int(member_step)

    @staticmethod
    def _first_card(devices):
        """The first CUDA device of ``devices`` (None: the current
        card), or None when the service runs on the CPU."""
        import torch

        from ..distributed import resolve_device

        if devices is None:
            return resolve_device(None)
        for d in devices:
            d = torch.device(getattr(d, "device", d))
            if d.type == "cuda":
                return d
        return None

    def namespace(self, tenant: str, campaign: str) -> Path:
        """``root/<tenant>/<campaign>`` — both components validated
        against path traversal before they touch the filesystem."""
        t = validate_checkpoint_component(tenant, kind="tenant id")
        c = validate_checkpoint_component(campaign, kind="campaign id")
        return self.root / t / c

    def write_events(self, path: str) -> None:
        from ..telemetry import EVENT_SCHEMA_VERSION
        payload = {"schema": EVENT_SCHEMA_VERSION, "run": self.run_id,
                   "dropped_events": self._ring.dropped,
                   "stats": self.stats.to_record(),
                   "events": self.events}
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _log(self, kind: str, **kw) -> None:
        # events correlate with the enclosing telemetry span (if any)
        self._elog.emit(kind, span=self.tracer.current_span_id(), **kw)

    def _on_request_expired(self, entry) -> None:
        """Queue hook: a request's deadline passed before admission —
        loud (v1-schema event), never a silent drop."""
        req = entry.request
        self._log("request_expired", tenant=req.tenant,
                  campaign=req.campaign,
                  deadline_seconds=req.deadline_seconds)
        self.stats.failed += 1
        self._m_campaigns.inc(tenant=req.tenant, outcome="expired")

    def _flight_dump(self, reason: str, **attrs) -> None:
        from ..observatory.recorder import safe_dump
        safe_dump(self.flight, self._flight_dir, reason, **attrs)

    def _make_attributor(self, eng):
        """A :class:`~..observatory.PerfAttributor` for one
        cached engine, or None when its domain has no calibrated wire
        price. Gauges land in THIS service's registry (labels
        entry="service"); drift events flow through the service's
        versioned event log."""
        from ..observatory.attribution import (PerfAttributor,
                                               model_step_seconds_for)
        from ..parallel.methods import pick_method
        model = model_step_seconds_for(eng.dd)
        if not model:
            return None
        plan = getattr(eng.dd, "plan", None)
        try:
            nbytes = float(eng.dd.exchange_bytes_amortized_per_step())
        except Exception:  # noqa: BLE001 - no byte model: B/s gauges off
            nbytes = 0.0
        # per-link attribution (observatory/linkmap.py): link-class
        # gauges in THIS service's registry; the service flight
        # recorder snapshots the same classified traffic matrix
        from ..observatory.linkmap import link_attribution_for
        link = link_attribution_for(eng.dd)
        if link and self.flight is not None:
            self.flight.set_linkmap(link["summary"])
        return PerfAttributor(
            entry="service", method=pick_method(eng.dd.methods).name,
            exchange_every=int(eng.dd.exchange_every),
            model_step_seconds=model, model_bytes_per_step=nbytes,
            tolerance=self._drift_tolerance, window=self._drift_window,
            warmup=1,  # the first segment dispatch pays compilation
            emit=self._log, registry=self.metrics,
            on_drift=(self._on_perf_drift if self._retune_on_drift
                      else None),
            link_bytes_per_step=(link["bytes_per_step"] if link
                                 else None),
            link_peak_bytes_per_s=(link["peak_bytes_per_s"] if link
                                   else None),
            fingerprint=(plan.fingerprint if plan is not None
                         else None))

    def _on_perf_drift(self, attrs: Dict) -> None:
        """``retune_on_drift``: invalidate the drifted plan's cache
        record so the next fingerprint-identical tune re-measures —
        stale plans heal themselves (shared hook:
        ``observatory.make_drift_invalidator``)."""
        from ..observatory.attribution import make_drift_invalidator
        make_drift_invalidator(self._plan_cache_path, self._log)(attrs)

    def _plan_for(self, fingerprint: str, req: CampaignRequest):
        """The exchange plan for a fingerprint: cache hit (zero
        measurements) or a one-time tune when a timer is configured
        (depth pinned to 1 — see module docstring)."""
        from ..tuning import load_plan
        plan = load_plan(fingerprint, self._plan_cache_path)
        if plan is not None:
            plan.provenance = "cached"
            plan.measurements = 0
            self.stats.plan_cache_hits += 1
            self._m_plan_hits.inc()
            return plan
        self._m_plan_misses.inc()
        if self._tuner_timer is None:
            return None
        from ..tuning import autotune_domain
        dd = request_domain(req, self._devices)
        with self.tracer.span("tune", fingerprint=fingerprint):
            plan = autotune_domain(dd, timer=self._tuner_timer,
                                   cache_path=self._plan_cache_path,
                                   depths=(1,))
        assert plan.fingerprint == fingerprint, \
            (plan.fingerprint, fingerprint)
        self.stats.tuner_measurements += plan.measurements
        self._m_tuner.inc(plan.measurements)
        return plan

    def _engine_key(self, fingerprint: str, req: CampaignRequest) -> str:
        """The engine-cache key: the problem fingerprint PLUS the
        fusion geometry — a megastep engine compiles segments per
        ``check_every``, so differently-fused requests must not collide
        on one cache slot (they would thrash segment compiles and lie
        to the recompile counter)."""
        if not self._fuse:
            return fingerprint
        return f"{fingerprint}|ck={int(req.check_every)}"

    def _engine_for(self, fingerprint: str, req: CampaignRequest):
        """The ensemble engine for a fingerprint — built once, reused
        for every later fingerprint-identical batch."""
        key = self._engine_key(fingerprint, req)
        eng = self._engines.get(key)
        if eng is not None:
            self._m_engine_hits.inc()
            return eng, False, None
        plan = self._plan_for(fingerprint, req)
        cls = EnsembleJacobi if req.model == "jacobi" else EnsembleAstaroth
        with self.tracer.span("compile", fingerprint=fingerprint,
                              model=req.model):
            eng = cls(self.width, *req.grid,
                      dtype=storage_dtype(req.dtype),
                      boundary=Boundary[req.boundary],
                      mesh_shape=req.mesh_shape, devices=self._devices,
                      plan=plan)
        assert eng.fingerprint == fingerprint, \
            (eng.fingerprint, fingerprint)
        self._engines[key] = eng
        self._sentinels[key] = EnsembleSentinel(
            eng, window=self._window,
            growth_factor=self._growth_factor)
        self.stats.compiles += 1
        self._m_compiles.inc()
        if key in self._built:
            # the engine cache dropped a key it had already built — the
            # warm-path regression the CI counter gate is for
            # (stencil_service_recompiles_total stays 0 normally)
            self._m_recompiles.inc()
        self._built.add(key)
        self._m_engine_size.set(len(self._engines))
        if self._attribute:
            att = self._make_attributor(eng)
            if att is not None:
                self._attributors[key] = att
        return eng, True, plan

    def _admit_lane(self, eng, lane: _Lane) -> None:
        """Set up one lane: parameters, resume-or-init, and the step-0
        rollback anchor checkpoint."""
        req = lane.request
        k = lane.index
        eng.reset_member(k)
        if req.params:
            eng.set_member_params(k, req.params)
        if all_steps(lane.ckpt_dir):
            step = eng.restore_member(lane.ckpt_dir, k)
            lane.counter = step
            lane.resumed_from = step
            self._log("resumed", tenant=req.tenant,
                      campaign=req.campaign, step=step)
            LOG_INFO(f"campaign {req.tenant}/{req.campaign} resumes "
                     f"from step {step}")
        else:
            eng.init_member(k, req.init_seed)
            eng.save_member(lane.ckpt_dir, 0, k,
                            max_to_keep=self._max_to_keep)
            self._m_checkpoints.inc()
            self._log("checkpoint", tenant=req.tenant,
                      campaign=req.campaign, step=0)

    @staticmethod
    def _steps_to_boundary(lane: _Lane) -> int:
        """Member steps until lane's next event: completion, probe,
        checkpoint, snapshot, or chaos injection."""
        req = lane.request
        c = lane.counter
        cands = [req.n_steps - c]
        for cad in (req.check_every, req.ckpt_every,
                    req.snapshot_every):
            if cad and cad > 0:
                cands.append(cad - (c % cad))
        if req.chaos_nan_step is not None and not lane.chaos_fired \
                and req.chaos_nan_step > c:
            cands.append(req.chaos_nan_step - c)
        return max(1, min(x for x in cands if x > 0))

    def _inject_nan(self, eng, lane: _Lane) -> None:
        q = eng.names[0]
        host = eng.member_interior(q, lane.index)
        host[tuple(0 for _ in host.shape)] = np.nan
        eng.set_member_interior(q, lane.index, host)
        lane.chaos_fired = True
        self._log("fault_injected", tenant=lane.request.tenant,
                  campaign=lane.request.campaign, step=lane.counter,
                  quantity=q)

    def _handle_trip(self, eng, sentinel, lane: _Lane,
                     reason: str) -> None:
        req = lane.request
        self._log("sentinel_tripped", tenant=req.tenant,
                  campaign=req.campaign, member=lane.index,
                  step=lane.counter, reason=reason,
                  attempt=lane.rollbacks + 1)
        LOG_WARN(f"campaign {req.tenant}/{req.campaign}: sentinel "
                 f"tripped at member step {lane.counter} ({reason}), "
                 f"attempt {lane.rollbacks + 1}/{req.max_retries}")
        sentinel.reset_member(lane.index)
        # rollback counters count RESTORES performed, not trips — a
        # campaign that fails on its first trip reports zero rollbacks
        if lane.rollbacks >= req.max_retries:
            lane.active = False
            eng.reset_member(lane.index)
            self.stats.failed += 1
            self._m_campaigns.inc(tenant=req.tenant, outcome="failed")
            self._log("campaign_failed", tenant=req.tenant,
                      campaign=req.campaign, reason=reason)
            lane.entry.handle._fail(CampaignFailed(
                f"{req.tenant}/{req.campaign}: retries exhausted "
                f"({req.max_retries}) at step {lane.counter}: "
                f"{reason}"))
            self._flight_dump("campaign_failed", tenant=req.tenant,
                              campaign=req.campaign,
                              member=lane.index, trip_reason=reason)
            return
        with self.tracer.span("rollback", tenant=req.tenant,
                              member=lane.index):
            step = eng.restore_member(lane.ckpt_dir, lane.index)
        lane.counter = step
        lane.rollbacks += 1
        self.stats.rollbacks += 1
        self._m_rollbacks.inc(tenant=req.tenant)
        self._log("rollback", tenant=req.tenant, campaign=req.campaign,
                  member=lane.index, restored_step=step)
        # the black box captures trip AND rollback in one incident
        self._flight_dump("sentinel_trip", tenant=req.tenant,
                          campaign=req.campaign, member=lane.index,
                          trip_step=lane.counter, trip_reason=reason)

    def _complete_lane(self, eng, lane: _Lane,
                       preempted: bool = False) -> None:
        req = lane.request
        final = eng.member_interiors(lane.index)
        result = CampaignResult(
            tenant=req.tenant, campaign=req.campaign,
            steps=lane.counter, rollbacks=lane.rollbacks,
            resumed_from=lane.resumed_from, preempted=preempted,
            snapshots=sorted(lane.snapshots.items()), final=final)
        lane.active = False
        if preempted:
            self._m_campaigns.inc(tenant=req.tenant,
                                  outcome="preempted")
            self._log("campaign_preempted", tenant=req.tenant,
                      campaign=req.campaign, step=lane.counter)
        else:
            self.stats.completed += 1
            self._m_campaigns.inc(tenant=req.tenant,
                                  outcome="completed")
            self._log("campaign_completed", tenant=req.tenant,
                      campaign=req.campaign, steps=lane.counter,
                      rollbacks=lane.rollbacks)
        lane.entry.handle._resolve(result)

    def _run_batch(self, batch) -> None:
        fp = batch[0].fingerprint
        try:
            with self.tracer.span("campaign.batch", fingerprint=fp,
                                  members=len(batch)):
                self._serve_batch(batch)
        except Exception as e:
            # unhandled dispatch error: the black box is the
            # post-mortem (the raise still propagates unchanged)
            self._flight_dump("unhandled_error", fingerprint=fp,
                              error=f"{type(e).__name__}: {e}")
            raise

    def _serve_batch(self, batch) -> None:
        fp = batch[0].fingerprint
        req0 = batch[0].request
        now = time.time()
        for e in batch:
            self._m_admission.observe(max(0.0, now - e.submitted))
        self._m_queue_depth.set(len(self.queue))
        self._m_occupancy.set(len(batch) / self.width)
        eng, compiled, plan = self._engine_for(fp, req0)
        sentinel = self._sentinels[self._engine_key(fp, req0)]
        sentinel.reset()
        self.stats.batches += 1
        self._m_batches.inc()
        t_batch = time.perf_counter()
        steps_advanced = 0
        self._log(
            "batch_started", fingerprint=fp, members=len(batch),
            width=eng.n_members, compiled=compiled,
            plan_provenance=(eng.dd.plan_provenance),
            measurements=(plan.measurements if plan is not None
                          and plan.provenance == "tuned" else 0),
            fused=self._fuse,
            tenants=[e.request.tenant for e in batch])
        if not self._fuse:
            # the stepwise fallback is a fleet-visible fact, not a
            # silent mode: mirrored from the resilient driver's
            # fused_decline event + stencil_run_fused_dispatch_total
            self._log("fused_decline", fingerprint=fp,
                      model="service", path="ensemble",
                      reason="fuse_segments disabled by service "
                             "configuration")
        lanes = [
            _Lane(entry=e, index=k,
                  ckpt_dir=str(self.namespace(e.request.tenant,
                                              e.request.campaign)))
            for k, e in enumerate(batch)]
        for lane in lanes:
            try:
                self._admit_lane(eng, lane)
            except Exception as err:  # noqa: BLE001 - admission faults
                lane.active = False
                self.stats.failed += 1
                self._log("campaign_failed",
                          tenant=lane.request.tenant,
                          campaign=lane.request.campaign,
                          reason=f"admission: {err}")
                lane.entry.handle._fail(err)
        # idle lanes of a partially-filled batch stay benign
        for k in range(len(batch), eng.n_members):
            eng.reset_member(k)
        # a resubmitted campaign whose restored checkpoint already
        # meets the requested budget completes immediately — it must
        # not run past n_steps
        for lane in lanes:
            if lane.active and lane.counter >= lane.request.n_steps:
                self._complete_lane(eng, lane)

        pending_snaps: List = []

        def poll_snapshots(block: bool = False) -> None:
            remaining = []
            for lane, snap in pending_snaps:
                if block or snap.ready():
                    if lane.active and snap.step <= \
                            lane.request.n_steps:
                        lane.snapshots[snap.step] = snap.get()
                else:
                    remaining.append((lane, snap))
            pending_snaps[:] = remaining

        while any(lane.active for lane in lanes):
            if self._preempt:
                # drain in-flight probes; never persist poisoned state
                for health in sentinel.poll(block=True):
                    for k in health.tripped_members:
                        lane = next((ln for ln in lanes
                                     if ln.index == k and ln.active),
                                    None)
                        if lane is not None:
                            self._handle_trip(
                                eng, sentinel, lane,
                                health.members[k].reason)
                # harvest in-flight snapshots BEFORE materializing the
                # preempted results — completion deactivates the lane
                # and would silently drop them
                poll_snapshots(block=True)
                # black box BEFORE the preemption checkpoints: if a
                # final save dies, the incident record already exists
                self._flight_dump("preempt", fingerprint=fp)
                for lane in lanes:
                    if lane.active:
                        eng.save_member(lane.ckpt_dir, lane.counter,
                                        lane.index,
                                        meta_extra={"preempted": True},
                                        max_to_keep=self._max_to_keep)
                        self._m_checkpoints.inc()
                        self._log("checkpoint",
                                  tenant=lane.request.tenant,
                                  campaign=lane.request.campaign,
                                  step=lane.counter, preempted=True)
                        self._complete_lane(eng, lane, preempted=True)
                self._log("preempted", fingerprint=fp)
                return
            seg = min(self._steps_to_boundary(lane)
                      for lane in lanes if lane.active)
            if self._fuse:
                from ..parallel.megastep import MAX_UNROLL
                seg = min(seg, MAX_UNROLL)
            trace = None
            att = self._attributors.get(self._engine_key(fp, req0))
            timed = (att.dispatch(seg, lambda: _block_state(eng))
                     if att is not None else contextlib.nullcontext())
            with self.tracer.span("segment", steps=seg,
                                  fused=self._fuse):
                if self._fuse:
                    # one Perfetto box per segment, timed by the
                    # attributor (host wall clock after a fence of the
                    # cards); the megastep carries the per-member probe
                    # trace on the device (one amax per row), under the
                    # hot-loop transfer guard — nothing in the segment
                    # waits for the card (analysis/transfer.py;
                    # STENCIL_ALLOW_TRANSFERS=1 opts out)
                    with self.tracer.span(
                            "segment.dispatch", k=seg,
                            check_every=int(req0.check_every),
                            entry="service"):
                        with timed:
                            with hot_loop_transfer_guard(eng.devices):
                                trace = eng.run_segment(seg)
                    if self._compile_guard is not None:
                        for name, fn in eng.jit_entry_points().items():
                            self._compile_guard.observe(
                                fn, f"ensemble {name}")
                else:
                    with timed:
                        eng.run(seg)
            self._m_fused_dispatch.inc(
                fused="true" if self._fuse else "false")
            n_active = 0
            for lane in lanes:
                if lane.active:
                    lane.counter += seg
                    n_active += 1
            self._m_steps.inc(seg * n_active)
            steps_advanced += seg * n_active
            top = max(lane.counter for lane in lanes)
            if trace is not None:
                sentinel.observe_segment(
                    trace.array, [top - seg + r for r in trace.steps])
            # chaos injections land AFTER the step that reaches them
            chaos_fired = False
            for lane in lanes:
                req = lane.request
                if (lane.active and req.chaos_nan_step is not None
                        and not lane.chaos_fired
                        and lane.counter >= req.chaos_nan_step):
                    self._inject_nan(eng, lane)
                    chaos_fired = True
            if trace is None or chaos_fired:
                # stepwise mode probes every boundary; fused mode
                # re-probes only when a host-side injection poisoned
                # state AFTER the in-graph trace rows were produced
                sentinel.probe(top)
            poll_snapshots()
            # blocking drain BEFORE any checkpoint/completion below —
            # the same invariant as the resilience driver: poisoned
            # state is never persisted or handed back
            tripped: Dict[int, str] = {}
            for health in sentinel.poll(block=True):
                for k in health.tripped_members:
                    tripped.setdefault(k, health.members[k].reason)
            for lane in list(lanes):
                if not lane.active:
                    continue
                req = lane.request
                if lane.index in tripped:
                    self._handle_trip(eng, sentinel, lane,
                                      tripped[lane.index])
                    continue
                if (req.snapshot_every and lane.counter
                        and lane.counter % req.snapshot_every == 0
                        and lane.counter < req.n_steps):
                    pending_snaps.append(
                        (lane, eng.member_snapshot_async(
                            lane.index, lane.counter)))
                    self._m_snapshots.inc()
                    self._log("snapshot_enqueued", tenant=req.tenant,
                              campaign=req.campaign, step=lane.counter)
                if (req.ckpt_every and lane.counter
                        and lane.counter % req.ckpt_every == 0
                        and lane.counter < req.n_steps):
                    with self.tracer.span("checkpoint",
                                          tenant=req.tenant,
                                          step=lane.counter):
                        eng.save_member(lane.ckpt_dir, lane.counter,
                                        lane.index,
                                        max_to_keep=self._max_to_keep)
                    self._m_checkpoints.inc()
                    self._log("checkpoint", tenant=req.tenant,
                              campaign=req.campaign, step=lane.counter)
                if lane.counter >= req.n_steps:
                    eng.save_member(lane.ckpt_dir, lane.counter,
                                    lane.index,
                                    meta_extra={"completed": True},
                                    max_to_keep=self._max_to_keep)
                    self._m_checkpoints.inc()
                    poll_snapshots(block=True)
                    self._complete_lane(eng, lane)
            # deterministic chaos: armed thresholds fire at the END of
            # boundary processing, so checkpoints due at this boundary
            # have already landed — a crash loses exactly the work
            # since the last ckpt_every boundary, no more, no less
            if (self._preempt_at_step is not None
                    and top >= self._preempt_at_step):
                self._preempt_at_step = None
                # same contract as preempt(): this batch checkpoints
                # and the worker stops (the fleet requeues + resumes)
                self._preempt = True
                self._stop = True
            if (self._crash_at_step is not None
                    and top >= self._crash_at_step):
                armed = self._crash_at_step
                self._crash_at_step = None
                self._log("replica_crash", fingerprint=fp, step=top,
                          armed_at=armed)
                raise ReplicaCrashed(
                    f"replica hard-crashed at member step {top} "
                    f"(armed at {armed})")
        poll_snapshots(block=True)
        elapsed = time.perf_counter() - t_batch
        if steps_advanced and elapsed > 0:
            self._m_steps_per_s.set(steps_advanced / elapsed)
        self._log("batch_finished", fingerprint=fp)
