"""Checkpoint-rollback recovery driver: the resilient run loop.

PyTorch-port counterpart of ``stencil_tpu/resilience/driver.py``.
``run_resilient(domain, step_fn, n_steps, policy)`` wraps any per-step
engine (``Jacobi3D.step``, ``Astaroth.step``, ``Pic.step``, or a bare
closure over a ``DistributedDomain``) with the detect -> degrade ->
retry ladder:

* **checkpoint** every ``ckpt_every`` steps (``utils/checkpoint.py``:
  an integrity sha256 per file, transient-I/O retry with backoff),
  after a *blocking* health drain so poisoned state is never persisted;
* **watch** via the on-device :class:`~.health.HealthSentinel` every
  ``check_every`` steps — asynchronous readback, the loop never stalls;
* **roll back** to the last good checkpoint when the sentinel trips
  (corrupt checkpoints fall back to older steps), with bounded attempts
  and exponential backoff;
* **degrade** when retries at the current configuration are exhausted:
  halve ``exchange_every`` toward 1, then fall down the ``pick_method``
  priority list — the caller supplies ``rebuild(config)``;
* **preempt cleanly**: SIGTERM (a scheduler reclaiming the host, or an
  injected :class:`~.faults.Preemption`) writes a final checkpoint
  tagged ``preempted`` and returns; the next ``run_resilient`` on the
  same directory resumes from it.

With a segment factory (``make_segment``, ``parallel/megastep.py``) the
loop dispatches one segment per host boundary under the hot-loop
transfer guard (``analysis/transfer.py``: no host synchronization inside
a segment on a card), and checkpoints are taken asynchronously: the
fields are cloned on the current stream at the boundary, an event is
recorded after the clones, and the write happens at a later loop turn
once the event has completed (``Event.query()``), copied out on a side
stream (``utils/checkpoint.host_arrays``), so the loop never waits for
the segment queued behind the clones.

On a mesh that spans processes every decision that leads to a
collective is made the same way on every rank: probes are harvested
blocking, pending saves are written at the next loop turn, and the
SIGTERM flag is gathered across ranks each turn, so that every rank
reaches the same restore, save and preemption at the same step.

Everything lands in a JSON-serializable :class:`ResilienceReport`
event log. The performance observatory rides along (``observatory/``):
under ``attribute_perf`` (the default) a ``PerfAttributor`` times every
segment, and every ``check_every``-step window of the stepwise loop,
against the cost model's price of the configuration and emits JAX's
``perf_drift`` events; ``retune_on_drift`` then invalidates the plan's
cache record; ``flight_recorder_dir`` (or
``$STENCIL_FLIGHT_RECORDER_DIR``) arms the flight recorder, which dumps
on a trip, a degradation, SIGTERM and an unhandled error.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from ..analysis.recompile import (ASSERT_SINGLE_COMPILE_ENV,
                                  SingleCompileGuard)
from ..analysis.transfer import hot_loop_transfer_guard
from ..parallel.methods import (METHOD_PRIORITY, Method, method_runnable,
                                pick_method)
from ..utils.checkpoint import restore_domain, save_domain
from ..utils.logging import LOG_INFO, LOG_WARN
from ..utils.retry import retry
from ..utils.timers import device_sync
from .faults import FaultPlan
from .health import HealthSentinel, HealthStats


class ResilienceError(RuntimeError):
    """The run could not be kept alive: the sentinel tripped with no
    checkpoint to roll back to, or every retry and degradation was
    exhausted."""


@dataclasses.dataclass
class ResiliencePolicy:
    """Knobs of the resilient loop (see README "Resilience")."""

    check_every: int = 10       # sentinel probe cadence (steps)
    ckpt_every: int = 50        # checkpoint cadence (steps)
    max_retries: int = 3        # rollbacks per configuration
    base_delay: float = 0.05    # backoff seed (seconds), doubles
    save_attempts: int = 3      # transient-I/O retries per save
    max_to_keep: Optional[int] = 3   # checkpoint history depth
    window: int = 8             # sentinel sliding window (probes)
    growth_factor: float = 1e6  # max-abs growth trip factor
    degrade: bool = True        # walk the degradation ladder
    sleep: Callable[[float], None] = time.sleep  # injectable clock
    # megastep execution (parallel/megastep.py): fuse check_every-sized
    # campaign segments into ONE compiled program when the engine
    # provides a segment factory; probe_every sets the in-graph probe
    # cadence INSIDE a segment (1 = per-step trace rows, exact trip
    # location; the segment's final step is always probed)
    fuse_segments: bool = True
    probe_every: int = 1
    # performance observatory (observatory/attribution.py): pair every
    # dispatch's measured seconds/step with the cost model's price,
    # exported as stencil_perf_model_error_ratio{entry,method,s}; after
    # drift_window consecutive observations departing from the first
    # by more than drift_tolerance (relative) a perf_drift event is
    # emitted, and retune_on_drift also drops the plan's cache record
    # (plan_cache_path; default $STENCIL_TUNE_CACHE or the default file)
    attribute_perf: bool = True
    drift_tolerance: float = 0.5
    drift_window: int = 3
    retune_on_drift: bool = False
    plan_cache_path: Optional[str] = None
    # flight recorder (observatory/recorder.py): a bounded black box
    # dumped into this directory (or $STENCIL_FLIGHT_RECORDER_DIR) on a
    # trip, a degradation, SIGTERM and an unhandled error
    flight_recorder_dir: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """One rung of the degradation ladder: the exchange transport and
    temporal-blocking depth the engine should be rebuilt with."""

    method: Method
    exchange_every: int

    def key(self) -> str:
        return f"{self.method.name}[s={self.exchange_every}]"


def degradation_ladder(method: Method, exchange_every: int,
                       runnable: Optional[Callable[[Method], bool]] = None
                       ) -> List[StepConfig]:
    """Successively safer configurations: first halve the temporal-
    blocking depth down to per-step exchanges (deep halos stress the
    fabric hardest), then fall down the capability-aware
    ``pick_method`` priority list below the current transport.
    ``runnable`` is injectable for tests (defaults to the real
    capability probe)."""
    if runnable is None:
        runnable = method_runnable
    out: List[StepConfig] = []
    s = int(exchange_every)
    while s > 1:
        s //= 2
        out.append(StepConfig(method, s))
    live = [m for m in METHOD_PRIORITY if runnable(m)]
    if method in live:
        live = live[live.index(method) + 1:]
    out.extend(StepConfig(m, 1) for m in live)
    return out


@dataclasses.dataclass
class ResilienceReport:
    """What happened, machine-readable (the chaos-smoke CI artifact).

    Events flow through the telemetry schema
    (:class:`~stencil_tpu_torch.telemetry.EventLog`): every record
    carries the run id, a monotonic sequence number, and the schema
    version. The serializable ``events`` list is fed by a ``ListSink``;
    added sinks (e.g. a ``JsonlSink``) fan out the same records live."""

    steps: int = 0
    rollbacks: int = 0
    save_retries: int = 0
    degradations: List[str] = dataclasses.field(default_factory=list)
    preempted: bool = False
    resumed_from: Optional[int] = None
    final_config: str = ""
    run_id: str = ""
    #: did the campaign run fused (megastep) dispatches? False when
    #: fusion was off by policy, the engine provided no segment
    #: factory, or the built path declined — ``fused_decline_reason``
    #: then says WHY (silent stepwise fallbacks used to be invisible)
    fused: bool = False
    fused_decline_reason: str = ""
    #: the machine-readable ``megastep.DECLINE_*`` vocabulary code
    #: behind ``fused_decline_reason`` (greppable cause taxonomy)
    fused_decline_code: str = ""
    events: List[Dict] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        from ..telemetry import EventLog, ListSink
        self._elog = EventLog(run_id=self.run_id or None,
                              sinks=(ListSink(self.events),))
        self.run_id = self._elog.run_id
        self._tracer = None

    def add_sink(self, sink) -> None:
        self._elog.add_sink(sink)

    def bind_tracer(self, tracer) -> None:
        """Span-correlate report events: records emitted inside a span
        of ``tracer`` carry its id (the same run-id/span-id identity
        the campaign service logs — one scraper joins both)."""
        self._tracer = tracer

    def log(self, kind: str, **kw) -> None:
        span = (self._tracer.current_span_id()
                if self._tracer is not None else None)
        self._elog.emit(kind, span=span, **kw)

    def to_record(self) -> Dict:
        return dataclasses.asdict(self)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_record(), f, indent=1)


def _current_config(dd) -> StepConfig:
    return StepConfig(pick_method(dd.methods), dd.exchange_every)


def _collective_mesh(dd) -> bool:
    mesh = getattr(dd, "mesh", None)
    return bool(mesh is not None and mesh.spans_ranks)


def _guarded_devices(dd) -> List:
    """The devices the transfer guard watches during a segment: the
    mesh's, except on a mesh over gloo ranks, whose messages are staged
    through host memory by design."""
    if _collective_mesh(dd):
        from ..parallel.multihost import backend

        if backend() == "gloo":
            return []
    return list(dd.mesh.devices)


def _clone_state(state: Dict) -> Dict:
    """Device copies of a ``{key: [tensor or None, ...]}`` state, queued
    on each device's current stream."""
    return {k: [None if t is None else t.clone() for t in v]
            for k, v in state.items()}


def _record_ready(state: Dict) -> Dict:
    """One CUDA event per card of ``state``, recorded on its current
    stream after the work queued so far (e.g. the clones)."""
    events = {}
    for v in state.values():
        for t in v:
            if t is not None and t.is_cuda and t.device not in events:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(t.device))
                events[t.device] = ev
    return events


class _ResilientRun:
    """One ``run_resilient`` invocation (state bundled for clarity)."""

    def __init__(self, dd, step_fn, n_steps, policy, ckpt_dir, faults,
                 rebuild, extra_fn, on_restore, fields_fn,
                 pre_checkpoint, make_segment=None,
                 sentinel_factory=None, model_step_seconds=None,
                 model_bytes_per_step=None, perf_entry=None):
        self.dd = dd
        self.step_fn = step_fn
        self.n_steps = int(n_steps)
        self.policy = policy or ResiliencePolicy()
        p = self.policy
        self.ckpt_dir = ckpt_dir
        self.faults = faults
        self.rebuild = rebuild
        self.extra_fn = extra_fn
        self.on_restore = on_restore
        self.fields_fn = fields_fn
        self.pre_checkpoint = pre_checkpoint
        #: segment factory: make_segment(k, probe_every, metrics) ->
        #: Segment or a falsy SegmentDecline (parallel/megastep.py)
        self.make_segment = make_segment
        self._fused = (make_segment is not None and p.fuse_segments)
        #: one async checkpoint in flight:
        #: (step, field copies, extra copies, {device: ready event})
        self._pending_save = None
        self._compile_guard = (
            SingleCompileGuard()
            if os.environ.get(ASSERT_SINGLE_COMPILE_ENV) == "1"
            else None)
        self.sentinel_factory = sentinel_factory
        self.report = ResilienceReport()
        if faults is not None:
            faults.bind(self.report.log)
        self.sentinel = self._make_sentinel(dd)
        self.step = 0
        self.attempts = 0
        self.last_saved: Optional[int] = None
        self.ladder: Optional[List[StepConfig]] = None
        self._preempt = False
        # run-loop metrics, under JAX's names, in the process-default
        # telemetry registry
        from ..telemetry import get_registry, get_tracer
        reg = get_registry()
        self._tracer = get_tracer()
        self.report.bind_tracer(self._tracer)
        self._m_steps = reg.counter(
            "stencil_run_steps_total",
            "steps advanced by resilient run loops — steps inside a "
            "segment each count (one count per STEP, never per "
            "dispatch); replayed rollback windows included (work done, "
            "not net progress)")
        self._m_rollbacks = reg.counter(
            "stencil_run_rollbacks_total",
            "sentinel-tripped rollbacks")
        self._m_save_retries = reg.counter(
            "stencil_run_save_retries_total",
            "transient checkpoint-save retries")
        self._m_checkpoints = reg.counter(
            "stencil_run_checkpoints_total", "checkpoints written")
        self._m_degradations = reg.counter(
            "stencil_run_degradations_total",
            "configuration degradations taken")
        self._m_steps_per_s = reg.gauge(
            "stencil_run_steps_per_s",
            "steps/s of the last resilient run")
        self._m_bytes_per_step = reg.gauge(
            "stencil_run_bytes_per_step",
            "amortized exchange B/step (source=model: the domain's byte "
            "model; source=probe: harvested from the probe's counters)")
        self._m_fused_dispatch = reg.counter(
            "stencil_run_fused_dispatch_total",
            "dispatches by the resilient run loops, labeled fused=true "
            "(one segment per count, covering k steps) or fused=false "
            "(one stepwise step per count)")
        for c in (self._m_steps, self._m_rollbacks,
                  self._m_save_retries, self._m_checkpoints,
                  self._m_degradations):
            c.inc(0)
        for fused in ("true", "false"):
            self._m_fused_dispatch.inc(0, fused=fused)
        self._perf_entry = perf_entry or "resilience"
        self.report.fused = self._fused
        if not self._fused:
            from ..parallel.megastep import (DECLINE_NO_FACTORY,
                                             DECLINE_POLICY_DISABLED)
            if make_segment is not None:
                self._note_fused_decline(
                    "fuse_segments disabled by policy",
                    code=DECLINE_POLICY_DISABLED)
            else:
                self._note_fused_decline(
                    "engine provides no fused-segment factory",
                    code=DECLINE_NO_FACTORY)
        # the performance observatory (observatory/): a host clock around
        # every dispatch, the dispatched work unchanged
        self._model_step_seconds = model_step_seconds
        self._model_bytes_per_step = model_bytes_per_step
        self.flight = None
        self.attributor = (self._make_attributor() if p.attribute_perf
                           else None)
        #: the stepwise attribution window (dispatch seconds, base step):
        #: one observation per check_every steps, timing the step
        #: dispatches and one fence, not the probes or saves between
        self._att_window_s = 0.0
        self._att_window_base = None
        from ..observatory.recorder import ENV_FLIGHT_DIR, FlightRecorder
        self._flight_dir = (p.flight_recorder_dir
                            or os.environ.get(ENV_FLIGHT_DIR) or None)
        if self._flight_dir:
            self.flight = FlightRecorder(run_id=self.report.run_id,
                                         registry=reg, tracer=self._tracer)
            self.report.add_sink(self.flight)
            self.flight.set_linkmap(getattr(self, "_link_summary", None))

    @property
    def _collective(self) -> bool:
        return _collective_mesh(self.dd)

    def _make_sentinel(self, dd,
                       rebase_step: Optional[int] = None,
                       prev=None) -> HealthSentinel:
        """A sentinel whose probe also carries the telemetry step
        metrics on its one reduction when the domain prices its
        exchange; a degradation rebuild rebases the byte counter at
        ``rebase_step`` (the restore anchor), ``prev`` overriding the
        block it rebases from (JAX ``driver.py:352-384``)."""
        if self.sentinel_factory is not None:
            self._step_metrics = None
            return self.sentinel_factory(dd)
        from ..telemetry.probe import step_metrics_for
        if prev is None:
            prev = getattr(self, "_step_metrics", None)
        if prev is not None:
            if rebase_step is None:
                rebase_step = getattr(self, "step", 0)
            try:
                self._step_metrics = prev.rebased(dd, rebase_step)
            except Exception:  # noqa: BLE001 - new config unpriceable
                self._step_metrics = step_metrics_for(dd)
        else:
            self._step_metrics = step_metrics_for(dd)
        return HealthSentinel(dd, window=self.policy.window,
                              growth_factor=self.policy.growth_factor,
                              metrics=self._step_metrics)

    # -- performance observatory ------------------------------------------
    def _make_attributor(self):
        """A ``PerfAttributor`` for the current configuration, or None
        when nothing is priced (one shard, an unpriceable geometry). The
        price is the caller's (PIC passes its migration and sweep
        figure) on the first build; a degradation rebuild re-derives it
        from the rebuilt domain (JAX ``driver.py:387-434``)."""
        from ..observatory.attribution import (PerfAttributor,
                                               model_step_seconds_for)
        from ..observatory.linkmap import link_attribution_for

        model = self._model_step_seconds
        if model is None:
            model = model_step_seconds_for(self.dd)
        if not model:
            return None
        cfg = _current_config(self.dd)
        plan = getattr(self.dd, "plan", None)
        p = self.policy
        nbytes = self._model_bytes_per_step
        if nbytes is None:
            nbytes = (self._step_metrics.bytes_per_step
                      if getattr(self, "_step_metrics", None) is not None
                      else 0.0)
        link = link_attribution_for(self.dd)
        self._link_summary = link["summary"] if link else None
        if self.flight is not None:
            self.flight.set_linkmap(self._link_summary)
        return PerfAttributor(
            entry=self._perf_entry, method=cfg.method.name,
            exchange_every=cfg.exchange_every,
            model_step_seconds=model,
            model_bytes_per_step=float(nbytes),
            tolerance=p.drift_tolerance, window=p.drift_window,
            warmup=1,  # the first dispatch builds kernels and tables
            emit=self.report.log,
            on_drift=(self._on_perf_drift if p.retune_on_drift
                      else None),
            link_bytes_per_step=(link["bytes_per_step"] if link
                                 else None),
            link_peak_bytes_per_s=(link["peak_bytes_per_s"] if link
                                   else None),
            fingerprint=(plan.fingerprint if plan is not None else None))

    def _on_perf_drift(self, attrs: Dict) -> None:
        """``retune_on_drift``: the plan whose prediction the machine
        stopped matching loses its cache record, so that the next tune
        re-measures."""
        from ..observatory.attribution import make_drift_invalidator
        make_drift_invalidator(self.policy.plan_cache_path,
                               self.report.log)(attrs)

    def _block_fields(self) -> None:
        """The attribution fence: a synchronize of every card holding
        the live state."""
        device_sync([t for v in self._fields().values() for t in v
                     if isinstance(t, torch.Tensor)])

    def _attributed(self, k: int):
        """The timing context of one dispatch of ``k`` steps (a no-op
        without an attributor)."""
        if self.attributor is None:
            return contextlib.nullcontext()
        return self.attributor.dispatch(k, self._block_fields,
                                        step=self.step + k)

    def _flight_dump(self, reason: str, **attrs) -> Optional[str]:
        from ..observatory.recorder import safe_dump
        return safe_dump(self.flight, self._flight_dir, reason,
                         step=self.step, **attrs)

    # -- helpers --------------------------------------------------------
    def _fields(self):
        return self.fields_fn() if self.fields_fn is not None \
            else self.dd.curr

    _UNSET = object()

    def _save(self, preempted: bool = False, fields=None,
              extra=_UNSET, at_step: Optional[int] = None,
              ready=None) -> None:
        if fields is None and self.pre_checkpoint is not None:
            self.pre_checkpoint()
        if extra is self._UNSET:
            extra = self.extra_fn() if self.extra_fn is not None \
                else None
        step = self.step if at_step is None else int(at_step)
        meta_extra = {"preempted": preempted,
                      "completed_steps": step,
                      "config": _current_config(self.dd).key()}

        def attempt():
            if self.faults is not None:
                self.faults.maybe_fail_save(step)
            # attempts=1: THIS retry loop (policy clock, event-logged)
            # is the only one
            save_domain(self.dd, self.ckpt_dir, step, extra=extra,
                        max_to_keep=self.policy.max_to_keep,
                        meta_extra=meta_extra, attempts=1,
                        fields=fields, ready=ready)

        def on_retry(k, e, delay):
            self.report.save_retries += 1
            self._m_save_retries.inc()
            self.report.log("save_retry", step=step, attempt=k,
                            error=f"{type(e).__name__}: {e}",
                            delay=delay)

        with self._tracer.span("checkpoint", step=step,
                               preempted=preempted):
            retry(attempt, attempts=self.policy.save_attempts,
                  base_delay=self.policy.base_delay,
                  retriable=(OSError,),
                  sleep=self.policy.sleep, on_retry=on_retry)
        self._m_checkpoints.inc()
        if self.faults is not None:
            self.faults.after_save(self.ckpt_dir, step,
                                   positions=self.dd.mesh.local_positions)
        self.last_saved = step
        # a successful checkpoint is verified-healthy progress: retries
        # are bounded per incident, not per configuration lifetime
        self.attempts = 0
        self.report.log("checkpoint", step=step, preempted=preempted)

    # -- async checkpoint offload (segment mode) --------------------------
    def _save_async(self) -> None:
        """Enqueue a checkpoint of the CURRENT state without waiting for
        the device: clones of the fields (and extras) are queued on the
        current streams at the segment boundary with an event after
        them; the write happens once the events report done (polled each
        loop turn). One save is in flight; it is flushed before the next
        enqueue, any restore, preemption, and loop end."""
        self._flush_pending_save()
        if self.pre_checkpoint is not None:
            self.pre_checkpoint()
        fields = _clone_state(self.dd.curr)
        extra = self.extra_fn() if self.extra_fn is not None else None
        if extra:
            extra = _clone_state(extra)
        ready = _record_ready({**fields, **(extra or {})})
        self._pending_save = (self.step, fields, extra, ready)

    def _poll_pending_save(self, block: bool = False) -> None:
        ps = self._pending_save
        if ps is None:
            return
        step, fields, extra, ready = ps
        # across ranks the write is a collective: every rank writes at
        # the first poll, never on a readiness that may differ by rank
        if not block and not self._collective and \
                not all(ev.query() for ev in ready.values()):
            return
        self._pending_save = None
        self._save(fields=fields, extra=extra, at_step=step,
                   ready=ready or None)

    def _flush_pending_save(self) -> None:
        self._poll_pending_save(block=True)

    def _poll(self, block: bool = False) -> List[HealthStats]:
        return self.sentinel.poll(block=block or self._collective)

    def _drain_probe(self) -> List[HealthStats]:
        """Blocking health verdict on the CURRENT state (at checkpoint
        boundaries and the loop end), reusing an in-flight probe of this
        step or a segment-trace row of it already harvested clean."""
        if not self.sentinel.has_pending(self.step) and \
                getattr(self, "_last_clean_health", None) != self.step:
            self.sentinel.probe(self._fields(), self.step)
        results = self._poll(block=True)
        self._observe_probes(results)
        for s in results:
            if not s.tripped:
                self._last_clean_health = s.step
        return [s for s in results if s.tripped]

    def _observe_probes(self, results: List[HealthStats]) -> None:
        """Export the probe-observed amortized B/step next to the
        model's figure, and keep the probes in the flight recorder."""
        if self.flight is not None:
            for stats in results:
                self.flight.record_probe(stats.to_record())
        if self._step_metrics is None:
            return
        for stats in results:
            if not stats.metrics:
                continue
            decoded = self._step_metrics.decode(stats.metrics)
            self._m_bytes_per_step.set(decoded["bytes_per_step_probe"],
                                       source="probe")

    def _restore(self) -> None:
        with self._tracer.span("restore"):
            step, extras = restore_domain(self.dd, self.ckpt_dir)
        if self.on_restore is not None:
            self.on_restore(extras)
        self.step = step
        pre_degrade = getattr(self, "_rebase_from", None)
        if pre_degrade is not None:
            # finalize the post-degradation byte rebase at the step the
            # restore actually landed on (it may have walked back)
            self._rebase_from = None
            self.sentinel = self._make_sentinel(
                self.dd, rebase_step=step, prev=pre_degrade)
        self.sentinel.reset()
        self._last_clean_health = None
        # a rolled-back window is replay: no attribution across it
        self._att_window_base = None
        self.report.log("restored", step=step)

    def _handle_trip(self, tripped: List[HealthStats]) -> None:
        # an in-flight async checkpoint (healthy by construction)
        # completes FIRST, before the attempt counter moves
        self._flush_pending_save()
        stats = tripped[0]
        self.report.rollbacks += 1
        self._m_rollbacks.inc()
        self.attempts += 1
        self.report.log("sentinel_tripped", step=stats.step,
                        reason=stats.reason,
                        stats=stats.to_record(),
                        attempt=self.attempts)
        LOG_WARN(f"health sentinel tripped at step {stats.step}: "
                 f"{stats.reason} (attempt {self.attempts}/"
                 f"{self.policy.max_retries})")
        if self.ckpt_dir is None:
            raise ResilienceError(
                f"sentinel tripped at step {stats.step} "
                f"({stats.reason}) and no ckpt_dir was given — "
                f"nothing to roll back to")
        if self.attempts > self.policy.max_retries:
            self._degrade_or_die(stats)  # resets attempts to 0
        self.policy.sleep(self.policy.base_delay
                          * (2 ** max(self.attempts - 1, 0)))
        self._restore()
        # the black box holds the whole incident: trip, any degradation
        # and the rollback it resolved into
        self._flight_dump("sentinel_trip", trip_step=stats.step,
                          trip_reason=stats.reason)

    def _degrade_or_die(self, stats: HealthStats) -> None:
        if self.ladder is None:
            cfg = _current_config(self.dd)
            self.ladder = degradation_ladder(cfg.method,
                                             cfg.exchange_every)
        # walk rungs until one realizes: an infeasible rung (its
        # constructor refuses the domain) is skipped, never fatal
        while (self.policy.degrade and self.rebuild is not None
               and self.ladder):
            cfg = self.ladder.pop(0)
            LOG_WARN(f"degrading configuration to {cfg.key()} after "
                     f"repeated failures")
            try:
                built = self.rebuild(cfg)
                if len(built) == 3:
                    self.dd, self.step_fn, self.make_segment = built
                    self._fused = (self.make_segment is not None
                                   and self.policy.fuse_segments)
                else:
                    self.dd, self.step_fn = built
                    if self._fused:
                        LOG_WARN("rebuild() returned no segment "
                                 "factory; continuing stepwise")
                        self._fused = False
                        from ..parallel.megastep import \
                            DECLINE_REBUILD_NO_FACTORY
                        self._note_fused_decline(
                            "rebuild() returned no segment factory "
                            "after degradation",
                            code=DECLINE_REBUILD_NO_FACTORY)
            except (NotImplementedError, ValueError) as e:
                self.report.log("degrade_rung_infeasible",
                                config=cfg.key(),
                                error=f"{type(e).__name__}: {e}")
                LOG_WARN(f"degradation rung {cfg.key()} is infeasible "
                         f"for this domain ({e}); trying the next")
                continue
            # rebase the byte counter at the restore anchor; _restore
            # finalizes it from the pre-degrade block stashed here
            self._rebase_from = self._step_metrics
            anchor = (self.last_saved if self.last_saved is not None
                      else getattr(self, "step", 0))
            self.sentinel = self._make_sentinel(self.dd,
                                                rebase_step=anchor)
            if self._step_metrics is not None:
                self._m_bytes_per_step.set(
                    self._step_metrics.bytes_per_step, source="model")
            self.attempts = 0
            self.report.degradations.append(cfg.key())
            self._m_degradations.inc()
            self.report.log("degraded", config=cfg.key())
            if self.attributor is not None:
                # the degraded engine has a new price and labels
                self._model_step_seconds = None
                self._model_bytes_per_step = None
                self.attributor = self._make_attributor()
                self._att_window_base = None
            self._flight_dump("degraded", config=cfg.key())
            return
        raise ResilienceError(
            f"retries exhausted ({self.policy.max_retries}) at "
            f"step {stats.step}: {stats.reason}; no degradation "
            f"available")

    # -- segments ---------------------------------------------------------
    def _note_fused_decline(self, reason: str, model: str = "",
                            path: str = "", code: str = "") -> None:
        """Make a stepwise fallback visible: ``fused: false`` with the
        reason and its ``megastep.DECLINE_*`` code in the report, a
        ``fused_decline`` event, and the ``fused=false`` counter."""
        from ..parallel.megastep import DECLINE_NO_FACTORY

        self.report.fused = False
        self.report.fused_decline_reason = reason
        self.report.fused_decline_code = code or DECLINE_NO_FACTORY
        self.report.log("fused_decline",
                        model=model or self._perf_entry,
                        path=path, reason=reason,
                        code=self.report.fused_decline_code)

    def _next_seg_len(self) -> int:
        """Steps until the next host boundary: campaign end, the
        check_every health boundary, a checkpoint boundary, a scheduled
        host fault, or the unroll cap."""
        from ..parallel.megastep import MAX_UNROLL
        p = self.policy
        cands = [self.n_steps - self.step, MAX_UNROLL]
        ce = max(int(p.check_every), 1)
        cands.append(ce - self.step % ce)
        if self.ckpt_dir is not None and p.ckpt_every > 0:
            cands.append(p.ckpt_every - self.step % p.ckpt_every)
        if self.faults is not None:
            nf = self.faults.next_host_step(self.step)
            if nf is not None:
                cands.append(nf - self.step)
        return max(1, min(c for c in cands if c > 0))

    def _dispatch_segment(self) -> bool:
        """Advance one segment to the next host boundary (its probe
        rows kept on the device) under the transfer guard. Returns
        False when the current configuration has no segment — the
        caller re-enters the loop stepwise."""
        k = self._next_seg_len()
        seg = self.make_segment(k, self.policy.probe_every,
                                self._step_metrics)
        if not seg:
            reason = getattr(seg, "reason",
                             "engine has no fused-segment support for "
                             "this configuration")
            self._note_fused_decline(
                reason, model=getattr(seg, "model", ""),
                path=getattr(seg, "path", ""),
                code=getattr(seg, "code", ""))
            LOG_WARN(f"no fused-segment support for this configuration "
                     f"({reason}); continuing with the stepwise "
                     f"dispatch loop")
            self._fused = False
            return False
        base = self.step
        with self._tracer.span("megastep", steps=k, step=base):
            with self._tracer.span("segment.dispatch", k=k,
                                   check_every=self.policy.check_every,
                                   entry=self._perf_entry):
                # the attributor's fence comes after the guard: no
                # host synchronization inside a segment on a card
                # (STENCIL_ALLOW_TRANSFERS=1 opts out)
                with self._attributed(k):
                    with hot_loop_transfer_guard(
                            _guarded_devices(self.dd)):
                        trace = seg.run(base)
        if self._compile_guard is not None:
            self._compile_guard.observe(self.make_segment,
                                        "megastep segment")
        self.step += k
        self.report.steps = self.step
        self._m_steps.inc(k)
        self._m_fused_dispatch.inc(fused="true")
        self.sentinel.observe_segment(trace.array, trace.abs_steps)
        return True

    def _preempt_due(self) -> bool:
        """The SIGTERM flag — across ranks any rank's, so that every
        rank takes the preemption branch at the same loop turn."""
        if not self._collective:
            return self._preempt
        from ..parallel.multihost import all_gather_objects

        return any(all_gather_objects(bool(self._preempt)))

    # -- the loop -------------------------------------------------------
    def run(self) -> ResilienceReport:
        try:
            with self._tracer.span("resilience.run",
                                   run=self.report.run_id,
                                   n_steps=self.n_steps):
                return self._run()
        except Exception as e:
            # an unhandled error: the black box is the post-mortem (the
            # error still propagates)
            self._flight_dump("unhandled_error",
                              error=f"{type(e).__name__}: {e}")
            raise

    def _run(self) -> ResilienceReport:
        policy = self.policy
        if self._step_metrics is not None:
            self._m_bytes_per_step.set(
                self._step_metrics.bytes_per_step, source="model")
        t_start = time.perf_counter()
        steps_at_start = self.step
        if self.ckpt_dir is not None:
            try:
                self._restore()
                self.report.resumed_from = self.step
                LOG_INFO(f"resuming from checkpoint step {self.step}")
            except FileNotFoundError:
                self._save()  # step 0: the rollback anchor
        handler_installed = False
        prev_handler = None
        if threading.current_thread() is threading.main_thread():
            prev_handler = signal.signal(
                signal.SIGTERM, lambda *_: setattr(self, "_preempt",
                                                   True))
            handler_installed = True
        try:
            while True:
                self._poll_pending_save()
                if self._preempt_due():
                    self._flush_pending_save()
                    # the black box before the preemption checkpoint: if
                    # the save dies, the incident record exists
                    self._flight_dump("preempt")
                    if self.ckpt_dir is not None:
                        # poisoned state is never persisted: if the
                        # drain trips, skip the save and let the last
                        # good checkpoint anchor the resume
                        tripped = self._drain_probe()
                        if tripped:
                            self.report.log(
                                "preempt_checkpoint_skipped",
                                step=self.step,
                                reason=tripped[0].reason)
                            LOG_WARN(
                                f"preempted at step {self.step} with "
                                f"unhealthy state ({tripped[0].reason})"
                                f"; NOT checkpointing it — resume will "
                                f"restore step {self.last_saved}")
                        else:
                            self._save(preempted=True)
                    self.report.preempted = True
                    self.report.log("preempted", step=self.step)
                    LOG_WARN(f"preempted at step {self.step}; exiting "
                             f"cleanly")
                    break
                if self.step >= self.n_steps:
                    self._flush_pending_save()
                    if self.last_saved == self.step:
                        break  # this step already drained + saved
                    tripped = self._drain_probe()
                    if tripped:
                        self._handle_trip(tripped)
                        continue
                    if self.ckpt_dir is not None:
                        self._save()
                    break
                if self._fused:
                    if not self._dispatch_segment():
                        continue  # no segment support: retry stepwise
                    if self.faults is not None:
                        mutated = self.faults.on_step(
                            self.dd, self.step, self._fields())
                        if mutated:
                            # the segment's trace predates the host
                            # injection: re-probe the poisoned fields
                            self._last_clean_health = None
                            self.sentinel.probe(self._fields(),
                                                self.step)
                        if self._preempt:
                            continue  # SIGTERM landed at the boundary
                else:
                    att = self.attributor
                    if att is not None:
                        if self._att_window_base is None:
                            self._att_window_base = self.step
                            self._att_window_s = 0.0
                        t0 = time.perf_counter()
                        self.step_fn()
                        self._att_window_s += time.perf_counter() - t0
                    else:
                        self.step_fn()
                    self.step += 1
                    self.report.steps = self.step
                    self._m_steps.inc()
                    self._m_fused_dispatch.inc(fused="false")
                    if att is not None \
                            and self.step % policy.check_every == 0:
                        # the window's step dispatches plus ONE fence,
                        # amortized over its steps
                        t0 = time.perf_counter()
                        self._block_fields()
                        self._att_window_s += time.perf_counter() - t0
                        att.observe(self.step - self._att_window_base,
                                    self._att_window_s, step=self.step)
                        self._att_window_base = None
                    if self.faults is not None:
                        # faults hit the LIVE fields — the dict the
                        # sentinel probes
                        self.faults.on_step(self.dd, self.step,
                                            self._fields())
                    if self._preempt:
                        continue  # SIGTERM landed during the step
                    if self.step % policy.check_every == 0 and not (
                            self.ckpt_dir is not None
                            and self.step % policy.ckpt_every == 0):
                        # checkpoint boundaries probe via the blocking
                        # drain below — one reduction per step, not two
                        self.sentinel.probe(self._fields(), self.step)
                results = self._poll()
                self._observe_probes(results)
                for s in results:
                    if not s.tripped:
                        self._last_clean_health = s.step
                tripped = [s for s in results if s.tripped]
                if tripped:
                    self._handle_trip(tripped)
                    continue
                ckpt_due = (self.ckpt_dir is not None
                            and self.step % policy.ckpt_every == 0)
                if ckpt_due:
                    tripped = self._drain_probe()
                    if tripped:
                        self._handle_trip(tripped)
                        continue
                    if self._fused:
                        # the device runs the next segment while the
                        # boundary copies drain to disk
                        self._save_async()
                    else:
                        self._save()
        finally:
            if handler_installed:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None
                              else signal.SIG_DFL)
            if self._pending_save is not None:
                # best-effort durability on abnormal exits: never mask
                # the in-flight exception with a failing late save
                try:
                    self._flush_pending_save()
                except Exception as e:  # noqa: BLE001
                    LOG_WARN(f"in-flight checkpoint lost on exit: "
                             f"{type(e).__name__}: {e}")
        self.report.steps = self.step
        self.report.final_config = _current_config(self.dd).key()
        elapsed = time.perf_counter() - t_start
        # steps THIS invocation advanced (a resume starts mid-campaign)
        done = self.step - max(steps_at_start,
                               self.report.resumed_from or 0)
        if done > 0 and elapsed > 0:
            self._m_steps_per_s.set(done / elapsed)
        return self.report


def run_resilient(dd, step_fn: Callable[[], None], n_steps: int,
                  policy: Optional[ResiliencePolicy] = None,
                  ckpt_dir: Optional[str] = None,
                  faults: Optional[FaultPlan] = None,
                  rebuild: Optional[Callable] = None,
                  extra_fn: Optional[Callable[[], Optional[Dict]]] = None,
                  on_restore: Optional[Callable[[Dict], None]] = None,
                  fields_fn: Optional[Callable[[], Dict]] = None,
                  pre_checkpoint: Optional[Callable[[], None]] = None,
                  make_segment: Optional[Callable] = None,
                  sentinel_factory: Optional[Callable] = None,
                  model_step_seconds: Optional[float] = None,
                  model_bytes_per_step: Optional[float] = None,
                  perf_entry: Optional[str] = None
                  ) -> ResilienceReport:
    """Drive ``step_fn`` for ``n_steps`` steps with health sentinels,
    periodic integrity-checked checkpoints, rollback-retry recovery,
    optional configuration degradation, and clean SIGTERM preemption
    (JAX ``resilience/driver.py:1001``).

    ``dd``: the realized ``DistributedDomain`` whose ``curr`` fields ARE
    the run state. ``step_fn()``: advance the state by one step.
    ``ckpt_dir``: checkpoint directory; when None the sentinel still
    watches but a trip raises (watchdog-only mode). ``rebuild(config)``:
    re-realize the engine at a degraded :class:`StepConfig`, returning
    ``(dd, step_fn)`` or ``(dd, step_fn, make_segment)``.
    ``extra_fn``/``on_restore``: checkpoint and reinstall auxiliary
    per-shard state (RK accumulators, particle lanes) — ``extra_fn()``
    returns ``{name: [tensor or None per mesh position]}``.
    ``fields_fn``: the dict the sentinel probes and faults hit (defaults
    to ``dd.curr``). ``pre_checkpoint``: flush hook run before every
    save. ``make_segment(k, probe_every, metrics)``: the segment factory
    (``parallel/megastep.py``) — with it and ``policy.fuse_segments``
    the loop dispatches one segment per health boundary and saves
    asynchronously. ``sentinel_factory(dd)``: build the health sentinel
    instead (models whose live state is wider than the domain's fields,
    as PIC). ``model_step_seconds``/``model_bytes_per_step``: the
    observatory's price of a step (models whose wire bill the exchange
    model does not see, as PIC's migration ring, pass theirs; None
    derives both from ``dd``); ``perf_entry`` labels the run's events
    and the ``stencil_perf_model_error_ratio{entry,method,s}`` gauges.

    Returns a :class:`ResilienceReport`; if it says ``preempted``, rerun
    with the same ``ckpt_dir`` to resume."""
    return _ResilientRun(dd, step_fn, n_steps, policy, ckpt_dir, faults,
                         rebuild, extra_fn, on_restore, fields_fn,
                         pre_checkpoint, make_segment=make_segment,
                         sentinel_factory=sentinel_factory,
                         model_step_seconds=model_step_seconds,
                         model_bytes_per_step=model_bytes_per_step,
                         perf_entry=perf_entry).run()
