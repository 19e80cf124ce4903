"""The serving fleet: N campaign-service replicas behind one
coordinator.

PyTorch-port counterpart of ``stencil_tpu/serving/fleet.py``. One
:class:`~.service.CampaignService` is one engine cache; :class:`Fleet`
interposes between tenants and N in-process replicas, composing four
things:

1. **Sharded admission.** Tenants route to replicas by rendezvous hash
   (:func:`~.slo.rendezvous_replica`) over the admission fingerprint +
   tenant id: every submit agrees on the owner with no coordination,
   fingerprint-identical work from one tenant lands on one replica (so
   it batches), and a replica's death remaps only the keys it owned.
   User grids are **bucketed** first (:class:`~.slo.GridBucketer` pads
   up to a small declared bucket set), so each replica's engine cache
   is bounded by the bucket count.

2. **SLO-aware admission.** Requests carry ``priority`` and
   ``deadline_seconds`` (:mod:`.queue`). The fleet reads the EXPORTED
   admission signals (the replicas' ``stencil_service_queue_depth``
   gauges and ``stencil_service_admission_latency_seconds``
   histograms, parsed from their Prometheus text) and sheds work below
   the policy's protected priority with a NAMED reason when a signal
   crosses its threshold (:class:`~.slo.SloPolicy`): a
   ``request_shed`` event plus ``stencil_fleet_shed_total``, never a
   silent drop.

3. **Replica fault tolerance.** :class:`~..resilience.faults.
   ReplicaCrash` hard-kills a replica mid-batch (its lanes and
   unresolved handles are lost) and the fleet recovers every one of its
   campaigns from the per-tenant checkpoint namespaces on the SHARED
   checkpoint root, re-admitting them to survivors — bitwise-
   continuous, because resume-and-replay is deterministic.
   :class:`~..resilience.faults.SlowReplica` trips the degradation
   ladder (drain -> reshard its tenants to survivors -> readmit on
   recovery); :class:`~..resilience.faults.AdmissionFlood` drives the
   shed path. Dispatch to a replica runs under
   :func:`~..utils.retry.retry`, so a transient dispatch failure costs
   a short backoff, not a campaign.

4. **Live rebalancing.** :meth:`Fleet.rebalance` picks migrations from
   per-replica load and executes them preempt-on-src -> resume-on-dst.
   The SHARED plan cache means the destination re-tunes nothing, and a
   destination that already built the fingerprint's engine builds
   nothing (``stencil_service_recompiles_total`` stays 0).

The replicas share the card(s) they are given. The fleet serves in
deterministic synchronous ROUNDS (:meth:`Fleet.pump`): fire chaos due
this round -> dispatch pending campaigns to their routed replicas ->
drain each live replica -> harvest results. :meth:`Fleet.serve` pumps
until every campaign resolves and no chaos remains.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

from ..resilience.faults import AdmissionFlood, ReplicaCrash, SlowReplica
from ..utils.logging import LOG_INFO, LOG_WARN
from ..utils.retry import retry
from .queue import CampaignHandle, CampaignRequest, request_fingerprint
from .service import CampaignService, ReplicaCrashed
from .slo import (DEFAULT_BUCKETS, SHED_REASONS, BucketError,
                  GridBucketer, SloPolicy, rendezvous_replica)

#: replica lifecycle states — the label vocabulary of
#: stencil_fleet_replicas
REPLICA_STATES: Tuple[str, ...] = ("active", "degraded", "dead")


class RequestShed(RuntimeError):
    """The fleet shed this request under overload (named reason)."""


class TransientDispatchError(OSError):
    """A transient replica-dispatch failure — retriable by default
    (an ``OSError``, matching :func:`~..utils.retry.retry`'s default
    ``retriable`` tuple)."""


@dataclasses.dataclass
class _Replica:
    """One in-process campaign-service replica and its fleet state."""

    name: str
    index: int
    service: CampaignService
    state: str = "active"       # active | degraded | dead


@dataclasses.dataclass
class _FleetCampaign:
    """The fleet's book-keeping for one admitted campaign."""

    request: CampaignRequest          # the BUCKETED request (what runs)
    handle: CampaignHandle            # the tenant's (outer) handle
    fingerprint: str
    padded: bool = False
    #: rebalance pin: route here instead of the rendezvous owner
    pinned: Optional[str] = None
    #: replica currently holding the inner submission (None = pending)
    replica: Optional[str] = None
    inner: Optional[CampaignHandle] = None
    done: bool = False
    recoveries: int = 0

    @property
    def key(self) -> Tuple[str, str]:
        return (self.request.tenant, self.request.campaign)

    @property
    def pending(self) -> bool:
        return not self.done and self.inner is None


class Fleet:
    """N in-process :class:`~.service.CampaignService` replicas behind
    sharded, SLO-aware, fault-tolerant admission (module docstring).

    All replicas share ONE checkpoint root (``root_dir`` — so any
    survivor can resume any tenant's campaign from its namespace) and
    ONE flock'd plan-cache path (so no replica ever re-tunes a
    fingerprint the fleet has tuned). Everything else — engine cache,
    metrics registry, event ring, flight recorder — is per replica,
    exactly as it would be across processes.
    """

    def __init__(self, root_dir: str, n_replicas: int = 2, devices=None,
                 width: int = 4, tuner_timer=None, plan_cache_path=None,
                 buckets: Sequence = DEFAULT_BUCKETS,
                 policy: Optional[SloPolicy] = None,
                 chaos: Sequence = (),
                 retry_attempts: int = 3, retry_base_delay: float = 0.05,
                 retry_sleep=None, run_id: Optional[str] = None,
                 registry=None, events_capacity: int = 4096,
                 flight_recorder_dir: Optional[str] = None,
                 max_rounds: int = 64,
                 service_kwargs: Optional[Dict] = None) -> None:
        if int(n_replicas) < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self._devices = devices
        self._bucketer = GridBucketer(buckets)
        self._policy = policy if policy is not None else SloPolicy()
        self._chaos = list(chaos)
        self._retry_attempts = int(retry_attempts)
        self._retry_base_delay = float(retry_base_delay)
        self._retry_sleep = retry_sleep
        self._max_rounds = int(max_rounds)
        self._dispatch_errors: List[BaseException] = []
        from ..telemetry import EventLog, MetricsRegistry, RingSink
        self._ring = RingSink(events_capacity)
        self._elog = EventLog(run_id=run_id, sinks=(self._ring,))
        self.run_id = self._elog.run_id
        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        self._register_metrics()
        kw = dict(service_kwargs or {})
        self.replicas: List[_Replica] = []
        for i in range(int(n_replicas)):
            svc = CampaignService(
                root_dir=root_dir, devices=devices, width=width,
                tuner_timer=tuner_timer,
                plan_cache_path=plan_cache_path,
                run_id=f"{self.run_id}-r{i}",
                flight_recorder_dir=flight_recorder_dir, **kw)
            self.replicas.append(_Replica(name=f"replica-{i}", index=i,
                                          service=svc))
        self._campaigns: Dict[Tuple[str, str], _FleetCampaign] = {}
        self._seeded_tenants: set = set()
        self._round = 0
        self._set_replica_gauges()
        # the fleet-level fault classes log through the fleet event log
        for ev in self._chaos:
            if not isinstance(ev, (ReplicaCrash, SlowReplica,
                                   AdmissionFlood)):
                raise TypeError(
                    f"fleet chaos takes ReplicaCrash/SlowReplica/"
                    f"AdmissionFlood, got {type(ev).__name__}")

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def _register_metrics(self) -> None:
        """The fleet metric surface (names and labels are a stable
        contract, the JAX package's). Every enumerable label set is
        seeded to an explicit 0 at registration ("== 0" gates assert
        series that EXIST); per-tenant shed series are seeded the
        moment a tenant first submits."""
        m = self.metrics
        self._m_replicas = m.gauge(
            "stencil_fleet_replicas",
            "replicas by lifecycle state (active|degraded|dead)")
        self._m_shed = m.counter(
            "stencil_fleet_shed_total",
            "requests shed under overload, by tenant and named reason"
            " (queue_depth|admission_latency)")
        self._m_migrations = m.counter(
            "stencil_fleet_migrations_total",
            "campaigns migrated between replicas (rebalance: "
            "preempt-on-src -> resume-on-dst)")
        self._m_recovered = m.counter(
            "stencil_fleet_recovered_campaigns_total",
            "campaigns re-admitted to survivors after a replica "
            "death — the zero-loss gate counts these against losses")
        for c in (self._m_migrations, self._m_recovered):
            c.inc(0)
        for state in REPLICA_STATES:
            self._m_replicas.set(0, state=state)

    def _seed_tenant(self, tenant: str) -> None:
        if tenant in self._seeded_tenants:
            return
        self._seeded_tenants.add(tenant)
        for reason in SHED_REASONS:
            self._m_shed.inc(0, tenant=tenant, reason=reason)

    def _set_replica_gauges(self) -> None:
        for state in REPLICA_STATES:
            self._m_replicas.set(
                sum(1 for r in self.replicas if r.state == state),
                state=state)

    def _log(self, kind: str, **kw) -> None:
        self._elog.emit(kind, **kw)

    @property
    def events(self) -> List[Dict]:
        return self._ring.records()

    def metrics_text(self) -> str:
        return self.metrics.to_prometheus_text()

    def metrics_snapshot(self) -> Dict:
        return self.metrics.snapshot()

    def write_events(self, path: str) -> None:
        from ..telemetry import EVENT_SCHEMA_VERSION
        payload = {"schema": EVENT_SCHEMA_VERSION, "run": self.run_id,
                   "dropped_events": self._ring.dropped,
                   "events": self.events}
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _live(self) -> List[_Replica]:
        return [r for r in self.replicas if r.state == "active"]

    def replica(self, name: str) -> _Replica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(f"no replica named {name!r}")

    def _signals(self) -> Tuple[float, Optional[float]]:
        """The admission signals, read from the replicas' EXPORTED
        metric surfaces (queue-depth gauge sum + admission-latency
        histogram mean across live replicas) plus the fleet's own
        pending backlog — the same numbers an operator's scraper
        sees, not internal fields."""
        from ..telemetry import metric_value, parse_prometheus_text
        depth = float(sum(1 for c in self._campaigns.values()
                          if c.pending and not c.handle.done()))
        lat_sum, lat_count = 0.0, 0.0
        for r in self._live():
            parsed = parse_prometheus_text(r.service.metrics_text())
            depth += metric_value(parsed, "stencil_service_queue_depth")
            lat_sum += metric_value(
                parsed, "stencil_service_admission_latency_seconds_sum")
            lat_count += metric_value(
                parsed,
                "stencil_service_admission_latency_seconds_count")
        latency = (lat_sum / lat_count) if lat_count else None
        return depth, latency

    def submit(self, req: CampaignRequest) -> CampaignHandle:
        """Admit one campaign to the fleet; returns the tenant's
        handle. The grid is bucketed first (loud rejection when no
        bucket fits), then the SLO policy may shed the request with a
        named reason, then rendezvous routing decides the owning
        replica at dispatch time (:meth:`pump`)."""
        self._seed_tenant(req.tenant)
        try:
            bucketed, padded = self._bucketer.apply(req)
        except BucketError as e:
            handle = CampaignHandle(req)
            self._log("request_rejected", tenant=req.tenant,
                      campaign=req.campaign, reason="bucket",
                      grid=list(req.grid))
            handle._fail(e)
            return handle
        handle = CampaignHandle(bucketed)
        fp = request_fingerprint(bucketed, devices=self._devices)
        handle.fingerprint = fp
        depth, latency = self._signals()
        reason = self._policy.shed_reason(req.priority, depth, latency)
        if reason is not None:
            self._m_shed.inc(tenant=req.tenant, reason=reason)
            self._log("request_shed", tenant=req.tenant,
                      campaign=req.campaign, reason=reason,
                      priority=req.priority, queue_depth=depth,
                      admission_latency_seconds=latency)
            LOG_WARN(f"fleet shed {req.tenant}/{req.campaign} "
                     f"({reason}: depth={depth}, latency={latency})")
            handle._fail(RequestShed(
                f"{req.tenant}/{req.campaign} shed: {reason} "
                f"(queue_depth={depth}, "
                f"admission_latency={latency})"))
            return handle
        if padded:
            self._log("request_bucketed", tenant=req.tenant,
                      campaign=req.campaign, grid=list(req.grid),
                      bucket=list(bucketed.grid))
        key = (req.tenant, req.campaign)
        if key in self._campaigns and not self._campaigns[key].done:
            raise ValueError(
                f"campaign {req.tenant}/{req.campaign} is already "
                f"admitted and unfinished")
        self._campaigns[key] = _FleetCampaign(
            request=bucketed, handle=handle, fingerprint=fp,
            padded=padded)
        self._log("submitted", tenant=req.tenant,
                  campaign=req.campaign, fingerprint=fp,
                  priority=req.priority)
        return handle

    def route(self, c: _FleetCampaign) -> str:
        """The replica owning this campaign right now: its rebalance
        pin when that replica is live, else the rendezvous owner over
        the live set (fingerprint + tenant — one tenant's
        fingerprint-identical campaigns co-locate, so they batch)."""
        live = self._live()
        if not live:
            raise RuntimeError("fleet has no live replicas")
        if c.pinned is not None \
                and any(r.name == c.pinned for r in live):
            return c.pinned
        return rendezvous_replica(
            f"{c.fingerprint}|{c.request.tenant}",
            [r.name for r in live])

    # ------------------------------------------------------------------
    # the serving rounds
    # ------------------------------------------------------------------
    def pump(self) -> None:
        """One deterministic serving round: fire chaos due this round,
        dispatch pending campaigns to their routed replicas, drain
        each live replica (catching hard crashes), harvest results."""
        r = self._round
        self._round += 1
        self._fire_chaos(r)
        self._dispatch_pending()
        self._drain_replicas()
        self._harvest()

    def serve(self) -> None:
        """Pump rounds until every admitted campaign resolves and no
        scheduled chaos remains — the test/CI entry point."""
        while True:
            busy = any(not c.done and not c.handle.done()
                       for c in self._campaigns.values())
            chaos_left = any(
                ev.fired < ev.repeat
                or (isinstance(ev, SlowReplica)
                    and ev.recover_step is not None
                    and ev.restored < ev.fired)
                for ev in self._chaos)
            if not busy and not chaos_left:
                return
            if self._round >= self._max_rounds:
                raise RuntimeError(
                    f"fleet failed to quiesce within "
                    f"{self._max_rounds} rounds")
            self.pump()

    def _fire_chaos(self, rnd: int) -> None:
        for ev in self._chaos:
            if isinstance(ev, ReplicaCrash):
                if ev.due(rnd):
                    ev.fire(self._log)
                    rep = self.replicas[ev.replica]
                    if rep.state == "active":
                        rep.service.arm_crash_at(ev.at_member_step)
            elif isinstance(ev, SlowReplica):
                if ev.due(rnd):
                    ev.fire(self._log)
                    self._degrade(self.replicas[ev.replica])
                if ev.recover_due(rnd):
                    ev.recover(self._log)
                    self._restore(self.replicas[ev.replica])
            elif isinstance(ev, AdmissionFlood):
                if ev.due(rnd):
                    ev.fire(self._log)
                    for i in range(ev.count):
                        self.submit(CampaignRequest(
                            tenant=ev.tenant,
                            campaign=f"flood-{rnd}-{ev.fired}-{i}",
                            grid=ev.grid, n_steps=ev.n_steps,
                            priority=ev.priority))

    def _dispatch(self, rep: _Replica, req: CampaignRequest
                  ) -> CampaignHandle:
        """Submit to a replica under retry/backoff: a transient
        dispatch failure (an ``OSError``, incl. injected
        :class:`TransientDispatchError`) costs ``base_delay * 2**k``
        backoffs, not the campaign. Every retried failure is a loud
        ``dispatch_retry`` event."""
        def call() -> CampaignHandle:
            if self._dispatch_errors:
                raise self._dispatch_errors.pop(0)
            return rep.service.submit(req)

        def on_retry(attempt: int, exc: BaseException,
                     delay: float) -> None:
            self._log("dispatch_retry", replica=rep.name,
                      tenant=req.tenant, campaign=req.campaign,
                      attempt=attempt, delay_seconds=delay,
                      error=f"{type(exc).__name__}: {exc}")

        return retry(call, attempts=self._retry_attempts,
                     base_delay=self._retry_base_delay,
                     sleep=self._retry_sleep, on_retry=on_retry)

    def inject_dispatch_error(self, *errors: BaseException) -> None:
        """Test/chaos hook: the next ``len(errors)`` replica
        dispatches raise these (in order) before reaching the
        replica — the injectable face of the retry/backoff path."""
        self._dispatch_errors.extend(errors)

    def _dispatch_pending(self) -> None:
        for c in self._campaigns.values():
            if not c.pending or c.handle.done():
                continue
            try:
                name = self.route(c)
            except RuntimeError as e:
                c.handle._fail(e)
                c.done = True
                continue
            rep = self.replica(name)
            # a replica the fleet preempted or readmitted serves again
            rep.service._stop = False
            rep.service._preempt = False
            try:
                inner = self._dispatch(rep, c.request)
            except Exception as e:  # noqa: BLE001 - budget exhausted
                self._log("dispatch_failed", replica=name,
                          tenant=c.request.tenant,
                          campaign=c.request.campaign,
                          error=f"{type(e).__name__}: {e}")
                c.handle._fail(e)
                c.done = True
                continue
            c.replica, c.inner = name, inner

    def _drain_replicas(self) -> None:
        for rep in self.replicas:
            if rep.state != "active" or not len(rep.service.queue):
                continue
            # a replica stopped by graceful preemption serves its
            # remaining queue next round (the fleet, not the stop
            # flag, decides who serves)
            rep.service._stop = False
            rep.service._preempt = False
            try:
                rep.service.drain()
            except ReplicaCrashed as e:
                self._on_replica_crash(rep, e)

    def _harvest(self) -> None:
        for c in self._campaigns.values():
            if c.done or c.inner is None or not c.inner.done():
                continue
            try:
                res = c.inner.result(timeout=0)
            except Exception as e:  # noqa: BLE001 - pass through
                c.handle._fail(e)
                c.done = True
                continue
            if res.preempted and res.steps < c.request.n_steps:
                # graceful preemption checkpointed it mid-run: back to
                # pending; routing/pinning decides where it resumes
                self._log("campaign_requeued",
                          tenant=c.request.tenant,
                          campaign=c.request.campaign,
                          step=res.steps, from_replica=c.replica)
                c.inner = None
                c.replica = None
            else:
                c.handle._resolve(res)
                c.done = True

    # ------------------------------------------------------------------
    # fault tolerance
    # ------------------------------------------------------------------
    def _on_replica_crash(self, rep: _Replica,
                          err: ReplicaCrashed) -> None:
        """A replica hard-crashed mid-batch: mark it dead and recover
        every campaign it held — unresolved inner handles (in-RAM
        lanes died with the process) AND still-queued entries — back
        to pending, where dispatch re-routes them to survivors. The
        campaigns resume from their per-tenant checkpoint namespaces
        on the shared root (bitwise-continuous; zero-loss gate)."""
        rep.state = "dead"
        self._set_replica_gauges()
        self._log("replica_dead", replica=rep.name,
                  error=f"{type(err).__name__}: {err}")
        LOG_WARN(f"fleet: {rep.name} crashed ({err}); recovering its "
                 f"campaigns to survivors")
        # still-queued entries die with the process too
        rep.service.queue.drain_entries()
        for c in self._campaigns.values():
            if c.done or c.replica != rep.name:
                continue
            if c.inner is not None and c.inner.done():
                continue        # resolved before the crash: harvest it
            c.inner = None
            c.replica = None
            c.recoveries += 1
            self._m_recovered.inc()
            self._log("campaign_recovered", tenant=c.request.tenant,
                      campaign=c.request.campaign,
                      from_replica=rep.name)

    def _degrade(self, rep: _Replica) -> None:
        """The degradation ladder's first rungs for a slow replica:
        drain it (no new dispatches) and reshard its tenants — queued
        entries and unfinished campaigns go back to pending, where
        routing re-spreads them over the survivors."""
        if rep.state != "active":
            return
        rep.state = "degraded"
        self._set_replica_gauges()
        self._log("replica_degraded", replica=rep.name)
        rep.service.queue.drain_entries()
        for c in self._campaigns.values():
            if c.done or c.replica != rep.name:
                continue
            if c.inner is not None and c.inner.done():
                continue
            c.inner = None
            c.replica = None
            self._log("campaign_resharded", tenant=c.request.tenant,
                      campaign=c.request.campaign,
                      from_replica=rep.name)

    def _restore(self, rep: _Replica) -> None:
        """The ladder's last rung: readmit a recovered replica to the
        active set (routing sees it again on the next dispatch)."""
        if rep.state != "degraded":
            return
        rep.state = "active"
        rep.service._stop = False
        rep.service._preempt = False
        self._set_replica_gauges()
        self._log("replica_recovered", replica=rep.name)
        LOG_INFO(f"fleet: {rep.name} readmitted to the active set")

    # ------------------------------------------------------------------
    # rebalancing
    # ------------------------------------------------------------------
    def loads(self) -> Dict[str, int]:
        """Unfinished campaigns per live replica (current routing) —
        the signal :meth:`rebalance` balances."""
        load = {r.name: 0 for r in self._live()}
        if not load:
            return load
        for c in self._campaigns.values():
            if c.done or c.handle.done():
                continue
            name = c.replica if c.replica in load else self.route(c)
            if name in load:
                load[name] += 1
        return load

    def migrate(self, tenant: str, campaign: str, dst: str) -> None:
        """Move one campaign to replica ``dst``: preempt-on-src (take
        it back from the source queue if still queued; arm graceful
        preemption if it is mid-batch — the campaign checkpoints and
        returns to pending at the next boundary) then resume-on-dst
        (the pin routes it there on the next dispatch). The shared
        plan cache means ``dst`` re-tunes nothing; a ``dst`` that
        already built the fingerprint recompiles nothing."""
        c = self._campaigns.get((tenant, campaign))
        if c is None or c.done:
            raise KeyError(f"no unfinished campaign "
                           f"{tenant}/{campaign} to migrate")
        self.replica(dst)       # validate the destination exists
        src = c.replica
        if src is not None and c.inner is not None \
                and not c.inner.done():
            entry = self.replica(src).service.queue.take(tenant,
                                                         campaign)
            if entry is None:
                # mid-batch on src: graceful preemption brings it back
                # to pending at the next segment boundary
                self.replica(src).service.preempt()
            c.inner = None
        c.pinned = dst
        c.replica = None
        self._m_migrations.inc()
        self._log("migration", tenant=tenant, campaign=campaign,
                  from_replica=src, to_replica=dst)

    def rebalance(self) -> List[Dict]:
        """Pick migrations from per-replica load and execute them
        (:meth:`migrate`): while the most- and least-loaded live
        replicas differ by >= 2 campaigns, move the youngest movable
        campaign from the former to the latter. Returns the executed
        migration records."""
        out: List[Dict] = []
        while True:
            load = self.loads()
            if len(load) < 2:
                return out
            src = max(load, key=lambda n: (load[n], n))
            dst = min(load, key=lambda n: (load[n], n))
            if load[src] - load[dst] < 2:
                return out
            movable = [c for c in self._campaigns.values()
                       if not c.done and not c.handle.done()
                       and (c.replica or self.route(c)) == src]
            if not movable:
                return out
            c = movable[-1]
            self.migrate(c.request.tenant, c.request.campaign, dst)
            out.append({"tenant": c.request.tenant,
                        "campaign": c.request.campaign,
                        "from": src, "to": dst})
