"""The port's serving fleet (``stencil_tpu_torch/serving``: slo, fleet)
against the JAX package's.

The admission policies are pure and equal JAX's outright (bucketing,
shed thresholds, and the rendezvous owners of the same keys). The fleet
asserts from its exported surfaces (Prometheus text, events): a
replica killed mid-fleet loses no campaign and every recovered campaign
finishes bitwise as in a fault-free fleet — and as in JAX's fleet for
the same requests — with no recompiles and no tuner measurements on
the survivors; floods are shed loudly below the protected priority;
rebalance migrations resume bitwise on a destination that builds
nothing; bucketing bounds the engine cache. Every case of JAX's
``tests/test_fleet.py`` has its counterpart here (marked "JAX:"). The
port's fingerprints differ from JAX's (they name the platform), so the
rendezvous owner of a tenant is computed per package.
"""

import time

import jax
import numpy as np
import pytest

from stencil_tpu_torch.resilience.faults import (AdmissionFlood,
                                                 ReplicaCrash, SlowReplica)
from stencil_tpu_torch.serving import (BucketError, CampaignRequest,
                                       DeadlineExpired, Fleet, GridBucketer,
                                       RequestQueue, RequestShed, SloPolicy,
                                       TransientDispatchError,
                                       rendezvous_replica)
from stencil_tpu_torch.serving.queue import request_fingerprint
from stencil_tpu_torch.telemetry import (metric_value, parse_prometheus_text,
                                         validate_events)
from stencil_tpu_torch.tuning import FakeTimer
from torch_port_support import reference_modules, run_jax_app

jax.config.update("jax_platforms", "cpu")

MESH = (2, 2, 2)
GRID = (8, 8, 8)
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def jf():
    """JAX's serving package, faults and FakeTimer for the module."""
    with reference_modules():
        import stencil_tpu.resilience.faults as faults
        import stencil_tpu.serving as serving
        import stencil_tpu.serving.queue as queue
        from stencil_tpu.tuning import FakeTimer as JaxFakeTimer

        serving.queue = queue
        serving.faults = faults
        serving.FakeTimer = JaxFakeTimer
        yield serving


def req(tenant="t0", campaign="c0", mod=None, **kw):
    kw.setdefault("grid", GRID)
    kw.setdefault("n_steps", 4)
    kw.setdefault("ckpt_every", 2)
    kw.setdefault("mesh_shape", MESH)
    cls = CampaignRequest if mod is None else mod.CampaignRequest
    return cls(tenant=tenant, campaign=campaign, **kw)


def fleet(tmp_path, tag, **kw):
    kw.setdefault("n_replicas", 3)
    kw.setdefault("width", 4)
    kw.setdefault("tuner_timer", FakeTimer())
    kw.setdefault("plan_cache_path", str(tmp_path / f"plans-{tag}.json"))
    kw.setdefault("devices", CPU8)
    return Fleet(str(tmp_path / f"root-{tag}"), **kw)


def owner_of(tenant, n_replicas=3, request=None, fp_fn=None):
    """The rendezvous owner the fleet will route this tenant to."""
    if fp_fn is None:
        fp = request_fingerprint(request if request is not None
                                 else req(tenant=tenant), devices=CPU8)
    else:
        fp = fp_fn(request)
    names = [f"replica-{i}" for i in range(n_replicas)]
    return rendezvous_replica(f"{fp}|{tenant}", names)


# ---------------------------------------------------------------------------
# queue: priority + deadline ordering


def test_queue_priority_order_stable_fifo_within_class():
    """JAX: test_queue_priority_order_stable_fifo_within_class."""
    q = RequestQueue(CPU8)
    a = q.submit(req(tenant="a", priority=1))
    b = q.submit(req(tenant="b", priority=2))
    c = q.submit(req(tenant="c", priority=2))
    d = q.submit(req(tenant="d", priority=1))
    assert [e.handle for e in q.pop_batch(width=4)] == [b, c, a, d]


def test_queue_priority_back_compat_default_is_fifo():
    """JAX: test_queue_priority_back_compat_default_is_fifo."""
    q = RequestQueue(CPU8)
    handles = [q.submit(req(tenant=f"t{i}")) for i in range(4)]
    assert [e.handle for e in q.pop_batch(width=4)] == handles


def test_queue_priority_head_other_fingerprints_keep_place():
    """JAX: test_queue_priority_head_other_fingerprints_keep_place."""
    q = RequestQueue(CPU8)
    q.submit(req(tenant="low", priority=0))
    q.submit(req(tenant="big", grid=(16, 8, 8), priority=5))
    assert [e.request.tenant for e in q.pop_batch(width=4)] == ["big"]
    assert q.pop_batch(width=4)[0].request.tenant == "low"


def test_queue_deadline_expired_rejected_at_pop():
    """JAX: test_queue_deadline_expired_rejected_at_pop."""
    expired_cb = []
    q = RequestQueue(CPU8, on_expired=expired_cb.append)
    dead = q.submit(req(tenant="dead", deadline_seconds=0.01))
    live = q.submit(req(tenant="live"))
    time.sleep(0.05)
    assert [e.handle for e in q.pop_batch(width=4)] == [live]
    assert dead.done()
    with pytest.raises(DeadlineExpired):
        dead.result(timeout=0)
    assert [e.request.tenant for e in expired_cb] == ["dead"]


def test_queue_deadline_validation():
    """JAX: test_queue_deadline_validation."""
    with pytest.raises(ValueError):
        req(deadline_seconds=0).validate()
    with pytest.raises(ValueError):
        req(deadline_seconds=-1.0).validate()
    req(deadline_seconds=30.0).validate()


# ---------------------------------------------------------------------------
# bucketing + rendezvous policy units


def test_bucketer_picks_smallest_fit_and_rejects_oversize():
    """JAX: test_bucketer_picks_smallest_fit_and_rejects_oversize."""
    b = GridBucketer(((16, 16, 16), (8, 8, 8)))
    assert b.bucket_for((5, 6, 7)) == (8, 8, 8)
    assert b.bucket_for((8, 8, 8)) == (8, 8, 8)
    assert b.bucket_for((9, 2, 2)) == (16, 16, 16)
    with pytest.raises(BucketError):
        b.bucket_for((17, 1, 1))
    padded, was_padded = b.apply(req(grid=(5, 6, 7)))
    assert was_padded and padded.grid == (8, 8, 8)
    same, untouched = b.apply(req(grid=(8, 8, 8)))
    assert not untouched and same.grid == (8, 8, 8)


def test_bucketed_request_shares_native_fingerprint():
    """JAX: test_bucketed_request_shares_native_fingerprint."""
    b = GridBucketer(((8, 8, 8),))
    padded, _ = b.apply(req(tenant="pad", grid=(5, 6, 7)))
    assert request_fingerprint(padded, devices=CPU8) == \
        request_fingerprint(req(tenant="nat", grid=(8, 8, 8)),
                            devices=CPU8)


def test_rendezvous_death_remaps_only_the_dead_replicas_keys(jf):
    """JAX: test_rendezvous_death_remaps_only_the_dead_replicas_keys —
    and every owner equals JAX's for the same keys."""
    names = ["replica-0", "replica-1", "replica-2"]
    keys = [f"fp|tenant-{i}" for i in range(40)]
    before = {k: rendezvous_replica(k, names) for k in keys}
    assert before == {k: jf.rendezvous_replica(k, names) for k in keys}
    assert len(set(before.values())) == 3
    survivors = [n for n in names if n != "replica-1"]
    for k in keys:
        after = rendezvous_replica(k, survivors)
        assert after == jf.rendezvous_replica(k, survivors)
        if before[k] != "replica-1":
            assert after == before[k]
        else:
            assert after in survivors


def test_shed_reason_thresholds():
    """JAX: test_shed_reason_thresholds."""
    p = SloPolicy(max_queue_depth=4, max_admission_latency_seconds=1.0,
                  protected_priority=1)
    assert p.shed_reason(1, 100, 100.0) is None
    assert p.shed_reason(0, 4, None) == "queue_depth"
    assert p.shed_reason(0, 3, 2.0) == "admission_latency"
    assert p.shed_reason(0, 3, 0.5) is None


# ---------------------------------------------------------------------------
# the zero-loss gate: replica crash -> recovery, bitwise


def test_replica_crash_recovers_all_campaigns_bitwise(tmp_path, jf):
    """JAX: test_replica_crash_recovers_all_campaigns_bitwise — and the
    recovered campaigns equal JAX's fleet under the same chaos (its
    victim the owner of t0 by JAX's fingerprints)."""
    tenants = [f"t{i}" for i in range(4)]
    reqs = [req(tenant=t, n_steps=6, ckpt_every=2) for t in tenants]
    plans = str(tmp_path / "plans-shared.json")
    calm = fleet(tmp_path, "calm", plan_cache_path=plans)
    calm_handles = [calm.submit(r) for r in reqs]
    calm.serve()
    calm_final = {t: h.result(timeout=0).final["temp"]
                  for t, h in zip(tenants, calm_handles)}
    victim = int(owner_of("t0").rsplit("-", 1)[1])
    chaos = fleet(tmp_path, "chaos", plan_cache_path=plans, chaos=[
        ReplicaCrash(step=0, replica=victim, at_member_step=2)])
    handles = [chaos.submit(r) for r in reqs]
    chaos.serve()
    for t, h in zip(tenants, handles):
        np.testing.assert_array_equal(calm_final[t],
                                      h.result(timeout=0).final["temp"])
    text = chaos.metrics_text()
    assert metric_value(text, "stencil_fleet_replicas", state="dead") == 1.0
    assert metric_value(text, "stencil_fleet_replicas",
                        state="active") == 2.0
    assert metric_value(
        text, "stencil_fleet_recovered_campaigns_total") >= 1.0
    for rep in chaos.replicas:
        if rep.state != "active":
            continue
        parsed = parse_prometheus_text(rep.service.metrics_text())
        assert parsed["stencil_service_recompiles_total"] == {(): 0.0}
        assert parsed["stencil_service_tuner_measurements_total"] == \
            {(): 0.0}
    kinds = [e["event"] for e in chaos.events]
    assert {"fault_replica_crash", "replica_dead",
            "campaign_recovered"} <= set(kinds)
    assert validate_events(chaos.events) == []

    jreqs = [req(tenant=t, n_steps=6, ckpt_every=2, mod=jf)
             for t in tenants]
    jvictim = int(owner_of(
        "t0", request=jreqs[0],
        fp_fn=jf.queue.request_fingerprint).rsplit("-", 1)[1])
    jchaos = jf.Fleet(
        str(tmp_path / "jroot"), n_replicas=3, width=4,
        tuner_timer=jf.FakeTimer(),
        plan_cache_path=str(tmp_path / "jplans.json"),
        chaos=[jf.faults.ReplicaCrash(step=0, replica=jvictim,
                                      at_member_step=2)])
    jhandles = [jchaos.submit(r) for r in jreqs]
    jchaos.serve()
    for t, h in zip(tenants, jhandles):
        np.testing.assert_array_equal(
            calm_final[t], np.asarray(h.result(timeout=0).final["temp"]))


# ---------------------------------------------------------------------------
# SLO shedding under flood


def test_flood_is_shed_loudly_and_protected_tenants_unaffected(tmp_path):
    """JAX: test_flood_is_shed_loudly_and_protected_tenants_unaffected."""
    protected = [req(tenant="alice"), req(tenant="bob")]
    calm = fleet(tmp_path, "calm", n_replicas=2)
    calm_h = {r.tenant: calm.submit(r) for r in protected}
    calm.serve()
    calm_final = {t: h.result(timeout=0).final["temp"]
                  for t, h in calm_h.items()}
    flooded = fleet(
        tmp_path, "flood", n_replicas=2,
        policy=SloPolicy(max_queue_depth=3),
        chaos=[AdmissionFlood(step=0, tenant="flood", count=6,
                              priority=0, n_steps=1)])
    handles = {r.tenant: flooded.submit(r) for r in protected}
    flooded.serve()
    for t, h in handles.items():
        np.testing.assert_array_equal(calm_final[t],
                                      h.result(timeout=0).final["temp"])
    text = flooded.metrics_text()
    shed = metric_value(text, "stencil_fleet_shed_total", tenant="flood",
                        reason="queue_depth")
    assert shed >= 1.0
    parsed = parse_prometheus_text(text)
    for t in ("alice", "bob"):
        for reason in ("queue_depth", "admission_latency"):
            assert parsed["stencil_fleet_shed_total"][
                (("reason", reason), ("tenant", t))] == 0.0
    sheds = [e for e in flooded.events if e["event"] == "request_shed"]
    assert len(sheds) == int(shed)
    assert all(e["reason"] == "queue_depth" and e["tenant"] == "flood"
               for e in sheds)
    assert validate_events(flooded.events) == []


def test_shed_request_fails_its_handle(tmp_path):
    """A shed request's handle fails with ``RequestShed`` at once."""
    fl = fleet(tmp_path, "shed", n_replicas=1,
               policy=SloPolicy(max_queue_depth=1))
    fl.submit(req(tenant="a"))
    h = fl.submit(req(tenant="b", priority=0))
    assert h.done()
    with pytest.raises(RequestShed):
        h.result(timeout=0)


# ---------------------------------------------------------------------------
# rebalance: preempt-on-src -> resume-on-dst, zero dst recompiles


def test_rebalance_migration_bitwise_zero_destination_recompiles(
        tmp_path):
    """JAX: test_rebalance_migration_bitwise_zero_destination_
    recompiles."""
    mig_req = req(tenant="mig", n_steps=6, ckpt_every=2)
    plans = str(tmp_path / "plans-shared.json")
    calm = fleet(tmp_path, "calm", n_replicas=2, plan_cache_path=plans)
    h = calm.submit(mig_req)
    calm.serve()
    calm_final = h.result(timeout=0).final["temp"]
    fl = fleet(tmp_path, "mig", n_replicas=2, plan_cache_path=plans)
    src = owner_of("mig", n_replicas=2, request=mig_req)
    dst = next(r.name for r in fl.replicas if r.name != src)
    warm_tenant = next(
        f"w{i}" for i in range(64)
        if owner_of(f"w{i}", n_replicas=2,
                    request=req(tenant=f"w{i}")) == dst)
    warm = fl.submit(req(tenant=warm_tenant, n_steps=2, ckpt_every=2))
    handle = fl.submit(mig_req)
    fl.replica(src).service.arm_preempt_at(2)
    fl.pump()
    assert warm.done() and not handle.done()
    fl.migrate("mig", "c0", dst)
    fl.serve()
    res = handle.result(timeout=0)
    np.testing.assert_array_equal(calm_final, res.final["temp"])
    assert res.resumed_from == 2
    dtext = fl.replica(dst).service.metrics_text()
    assert metric_value(dtext, "stencil_service_recompiles_total") == 0.0
    assert metric_value(dtext,
                        "stencil_service_tuner_measurements_total") == 0.0
    assert metric_value(dtext, "stencil_service_compiles_total") == 1.0
    assert metric_value(fl.metrics_text(),
                        "stencil_fleet_migrations_total") == 1.0
    migs = [e for e in fl.events if e["event"] == "migration"]
    assert len(migs) == 1 and migs[0]["to_replica"] == dst


def test_rebalance_picks_migrations_from_load(tmp_path):
    """JAX: test_rebalance_picks_migrations_from_load."""
    fl = fleet(tmp_path, "bal", n_replicas=2)
    for i in range(4):
        fl.submit(req(tenant=f"t{i}", n_steps=2))
        fl._campaigns[(f"t{i}", "c0")].pinned = "replica-0"
    moved = fl.rebalance()
    assert len(moved) == 2
    assert all(m["from"] == "replica-0" and m["to"] == "replica-1"
               for m in moved)
    load = fl.loads()
    assert abs(load["replica-0"] - load["replica-1"]) < 2
    fl.serve()
    for c in fl._campaigns.values():
        assert c.handle.result(timeout=0).steps == 2


# ---------------------------------------------------------------------------
# bucketing bounds the engine cache


def test_bucketing_caps_engine_cache_under_20_distinct_grids(tmp_path):
    """JAX: test_bucketing_caps_engine_cache_under_20_distinct_grids."""
    fl = fleet(tmp_path, "buckets", n_replicas=1)
    grids = [(2 + a, 2 + b, 8) for a in range(4) for b in range(5)]
    assert len(set(grids)) == 20
    handles = [fl.submit(req(tenant=f"g{i}", grid=g, n_steps=1,
                             ckpt_every=0))
               for i, g in enumerate(grids)]
    fl.serve()
    for h in handles:
        assert h.result(timeout=0).steps == 1
        assert h.request.grid == (8, 8, 8)
    rtext = fl.replicas[0].service.metrics_text()
    assert metric_value(rtext, "stencil_service_engine_cache_size") == 1.0
    assert metric_value(rtext, "stencil_service_compiles_total") == 1.0
    assert metric_value(rtext, "stencil_service_recompiles_total") == 0.0
    assert len([e for e in fl.events
                if e["event"] == "request_bucketed"]) == 20


def test_unbucketable_grid_rejected_loudly(tmp_path):
    """JAX: test_unbucketable_grid_rejected_loudly."""
    fl = fleet(tmp_path, "reject", n_replicas=1)
    h = fl.submit(req(tenant="huge", grid=(64, 64, 64)))
    assert h.done()
    with pytest.raises(BucketError):
        h.result(timeout=0)
    assert any(e["event"] == "request_rejected" and e["reason"] == "bucket"
               for e in fl.events)


# ---------------------------------------------------------------------------
# slow-replica degradation ladder


def test_slow_replica_drains_reshards_and_readmits(tmp_path):
    """JAX: test_slow_replica_drains_resards_and_readmits."""
    victim_name = owner_of("t0")
    victim = int(victim_name.rsplit("-", 1)[1])
    fl = fleet(tmp_path, "slow", chaos=[
        SlowReplica(step=0, replica=victim, recover_step=1)])
    handles = [fl.submit(req(tenant=f"t{i}", n_steps=2)) for i in range(3)]
    fl.serve()
    for h in handles:
        assert h.result(timeout=0).steps == 2
    vtext = fl.replica(victim_name).service.metrics_text()
    assert metric_value(vtext, "stencil_service_batches_total") == 0.0
    kinds = [e["event"] for e in fl.events]
    assert "replica_degraded" in kinds and "replica_recovered" in kinds
    text = fl.metrics_text()
    assert metric_value(text, "stencil_fleet_replicas", state="active") == 3
    assert metric_value(text, "stencil_fleet_replicas",
                        state="degraded") == 0.0
    h2 = fl.submit(req(tenant="t0", campaign="c1", n_steps=2))
    fl.serve()
    assert h2.result(timeout=0).steps == 2
    assert metric_value(fl.replica(victim_name).service.metrics_text(),
                        "stencil_service_batches_total") == 1.0


# ---------------------------------------------------------------------------
# dispatch retry/backoff


def test_transient_dispatch_failure_retries_with_backoff(tmp_path):
    """JAX: test_transient_dispatch_failure_retries_with_backoff."""
    delays = []
    fl = fleet(tmp_path, "retry", n_replicas=1, retry_base_delay=0.05,
               retry_sleep=delays.append)
    fl.inject_dispatch_error(TransientDispatchError("blip"),
                             TransientDispatchError("blip"))
    h = fl.submit(req(tenant="t0", n_steps=2))
    fl.serve()
    assert h.result(timeout=0).steps == 2
    assert delays == [0.05, 0.1]
    retries = [e for e in fl.events if e["event"] == "dispatch_retry"]
    assert [r["attempt"] for r in retries] == [1, 2]


def test_dispatch_retry_budget_exhaustion_fails_the_campaign(tmp_path):
    """JAX: test_dispatch_retry_budget_exhaustion_fails_the_campaign."""
    fl = fleet(tmp_path, "retryx", n_replicas=1, retry_attempts=2,
               retry_sleep=lambda _d: None)
    fl.inject_dispatch_error(*(TransientDispatchError("down")
                               for _ in range(3)))
    h = fl.submit(req(tenant="t0", n_steps=2))
    fl.serve()
    with pytest.raises(TransientDispatchError):
        h.result(timeout=0)
    assert any(e["event"] == "dispatch_failed" for e in fl.events)


def test_non_retriable_dispatch_error_propagates_immediately(tmp_path):
    """JAX: test_non_retriable_dispatch_error_propagates_immediately."""
    delays = []
    fl = fleet(tmp_path, "retrynr", n_replicas=1,
               retry_sleep=delays.append)
    fl.inject_dispatch_error(ValueError("not transient"))
    h = fl.submit(req(tenant="t0", n_steps=2))
    fl.serve()
    with pytest.raises(ValueError):
        h.result(timeout=0)
    assert delays == []


# ---------------------------------------------------------------------------
# the fleet app against JAX's


def test_fleet_app_digests_equal_jax(jf, tmp_path, capsys):
    """``python -m stencil_tpu_torch.apps.fleet`` under a replica kill
    and a flood: every campaign's sha256 digest equals the JAX app's,
    and the calm run's."""
    import json

    from stencil_tpu_torch.apps import fleet as app

    base = ["--replicas", "3", "--tenants", "4", "--fake-timer"]
    chaos = ["--kill-owner-of", "t0", "--flood", "6",
             "--max-queue-depth", "3"]
    dev = ["--devices", ",".join(CPU8)]
    for tag, extra in (("calm", []), ("chaos", chaos)):
        assert app.main(base + extra + dev + [
            "--tune-cache", str(tmp_path / "p.json"),
            "--results-json", str(tmp_path / f"{tag}.json")]) == 0
    run_jax_app("fleet", base + chaos + [
        "--tune-cache", str(tmp_path / "j.json"),
        "--results-json", str(tmp_path / "jax.json")])
    out = capsys.readouterr().out
    assert "fleet: replicas=" in out and "campaigns_ok=4/4" in out
    res = {t: json.load(open(tmp_path / f"{t}.json"))["campaigns"]
           for t in ("calm", "chaos", "jax")}
    for t in (f"t{i}" for i in range(4)):
        assert res["chaos"][t]["ok"] and res["jax"][t]["ok"]
        assert res["chaos"][t]["digest"] == res["calm"][t]["digest"] == \
            res["jax"][t]["digest"]
