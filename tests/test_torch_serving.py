"""The port's campaign service (``stencil_tpu_torch/serving``: queue,
service) against the JAX package's.

For the same requests both services hand back the same campaigns: the
final fields bitwise (Jacobi) or within rtol 1e-11 (Astaroth, float64),
the same snapshot steps and snapshots, the same ``ServiceStats`` and
the same events (``same_events``: the checkpoints may be reported a
turn later; the attributor's ``perf_*`` events follow each run's own
clock and are left out). Every case of JAX's ``tests/test_serving.py``
has its counterpart here (marked "JAX:"). The fingerprints name each
package's platform, so their strings differ; their groupings agree.
JAX runs on its fake 8-device CPU mesh, the port on 8 CPU shards.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from stencil_tpu_torch.serving import (CampaignRequest, CampaignService,
                                       RequestQueue)
from stencil_tpu_torch.serving.queue import request_fingerprint
from stencil_tpu_torch.serving.service import CampaignFailed
from stencil_tpu_torch.telemetry import metric_value, parse_prometheus_text
from stencil_tpu_torch.tuning import FakeTimer
from torch_port_support import reference_modules, run_jax_app, same_events

jax.config.update("jax_platforms", "cpu")

GRID = (8, 8, 8)
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def js():
    """JAX's serving package and FakeTimer, runnable for the module."""
    with reference_modules():
        import stencil_tpu.serving as serving
        import stencil_tpu.serving.queue as queue
        from stencil_tpu.tuning import FakeTimer as JaxFakeTimer

        serving.queue = queue
        serving.FakeTimer = JaxFakeTimer
        yield serving


def req(tenant="t0", campaign="c0", mod=None, **kw):
    kw.setdefault("grid", GRID)
    kw.setdefault("n_steps", 4)
    kw.setdefault("ckpt_every", 2)
    cls = CampaignRequest if mod is None else mod.CampaignRequest
    return cls(tenant=tenant, campaign=campaign, **kw)


def service(tmp_path, **kw):
    kw.setdefault("width", 4)
    kw.setdefault("tuner_timer", FakeTimer())
    kw.setdefault("plan_cache_path", str(tmp_path / "plans.json"))
    kw.setdefault("devices", CPU8)
    return CampaignService(str(tmp_path / "root"), **kw)


def jax_service(js, tmp_path, **kw):
    kw.setdefault("width", 4)
    kw.setdefault("tuner_timer", js.FakeTimer())
    kw.setdefault("plan_cache_path", str(tmp_path / "jplans.json"))
    return js.CampaignService(str(tmp_path / "jroot"), **kw)


def _events(svc):
    return [(e["event"], e.get("tenant"), e.get("step"))
            for e in svc.events if not e["event"].startswith("perf_")]


# ---------------------------------------------------------------------------
# requests, fingerprints, admission


def test_request_validation_rejects_traversal_ids():
    """JAX: test_request_validation_rejects_traversal_ids."""
    for bad in ("", "..", ".", "a/b", "a\\b", "x\x00y", "a\nb"):
        with pytest.raises(ValueError):
            req(tenant=bad).validate()
        with pytest.raises(ValueError):
            req(campaign=bad).validate()
    req(tenant="tenant-1.prod_a", campaign="run..01").validate()


def test_fingerprint_groups_compatible_requests(js):
    """JAX: test_fingerprint_groups_compatible_requests — the port's
    fingerprints group the requests exactly as JAX's do (tenant, steps
    and params never change the engine; grid, dtype, model and boundary
    do)."""
    variants = [dict(tenant="a"), dict(tenant="b", n_steps=99,
                                       params={"hot_temp": 2.0}),
                dict(grid=(16, 8, 8)), dict(dtype="float64"),
                dict(model="astaroth"), dict(boundary="NONE"),
                dict(tenant="c", priority=3)]
    port = [request_fingerprint(req(**v), devices=CPU8) for v in variants]
    jfp = [js.queue.request_fingerprint(req(mod=js, **v))
           for v in variants]
    same = [[a == b for b in port] for a in port]
    assert same == [[a == b for b in jfp] for a in jfp]
    assert port[0] == port[1] == port[6]
    assert len(set(port)) == 5


def test_queue_pop_batch_groups_by_fingerprint():
    """JAX: test_queue_pop_batch_groups_by_fingerprint."""
    q = RequestQueue(CPU8)
    a0 = q.submit(req(tenant="a"))
    q.submit(req(tenant="big", grid=(16, 8, 8)))
    a1 = q.submit(req(tenant="b"))
    batch = q.pop_batch(width=4)
    assert [e.handle for e in batch] == [a0, a1]
    assert len(q) == 1
    assert q.pop_batch(width=4)[0].request.tenant == "big"


def test_queue_pop_batch_respects_width():
    """JAX: test_queue_pop_batch_respects_width."""
    q = RequestQueue(CPU8)
    for i in range(5):
        q.submit(req(tenant=f"t{i}"))
    assert len(q.pop_batch(width=3)) == 3
    assert len(q.pop_batch(width=3)) == 2


# ---------------------------------------------------------------------------
# the service against JAX's


SCENARIOS = {
    # three tenants, snapshots, one poisoned lane rolled back
    "rollback": [dict(tenant=f"t{i}", campaign="c", init_seed=50 + i,
                      snapshot_every=2, n_steps=6,
                      chaos_nan_step=3 if i == 0 else None,
                      params={"hot_temp": 1.0 + 0.25 * i})
                 for i in range(3)],
    # two fingerprints (two batches), a failed campaign, check_every 2
    "mixed": [dict(tenant="bad", chaos_nan_step=2, ckpt_every=0,
                   max_retries=0),
              dict(tenant="big", grid=(16, 8, 8), init_seed=3,
                   check_every=2, n_steps=5),
              dict(tenant="good", init_seed=4, snapshot_every=3,
                   n_steps=7)],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_service_equals_jax(js, tmp_path, name):
    """The same requests through both services: final fields and
    snapshots bitwise, snapshot steps, rollbacks, failures, stats and
    events equal."""
    reqs = SCENARIOS[name]
    svc = service(tmp_path)
    ref = jax_service(js, tmp_path)
    got = [svc.submit(req(**r)) for r in reqs]
    want = [ref.submit(req(mod=js, **r)) for r in reqs]
    svc.drain()
    ref.drain()
    for g, w in zip(got, want):
        try:
            wr = w.result(timeout=0)
        except Exception as e:  # noqa: BLE001 - compared below
            with pytest.raises(CampaignFailed):
                g.result(timeout=0)
            assert type(e).__name__ == "CampaignFailed"
            continue
        gr = g.result(timeout=0)
        assert (gr.steps, gr.rollbacks, gr.resumed_from, gr.preempted) == \
            (wr.steps, wr.rollbacks, wr.resumed_from, wr.preempted)
        np.testing.assert_array_equal(gr.final["temp"],
                                      np.asarray(wr.final["temp"]))
        assert [s for s, _ in gr.snapshots] == [s for s, _ in wr.snapshots]
        for (_, gs), (_, ws) in zip(gr.snapshots, wr.snapshots):
            np.testing.assert_array_equal(gs["temp"],
                                          np.asarray(ws["temp"]))
    assert svc.stats.to_record() == ref.stats.to_record()
    assert same_events(_events(svc), _events(ref))


def test_astaroth_campaign_equals_jax(js, tmp_path):
    """JAX: test_astaroth_campaign — a float64 Astaroth campaign with a
    per-member viscosity: every field finite, within rtol 1e-11 of
    JAX's."""
    r = dict(tenant="t0", model="astaroth", n_steps=2, dtype="float64",
             ckpt_every=1, params={"nu_visc": 6e-3})
    svc = service(tmp_path, width=2)
    h = svc.submit(req(**r))
    svc.drain()
    ref = jax_service(js, tmp_path, width=2)
    hj = ref.submit(req(mod=js, **r))
    ref.drain()
    got, want = h.result(timeout=0), hj.result(timeout=0)
    assert got.steps == want.steps == 2
    assert set(got.final) == {"lnrho", "uux", "uuy", "uuz",
                              "ax", "ay", "az", "ss"}
    for q, v in got.final.items():
        assert np.isfinite(v).all()
        np.testing.assert_allclose(v, np.asarray(want.final[q]),
                                   rtol=1e-11, atol=1e-13, err_msg=q)


# ---------------------------------------------------------------------------
# the service's own contract


def test_concurrent_tenants_complete_with_isolated_namespaces(tmp_path):
    """JAX: test_concurrent_tenants_complete_with_isolated_namespaces."""
    svc = service(tmp_path)
    handles = [svc.submit(req(tenant=f"t{i}", campaign="c",
                              init_seed=50 + i, snapshot_every=2))
               for i in range(3)]
    svc.drain()
    for i, h in enumerate(handles):
        r = h.result(timeout=120)
        assert r.steps == 4 and r.rollbacks == 0
        assert [s for s, _ in r.snapshots] == [2]
        assert not np.isnan(r.final["temp"]).any()
        assert (tmp_path / "root" / f"t{i}" / "c").is_dir()
    assert svc.stats.completed == 3 and svc.stats.failed == 0
    assert svc.stats.batches == 1


def test_warm_path_zero_recompiles_zero_measurements(tmp_path):
    """JAX: test_warm_path_zero_recompiles_zero_measurements — asserted
    from the exported metrics text."""
    svc = service(tmp_path)
    svc.submit(req(tenant="t0"))
    svc.drain()
    text = svc.metrics_text()
    meas = metric_value(text, "stencil_service_tuner_measurements_total")
    assert metric_value(text, "stencil_service_compiles_total") == 1
    assert meas > 0
    h = svc.submit(req(tenant="t1", init_seed=9))
    svc.drain()
    assert h.result(timeout=120).steps == 4
    text = svc.metrics_text()
    parsed = parse_prometheus_text(text)
    assert parsed["stencil_service_recompiles_total"] == {(): 0.0}
    assert metric_value(text, "stencil_service_compiles_total") == 1
    assert metric_value(text,
                        "stencil_service_engine_cache_hits_total") == 1
    assert metric_value(
        text, "stencil_service_tuner_measurements_total") == meas
    assert metric_value(text, "stencil_service_requests_total",
                        tenant="t1") == 1
    batches = [e for e in svc.events if e["event"] == "batch_started"]
    assert batches[-1]["compiled"] is False
    assert batches[-1]["measurements"] == 0


def test_plan_cache_shared_across_services(tmp_path):
    """JAX: test_plan_cache_shared_across_services."""
    svc1 = service(tmp_path)
    svc1.submit(req(tenant="t0"))
    svc1.drain()
    assert metric_value(svc1.metrics_text(),
                        "stencil_service_tuner_measurements_total") > 0
    svc2 = service(tmp_path)
    svc2.submit(req(tenant="t1"))
    svc2.drain()
    text = svc2.metrics_text()
    parsed = parse_prometheus_text(text)
    assert parsed["stencil_service_tuner_measurements_total"] == {(): 0.0}
    assert parsed["stencil_service_recompiles_total"] == {(): 0.0}
    assert metric_value(text, "stencil_service_plan_cache_hits_total") == 1
    assert next(iter(svc2._engines.values())).dd.plan_provenance == \
        "cached"


def test_member_fault_rolls_back_only_affected_campaign(tmp_path):
    """JAX: test_member_fault_rolls_back_only_affected_campaign — the
    untouched batch-mate AND the recovered campaign finish bitwise as
    in a fault-free service."""
    chaos = service(tmp_path / "chaos")
    calm = service(tmp_path / "calm")
    kw = dict(campaign="c", n_steps=6, ckpt_every=2, init_seed=5)
    h0 = chaos.submit(req(tenant="tA", chaos_nan_step=3, **kw))
    h1 = chaos.submit(req(tenant="tB", **kw))
    chaos.drain()
    r0, r1 = h0.result(timeout=120), h1.result(timeout=120)
    assert r0.rollbacks >= 1 and r0.steps == 6
    assert r1.rollbacks == 0 and r1.steps == 6
    g0 = calm.submit(req(tenant="tA", **kw))
    g1 = calm.submit(req(tenant="tB", **kw))
    calm.drain()
    np.testing.assert_array_equal(g1.result().final["temp"],
                                  r1.final["temp"])
    np.testing.assert_array_equal(g0.result().final["temp"],
                                  r0.final["temp"])
    trips = [e for e in chaos.events if e["event"] == "sentinel_tripped"]
    assert trips and all(e["tenant"] == "tA" for e in trips)


def test_retries_exhausted_fails_only_that_campaign(tmp_path):
    """JAX: test_retries_exhausted_fails_only_that_campaign."""
    svc = service(tmp_path)
    h0 = svc.submit(req(tenant="bad", chaos_nan_step=2, ckpt_every=0,
                        max_retries=0))
    h1 = svc.submit(req(tenant="good"))
    svc.drain()
    with pytest.raises(CampaignFailed):
        h0.result(timeout=120)
    assert h1.result(timeout=120).steps == 4
    assert svc.stats.failed == 1 and svc.stats.completed == 1


def test_preempt_then_resume(tmp_path):
    """JAX: test_preempt_then_resume."""
    svc = service(tmp_path)
    h = svc.submit(req(tenant="t0", campaign="long", n_steps=6))
    svc._preempt = True
    svc.drain()
    r = h.result(timeout=120)
    assert r.preempted and r.steps == 0
    svc2 = service(tmp_path)
    h2 = svc2.submit(req(tenant="t0", campaign="long", n_steps=6))
    svc2.drain()
    r2 = h2.result(timeout=120)
    assert not r2.preempted and r2.steps == 6 and r2.resumed_from == 0


def test_completed_campaign_extends_on_resubmit(tmp_path):
    """JAX: test_completed_campaign_extends_on_resubmit — two legs equal
    one uninterrupted run bitwise; a met budget completes at once."""
    svc = service(tmp_path)
    h0 = svc.submit(req(tenant="t0", campaign="c", n_steps=3, init_seed=4))
    svc.drain()
    assert h0.result(timeout=120).steps == 3
    h = svc.submit(req(tenant="t0", campaign="c", n_steps=7, init_seed=4))
    svc.drain()
    r = h.result(timeout=120)
    assert r.resumed_from == 3 and r.steps == 7
    h2 = svc.submit(req(tenant="t0", campaign="c", n_steps=7, init_seed=4))
    svc.drain()
    r2 = h2.result(timeout=120)
    assert r2.steps == 7
    np.testing.assert_array_equal(r2.final["temp"], r.final["temp"])
    one = service(tmp_path / "oneshot")
    g = one.submit(req(tenant="t0", campaign="c", n_steps=7, init_seed=4))
    one.drain()
    np.testing.assert_array_equal(g.result().final["temp"],
                                  r.final["temp"])


def test_background_worker_serves(tmp_path):
    """JAX: test_background_worker_serves — the worker thread serves
    while the caller submits, and equals a drained service bitwise."""
    svc = service(tmp_path)
    svc.start()
    try:
        h = svc.submit(req(tenant="t0", init_seed=2))
        r = h.result(timeout=120)
        assert r.steps == 4
        assert svc._thread is not None and \
            svc._thread is not threading.current_thread()
    finally:
        svc.stop()
    ref = service(tmp_path / "drained")
    g = ref.submit(req(tenant="t0", init_seed=2))
    ref.drain()
    np.testing.assert_array_equal(g.result().final["temp"],
                                  r.final["temp"])


def test_namespace_rejects_traversal(tmp_path):
    """JAX: test_namespace_rejects_traversal."""
    svc = service(tmp_path)
    with pytest.raises(ValueError):
        svc.namespace("../escape", "c")
    with pytest.raises(ValueError):
        svc.namespace("t", "a/b")


def test_service_refuses_devices_over_ranks(tmp_path):
    """The service has one controller: a device list naming another
    rank's device raises at construction."""
    from stencil_tpu_torch.parallel.mesh import GlobalDevice

    devs = [GlobalDevice(r, "host0", torch.device("cpu")) for r in (0, 1)]
    with pytest.raises(NotImplementedError, match="one controller"):
        CampaignService(str(tmp_path / "r"), devices=devs)


def test_service_without_devices_wants_a_card(tmp_path):
    """No fallback hides the device: ``devices=None`` means the card(s);
    with none here, construction raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(Exception):
        CampaignService(str(tmp_path / "r"))


# ---------------------------------------------------------------------------
# the serve app against JAX's


def test_serve_app_prints_jax_lines(js, tmp_path, capsys):
    """``python -m stencil_tpu_torch.apps.serve`` takes JAX's flags and
    prints JAX's lines, with the same values: campaigns, rollbacks,
    snapshot steps, the warm path and the stats."""
    from stencil_tpu_torch.apps import serve

    argv = ["--tenants", "3", "--steps", "6", "--chaos-nan", "3",
            "--fake-timer"]
    assert serve.main(argv + ["--devices", ",".join(CPU8),
                              "--tune-cache", str(tmp_path / "p.json"),
                              "--events-json", str(tmp_path / "e.json")]
                      ) == 0
    got = capsys.readouterr().out
    want = run_jax_app("serve", argv + ["--tune-cache",
                                         str(tmp_path / "j.json")])
    assert got.splitlines() == want.splitlines()
    assert "stats: batches=2 compiles=1" in got
    assert (tmp_path / "e.json").is_file()
