"""The port's performance observatory (``stencil_tpu_torch/
observatory``: attribution, ledger, recorder and its CLI) against the
JAX package's ``stencil_tpu/observatory``.

* ``PerfAttributor`` under an injected clock: the same ``perf_drift``
  events and the same gauges as JAX's for the same observations;
  ``model_step_seconds_for`` on domains carrying the same plan
  coefficients equal to JAX's (the defaults differ: H100 against TPU).
* The ledger: records, validation, gate and diff equal on synthetic
  payloads of every shape ``payload_records`` converts.
* The flight recorder: a port dump passes JAX's own ``validate_dump``
  and renders JAX's ``render_timeline`` text.
"""

import json

import numpy as np
import pytest
import torch

from stencil_tpu_torch.observatory import attribution as pa
from stencil_tpu_torch.observatory import ledger as pl
from stencil_tpu_torch.observatory import recorder as pr
from stencil_tpu_torch.telemetry import MetricsRegistry
from torch_port_support import reference_modules


@pytest.fixture(scope="module")
def jo():
    with reference_modules():
        import stencil_tpu.observatory as jax_observatory

        yield jax_observatory


class Clock:
    """Seconds that advance by the given steps, one a call."""

    def __init__(self, steps):
        self.steps = list(steps)
        self.t = 0.0

    def __call__(self):
        self.t += self.steps.pop(0) if self.steps else 1.0
        return self.t


def _observe_both(jo, durations, **kw):
    from stencil_tpu.telemetry import MetricsRegistry as JRegistry

    out = []
    for mod, reg in ((pa, MetricsRegistry()), (jo.attribution,
                                               JRegistry())):
        events = []
        att = mod.PerfAttributor(
            entry="jacobi", method="PpermuteSlab", exchange_every=2,
            model_step_seconds=1e-3, model_bytes_per_step=1e6,
            emit=lambda kind, **a: events.append((kind, a)),
            registry=reg, fingerprint="f" * 32,
            link_bytes_per_step={("y", "ici-hop1"): 5e5,
                                 ("z", "ici-hop1"): 5e5},
            link_peak_bytes_per_s={"y": 1e9},
            clock=Clock([x for d in durations for x in (0.0, d)]), **kw)
        fired = []
        for i, _ in enumerate(durations):
            with att.dispatch(4, lambda: None, step=4 * (i + 1)):
                pass
            fired.append(att.last_ratio)
        out.append((events, fired, reg.to_prometheus_text(), att))
    return out


@pytest.mark.parametrize("durations,kw", [
    ([4e-3] * 3 + [12e-3] * 4, {}),
    ([4e-3, 4e-3, 9e-3, 4e-3, 9e-3, 9e-3, 9e-3, 9e-3], {"window": 2}),
    ([1.0, 4e-3, 4e-3, 12e-3, 12e-3, 12e-3], {"warmup": 1}),
    ([4e-3] * 6, {"tolerance": 0.1}),
])
def test_attributor_drift_equals_jax(jo, durations, kw):
    (pe, pf, ptext, patt), (je, jf, jtext, _) = _observe_both(
        jo, durations, **kw)
    assert pe == je and pf == jf
    # the same gauges, names, labels and values (the help texts differ)
    from stencil_tpu_torch.telemetry import parse_prometheus_text

    assert parse_prometheus_text(ptext) == parse_prometheus_text(jtext)
    patt.reset(model_step_seconds=2e-3)
    assert patt.last_ratio is None and patt.model_step_seconds == 2e-3


def test_attributor_disabled_and_validation(jo):
    att = pa.PerfAttributor("x", registry=MetricsRegistry())
    assert not att.enabled and att.observe(1, 1.0) is None
    with att.dispatch(1, lambda: 1 / 0):
        pass  # a disabled attributor never fences
    for bad in (dict(tolerance=0), dict(window=0)):
        with pytest.raises(ValueError):
            pa.PerfAttributor("x", registry=MetricsRegistry(), **bad)


def test_drift_invalidator_drops_the_plan(tmp_path):
    from stencil_tpu_torch import tuning

    path = tmp_path / "plans.json"
    tuning.store_plan(tuning.Plan(tuning.Candidate("PallasDMA"), "a" * 32,
                                  {}, {}), path)
    log = []
    hook = pa.make_drift_invalidator(path, lambda k, **a: log.append((k, a)))
    hook({"ratio": 2.0})
    assert log == []
    hook({"fingerprint": "a" * 32})
    assert log == [("plan_invalidated", {"fingerprint": "a" * 32,
                                         "removed": True})]
    assert tuning.load_plan("a" * 32, path) is None


def test_model_step_seconds_equals_jax(jo):
    """The same configuration with the same plan coefficients prices
    the same in both packages; one shard prices nothing."""
    import jax

    from stencil_tpu.distributed import DistributedDomain as JDomain
    from stencil_tpu.tuning.plan import Candidate as JCand, Plan as JPlan
    from stencil_tpu_torch.distributed import DistributedDomain
    from stencil_tpu_torch.tuning import Plan

    for method, s, mesh in (("PpermuteSlab", 1, (2, 2, 2)),
                            ("PpermutePacked", 2, (1, 2, 4)),
                            ("AllGather", 1, (2, 2, 2))):
        jplan = JPlan(config=JCand(method, s), fingerprint="c" * 32,
                      coefficients={"ici": {"alpha_s": 3e-6,
                                            "beta_bytes_per_s": 2e10},
                                    "dcn": {"alpha_s": 3e-5,
                                            "beta_bytes_per_s": 1e9}},
                      costs={})
        jd = JDomain(16, 16, 32, devices=jax.devices()[:8])
        pd = DistributedDomain(16, 16, 32, devices=["cpu"] * 8)
        for d in (jd, pd):
            d.set_mesh_shape(mesh)
            d.set_radius(1)
            for q, dt in (("a", np.float32), ("b", np.float64)):
                d.add_data(q, dt if d is jd else torch_dtype(dt))
        jd.apply_plan(jplan)
        pd.apply_plan(Plan.from_record(jplan.to_record()))
        jd.realize()
        pd.realize()
        got = pa.model_step_seconds_for(pd)
        assert got == pytest.approx(
            jo.attribution.model_step_seconds_for(jd), rel=1e-12)
    one = DistributedDomain(8, 8, 8, devices=["cpu"])
    one.set_radius(1)
    one.add_data("a", torch.float32)
    one.realize()
    assert pa.model_step_seconds_for(one) is None
    assert pa.model_step_seconds_for(object()) is None


def torch_dtype(dt):
    return {np.float32: torch.float32, np.float64: torch.float64}[dt]


# ---------------------------------------------------------------------------
# the ledger

PAYLOADS = [
    {"bench": "bench_exchange", "mesh": [2, 2, 1],
     "per_device_size": [8, 8, 8], "radius": [2, 2, 2], "fields": 1,
     "configs": [{"exchange_every": 1, "steps_per_s": 100.0,
                  "seconds": 0.3, "trimean_exchange_s": 1e-4,
                  "exchange_rounds_per_step": 1.0,
                  "amortized_bytes_per_step_model": 65536.0},
                 {"exchange_every": "1.1.2", "depths": [1, 1, 2],
                  "steps_per_s": 120.0}],
     "fused": {"check_every": 8, "fused_steps_per_s": 300.0,
               "stepwise_steps_per_s": 150.0, "fused_over_stepwise": 2.0,
               "pic": {"fused_steps_per_s": 50.0,
                       "stepwise_steps_per_s": 40.0,
                       "fused_over_stepwise": 1.25},
               "astaroth_temporal": {"exchange_every": 2,
                                     "fused_steps_per_s": 2.0,
                                     "stepwise_steps_per_s": 1.0,
                                     "fused_over_stepwise": 2.0}},
     "autotune": {"plan": {"config": {"method": "PallasDMA"},
                           "fingerprint": "d" * 32},
                  "tuned_steps_per_s": 90.0, "default_steps_per_s": 80.0,
                  "tuned_over_default": 1.125}},
    {"bench": "pic", "config": {"grid": [16, 16, 16]},
     "seconds_per_step": 0.25, "particle_steps_per_s": 1e6,
     "migration_bytes_per_shard": 1024, "overflow": 0,
     "fused": {"check_every": 4, "fused_steps_per_s": 8.0}},
    {"bench": "pic", "config": {}, "seconds_per_step": 0},
    {"parsed": {"value": 12.5, "unit": "steps/s", "metric": "jacobi",
                "extra": {"devices": 1, "mesh": [1, 1, 1], "junk": 3}}},
    {"parsed": {"value": 0, "suspect": True}},
    {"parsed": None, "rc": 1},
    {"bench": "jacobi3d", "config": {"grid": [8, 8, 8]},
     "metrics": {"steps_per_s": 10.0}, "fingerprint": "e" * 32},
]


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_payload_records_equal_jax(jo, i):
    got = pl.payload_records(PAYLOADS[i], "src.json", "measured", 7.0)
    want = jo.ledger.payload_records(PAYLOADS[i], "src.json", "measured",
                                     7.0)
    assert got == want


def test_ledger_validation_gate_and_diff(jo, tmp_path):
    jl = jo.ledger
    path = tmp_path / "ledger.jsonl"
    recs = []
    for i, sps in enumerate((100.0, 110.0, 70.0)):
        rec = pl.make_record("bench_x", {"n": 1}, {"steps_per_s": sps,
                                                   "extra": i},
                             created=float(i), source="t")
        assert rec == jl.make_record("bench_x", {"n": 1},
                                     {"steps_per_s": sps, "extra": i},
                                     created=float(i), source="t")
        pl.append_record(path, rec)
        recs.append(rec)
    pl.append_record(path, pl.make_record("other", {}, {"steps_per_s": 1.0},
                                          provenance="legacy", created=9.0))
    read = pl.read_ledger(path)
    assert read == jl.read_ledger(path) and len(read) == 4
    for th in (0.2, 0.4):
        for prov in (("measured",), pl.PROVENANCES):
            for bench in (None, "bench_*", "other"):
                assert pl.gate_regressions(read, th, prov, bench) == \
                    jl.gate_regressions(read, th, prov, bench)
                assert pl.gate_groups_checked(read, prov, bench) == \
                    jl.gate_groups_checked(read, prov, bench)
    assert pl.diff_records(recs[0], recs[2]) == \
        jl.diff_records(recs[0], recs[2])
    bad = [{}, {"schema": 2}, dict(recs[0], metrics={"steps_per_s": -1}),
           dict(recs[0], provenance="guess"), "x"]
    for b in bad:
        assert pl.validate_record(b) == jl.validate_record(b)
        assert pl.validate_record(b)
    with pytest.raises(ValueError):
        pl.make_record("b", {}, {"steps_per_s": 0})
    with pytest.raises(ValueError):
        pl.append_record(path, {"schema": 1})
    path.write_text(path.read_text() + "{torn\n")
    with pytest.raises(ValueError, match="unparseable"):
        pl.read_ledger(path)
    assert pl.config_fingerprint("b", {"k": 1}) == \
        jl.config_fingerprint("b", {"k": 1})


def test_default_ledger_path_is_outside_the_checkout(monkeypatch, tmp_path):
    from stencil_tpu_torch.apps._common import resolve_ledger_path

    class Args:
        ledger = None

    monkeypatch.delenv("STENCIL_BENCH_LEDGER", raising=False)
    path = resolve_ledger_path(Args())
    assert path.endswith("stencil_tpu_torch/ledger.jsonl")
    assert "bench/" not in path
    monkeypatch.setenv("STENCIL_BENCH_LEDGER", "")
    assert resolve_ledger_path(Args()) is None
    monkeypatch.setenv("STENCIL_BENCH_LEDGER", str(tmp_path / "l.jsonl"))
    assert resolve_ledger_path(Args()) == str(tmp_path / "l.jsonl")
    Args.ledger = ""
    assert resolve_ledger_path(Args()) is None


# ---------------------------------------------------------------------------
# the flight recorder


def _dump(tmp_path):
    from stencil_tpu_torch.telemetry import EventLog, Tracer

    clock = Clock([0.5] * 50)
    tracer = Tracer()
    reg = MetricsRegistry()
    reg.counter("stencil_run_steps_total", "steps").inc(4)
    rec = pr.FlightRecorder(run_id="run1", registry=reg, tracer=tracer,
                            clock=clock, events_capacity=4)
    log = EventLog(run_id="run1", sinks=(rec,), clock=clock)
    with tracer.span("megastep", steps=2, step=0):
        log.emit("checkpoint", step=0)
    for i in range(5):
        log.emit("fault_nan", step=i, quantity="temp")
    rec.record_probe({"step": 3, "tripped": True, "reason": "nan"})
    rec.record_probe({"step": 4, "tripped": False})
    rec.set_linkmap({"links": {"y/ici-hop1": {"bytes": 8, "share": 1.0}}})
    return rec.dump(tmp_path / "flight", "sentinel_trip", trip_step=3,
                    path=tmp_path)


def test_port_dump_passes_jax_validation_and_renders_alike(jo, tmp_path):
    path = _dump(tmp_path)
    assert jo.recorder.validate_dump(path) == []
    assert pr.validate_dump(path) == []
    text = pr.render_timeline(path)
    assert text == jo.recorder.render_timeline(path)
    payload = json.loads(open(path).read())
    assert payload["dropped_events"] == 2 and len(payload["events"]) == 4
    assert "4 events, 2 probes, 1 spans, 2 events aged out" in text
    for broken in ({}, dict(payload, schema=3),
                   dict(payload, events="x"),
                   dict(payload, spans=[{"name": 1}]),
                   dict(payload, metrics={"x": 1}),
                   dict(payload, linkmap={"y": 1})):
        assert pr.validate_dump(broken) == \
            jo.recorder.validate_dump(broken)
        assert pr.validate_dump(broken)
    assert pr.validate_dump(tmp_path / "none.json")[0].startswith(
        "cannot load dump")


def test_safe_dump_never_masks_the_incident(tmp_path):
    assert pr.safe_dump(None, tmp_path, "x") is None
    rec = pr.FlightRecorder(run_id="r")
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert pr.safe_dump(rec, blocker / "sub", "x") is None
    assert pr.safe_dump(rec, tmp_path / "ok", "x y/z").endswith(
        "_000_x_y_z.json")


def test_observatory_cli(tmp_path, capsys):
    from stencil_tpu_torch.observatory.__main__ import main

    led = tmp_path / "l.jsonl"
    for sps, t in ((100.0, 1.0), (50.0, 2.0)):
        pl.append_record(led, pl.make_record("b", {}, {"steps_per_s": sps},
                                             created=t))
    assert main(["validate", str(led)]) == 0
    assert main(["gate", str(led)]) == 1
    assert main(["gate", str(led), "--threshold", "0.6", "--json",
                 str(tmp_path / "g.json")]) == 0
    assert json.loads((tmp_path / "g.json").read_text())[
        "groups_checked"] == 1
    assert main(["gate", str(led), "--threshold", "0.6",
                 "--min-groups", "2"]) == 1
    assert main(["gate", str(tmp_path / "missing.jsonl")]) == 2
    assert main(["diff", str(led)]) == 0
    assert "x0.500" in capsys.readouterr().out
    src = tmp_path / "p.json"
    src.write_text(json.dumps(PAYLOADS[1]))
    assert main(["backfill", "--out", str(tmp_path / "bf.jsonl"),
                 str(src)]) == 0
    assert pl.read_ledger(tmp_path / "bf.jsonl")[0]["provenance"] == \
        "legacy"
    dump = _dump(tmp_path)
    capsys.readouterr()
    assert main(["validate", dump]) == 0
    assert main(["replay", dump]) == 0
    assert "fault_nan" in capsys.readouterr().out
    (tmp_path / "bad.json").write_text(json.dumps({"kind":
                                                   "flight_recorder"}))
    assert main(["replay", str(tmp_path / "bad.json")]) == 1


def test_glob_match_equals_jax(jo):
    from stencil_tpu.utils.naming import glob_match as jglob
    from stencil_tpu_torch.utils.naming import glob_match

    names = ["bench_exchange", "bench_exchange.megastep",
             "models.jacobi.step_n[xla-temporal[s=1.1.4]]",
             "PpermuteSlab[s=2]", "analysis.tiling.jacobi_halo[512]"]
    pats = ["bench_exchange*", "*[s=2]", "*?512?", "bench_exchange",
            "models.*[s=1.1.4]]", "x*", "*"]
    for n in names:
        for p in pats:
            assert glob_match(n, p) == jglob(n, p), (n, p)


def test_observatory_cli_prints_jax_output(jo, tmp_path, capsys):
    """The port's CLI and JAX's print the same lines and exit codes on
    the same ledger and dump."""
    from stencil_tpu.observatory.__main__ import main as jmain
    from stencil_tpu_torch.observatory.__main__ import main as pmain

    led = tmp_path / "l.jsonl"
    for i, sps in enumerate((100.0, 120.0, 60.0, 90.0)):
        pl.append_record(led, pl.make_record(
            "bench_exchange" if i % 2 else "pic", {"k": i % 2},
            {"steps_per_s": sps, "extra": i}, created=float(i)))
    dump = _dump(tmp_path)
    cases = [["validate", str(led)], ["validate", dump],
             ["gate", str(led)], ["gate", str(led), "--threshold", "0.5"],
             ["gate", str(led), "--bench", "bench_*"],
             ["diff", str(led)], ["diff", str(led), str(led)],
             ["replay", dump],
             ["linkmap", "--mesh", "2,2,2", "--fields", "2"],
             ["linkmap", "--mesh", "1,2,4", "--dcn-axis", "z",
              "--n-slices", "2", "--exchange-every", "2"]]
    for argv in cases:
        rc_p = pmain(argv)
        out_p = capsys.readouterr().out
        rc_j = jmain(argv)
        out_j = capsys.readouterr().out
        assert (rc_p, out_p) == (rc_j, out_j), argv
