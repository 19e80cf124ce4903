"""The port's telemetry copies (``stencil_tpu_torch/telemetry``: the
event log, spans and the metrics registry) against the JAX package's
``stencil_tpu/telemetry``.

The behaviour JAX's ``tests/test_telemetry.py`` pins for these classes
is asserted on both packages (each test takes the package as a
parameter), and the same calls are held to give the same output: the
Prometheus text byte for byte, the JSON snapshot but for its time, the
event records but for run ids and times, the Chrome trace's events but
for times. The port's span is also a ``torch.profiler`` range, and the
resilience driver's report events are span-correlated with its tracer.
"""

import json
import threading

import pytest
import torch

import stencil_tpu.telemetry as jtel
import stencil_tpu_torch.telemetry as ptel

PKGS = {"jax": jtel, "port": ptel}


@pytest.fixture(params=list(PKGS))
def tel(request):
    return PKGS[request.param]


def test_event_log_stamps_schema_run_and_monotonic_seq(tel):
    got = []
    log = tel.EventLog(sinks=(tel.ListSink(got),), clock=lambda: 123.0)
    log.emit("a", step=1)
    log.emit("b", span="r/0", nested={"k": "v"})
    assert [e["seq"] for e in got] == [0, 1]
    assert got[0] == {"event": "a", "time": 123.0, "run": log.run_id,
                      "seq": 0, "schema": tel.EVENT_SCHEMA_VERSION,
                      "step": 1}
    assert got[1]["span"] == "r/0"
    assert tel.validate_events(got) == []
    for key in ("run", "seq", "time", "schema", "event"):
        with pytest.raises(ValueError, match="schema keys"):
            log.emit("tick", **{key: "boom"})
    assert log.emit("tick")["seq"] == 2


def test_validate_events_flags_bad_records(tel):
    assert tel.validate_events([{"event": "x"}])
    ok = {"event": "x", "time": 1.0, "run": "r", "seq": 1, "schema": 1}
    assert tel.validate_events([ok]) == []
    problems = tel.validate_events([ok, dict(ok)])
    assert problems and "not increasing" in problems[0]
    f1, f2, f3 = (dict(ok, seq=1.0), dict(ok, seq=3.0), dict(ok, seq=2.0))
    assert tel.validate_events([f1, f2]) == []
    assert "not increasing" in tel.validate_events([f1, f2, f3])[0]


def test_sinks_ring_jsonl_and_a_failing_one(tel, tmp_path):
    class Boom:
        def emit(self, record):
            raise OSError("disk full")

        def close(self):
            pass

    ring = tel.RingSink(capacity=3)
    path = tmp_path / "events.jsonl"
    jsonl = tel.JsonlSink(str(path))
    log = tel.EventLog(sinks=(Boom(), ring, jsonl))
    for i in range(10):
        log.emit("tick", i=i)
    jsonl.close()
    assert [r["i"] for r in ring.records()] == [7, 8, 9]
    assert ring.dropped == 7
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [r["i"] for r in lines] == list(range(10))
    assert tel.validate_events(lines) == []


def _metrics(tel):
    reg = tel.MetricsRegistry()
    c = reg.counter("req_total", "requests")
    c.inc(tenant="a")
    c.inc(2, tenant="b")
    for t in ('acme"corp', "acme,corp", "a\\b", "two\nlines"):
        c.inc(tenant=t)
    g = reg.gauge("depth")
    g.set(5)
    g.dec(2)
    h = reg.histogram("lat_seconds", buckets=(0.1, 1.0))
    h.observe(0.05, op="admit")
    h.observe(3.0, op="admit")
    reg.counter("seeded_total", "seeded").inc(0)
    reg.counter("esc_total", "two\nlines \\ slash").inc()
    return reg


def test_registry_exposition_and_parse(tel):
    reg = _metrics(tel)
    with pytest.raises(ValueError):
        reg.counter("req_total").inc(-1)
    text = reg.to_prometheus_text()
    assert "# TYPE req_total counter" in text
    assert tel.metric_value(text, "req_total", tenant="b") == 2
    assert tel.metric_value(text, "req_total", tenant='acme"corp') == 1
    assert tel.metric_value(text, "depth") == 3
    parsed = tel.parse_prometheus_text(text)
    assert tel.metric_value(parsed, "lat_seconds_bucket", op="admit",
                            le="0.1") == 1
    assert tel.metric_value(parsed, "lat_seconds_count", op="admit") == 2
    assert "seeded_total 0" in text
    assert r"# HELP esc_total two\nlines \\ slash" in text
    snap = reg.snapshot()
    assert snap["schema"] == 1
    assert tel.render_snapshot_text(snap) == text
    assert tel.snapshot_value(snap, "req_total", tenant="a") == 1
    assert reg.counter("req_total") is reg.counter("req_total")
    with pytest.raises(ValueError):
        reg.gauge("req_total")
    with pytest.raises(ValueError, match="buckets"):
        reg.histogram("lat_seconds", buckets=(0.5,))
    with pytest.raises(TypeError, match="count"):
        reg.histogram("lat_seconds").value()


def test_registry_output_equals_jax():
    jt, pt = (_metrics(jtel).to_prometheus_text(),
              _metrics(ptel).to_prometheus_text())
    assert pt == jt
    js, ps = _metrics(jtel).snapshot(), _metrics(ptel).snapshot()
    js.pop("time"), ps.pop("time")
    assert ps == js


def _trace(tel):
    t = tel.Tracer(run_id="testrun")
    with t.span("campaign", tenant="a"):
        with t.span("segment", steps=4):
            pass
        with t.span("checkpoint"):
            pass
    return t


def test_tracer_span_tree_and_chrome_export(tel, tmp_path):
    t = _trace(tel)
    by_name = {s.name: s for s in t.finished()}
    assert by_name["segment"].parent_id == by_name["campaign"].span_id
    assert by_name["campaign"].parent_id is None
    assert by_name["segment"].attrs == {"steps": 4}
    path = tmp_path / "trace.json"
    t.export_chrome_trace(str(path))
    assert tel.validate_chrome_trace(str(path)) == []
    for key in ("span_id", "parent_id"):
        with pytest.raises(ValueError, match="identity keys"):
            with t.span("seg", **{key: "forged"}):
                pass
    small = tel.Tracer(capacity=3)
    for i in range(5):
        with small.span(f"s{i}"):
            pass
    assert [s.name for s in small.finished()] == ["s2", "s3", "s4"]
    assert small.dropped == 2
    seen = {}

    def worker():
        with t.span("worker-root") as sp:
            seen["parent"] = sp.parent_id

    with t.span("main-root"):
        th = threading.Thread(target=worker)
        th.start()
        th.join()
    assert seen["parent"] is None
    assert tel.validate_chrome_trace({"nope": 1})


def test_chrome_trace_equals_jax_but_for_times():
    def strip(payload):
        return [{k: v for k, v in e.items()
                 if k not in ("ts", "dur", "pid", "tid", "cat")}
                for e in payload["traceEvents"]]

    assert strip(_trace(ptel).chrome_trace()) == \
        strip(_trace(jtel).chrome_trace())


def test_span_is_a_profiler_range():
    t = ptel.Tracer()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.span("resilience.test_span"):
            torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert "resilience.test_span" in names


def test_resilience_report_events_are_span_correlated(tmp_path):
    from stencil_tpu_torch.models.jacobi import Jacobi3D
    from stencil_tpu_torch.resilience import ResiliencePolicy
    from stencil_tpu_torch.resilience.driver import run_resilient

    j = Jacobi3D(8, 8, 8, devices=["cpu"] * 2, kernel="xla")
    j.init()
    rep = run_resilient(j.dd, j.step, 3,
                        policy=ResiliencePolicy(check_every=1,
                                                ckpt_every=2,
                                                sleep=lambda s: None),
                        ckpt_dir=str(tmp_path / "ckpt"))
    assert rep.run_id and rep.events
    assert ptel.validate_events(rep.events) == []
    assert all(e["run"] == rep.run_id for e in rep.events)
    spans = [e["span"] for e in rep.events if "span" in e]
    assert spans
    assert set(spans) <= {s.span_id for s in ptel.get_tracer().finished()}
    rec = rep.to_record()
    assert rec["run_id"] == rep.run_id
    out = tmp_path / "report.json"
    rep.write(str(out))
    assert json.loads(out.read_text())["steps"] == 3


def test_new_run_id_and_default_registry():
    assert len(ptel.new_run_id()) == 12
    assert ptel.get_registry() is ptel.get_registry()
    prev = ptel.set_tracer(ptel.Tracer(run_id="x"))
    assert ptel.get_tracer().run_id == "x"
    ptel.set_tracer(prev)
