"""The port's ``/metrics`` server (``stencil_tpu_torch/telemetry/
http.py``) and telemetry CLI (``python -m stencil_tpu_torch.telemetry``)
against the JAX package's ``stencil_tpu/telemetry/http.py`` and
``__main__.py``: the same bodies on every endpoint for registries built
alike, the same verdicts and output of each subcommand on the same
files."""

import json
import urllib.error
import urllib.request

import pytest

from stencil_tpu_torch.telemetry import (EventLog, ListSink, MetricsRegistry,
                                         MetricsServer, Tracer)
from stencil_tpu_torch.telemetry.__main__ import main as pmain


@pytest.fixture(scope="module")
def jtel():
    import stencil_tpu.telemetry as jax_telemetry

    return jax_telemetry


def _fill(reg):
    c = reg.counter("stencil_run_steps_total", "steps advanced")
    c.inc(7)
    g = reg.gauge("stencil_perf_model_error_ratio", "ratio")
    g.set(1.25, entry="jacobi", method="PallasDMA", s="1")
    h = reg.histogram("stencil_latency_s", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 2.0):
        h.observe(v, path="a\"b")
    return reg


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read()


def test_endpoints_equal_jax(jtel):
    with MetricsServer(_fill(MetricsRegistry()), port=0) as ps, \
            jtel.MetricsServer(_fill(jtel.MetricsRegistry()),
                               port=0) as js:
        assert ps.port and ps.port != js.port
        for path in ("/metrics", "/healthz", "/metrics?x=1"):
            assert _get(ps.port, path) == _get(js.port, path)
        got = json.loads(_get(ps.port, "/metrics.json")[2])
        want = json.loads(_get(js.port, "/metrics.json")[2])
        got.pop("time"), want.pop("time")
        assert got == want
        for srv in (ps, js):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(srv.port, "/nope")
            assert e.value.code == 404


def test_server_start_stop_contract():
    srv = MetricsServer(MetricsRegistry(), port=0)
    port = srv.start()
    assert port == srv.port > 0
    with pytest.raises(RuntimeError):
        srv.start()
    srv.stop()
    srv.stop()  # idempotent
    with pytest.raises(urllib.error.URLError):
        _get(port, "/healthz")


def _artifacts(tmp_path):
    snap = tmp_path / "m.json"
    _fill(MetricsRegistry()).write_snapshot(str(snap))
    tracer = Tracer(run_id="r1")
    with tracer.span("campaign"):
        with tracer.span("segment.dispatch", k=4):
            pass
    trace = tmp_path / "t.json"
    tracer.export_chrome_trace(str(trace))
    records = []
    log = EventLog(run_id="r1", sinks=(ListSink(records),))
    log.emit("checkpoint", step=0)
    log.emit("perf_drift", step=8, ratio=2.0)
    events = tmp_path / "e.json"
    events.write_text(json.dumps({"events": records}))
    jsonl = tmp_path / "e.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in records))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"event": "x"}]))
    return snap, trace, events, jsonl, bad


def test_cli_equals_jax(jtel, tmp_path, capsys):
    from stencil_tpu.telemetry.__main__ import main as jmain

    snap, trace, events, jsonl, bad = _artifacts(tmp_path)
    cases = [["snapshot", str(snap)], ["snapshot", str(snap), "--json"],
             ["validate-trace", str(trace)],
             ["validate-events", str(events)],
             ["validate-events", str(jsonl)],
             ["validate-events", str(bad)],
             ["validate-events", str(tmp_path / "missing.json")]]
    for argv in cases:
        rc_p = pmain(argv)
        out_p = capsys.readouterr()
        rc_j = jmain(argv)
        out_j = capsys.readouterr()
        assert rc_p == rc_j, argv
        assert out_p.out == out_j.out, argv
    assert pmain(["validate-events", str(events)]) == 0
    assert "OK (2 records, 1 run(s))" in capsys.readouterr().out
    assert pmain(["validate-events", str(bad)]) == 1
    snap.write_text(json.dumps({"schema": 99}))
    assert pmain(["snapshot", str(snap)]) == 1
