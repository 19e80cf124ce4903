"""The flight recorder: a bounded black box for post-mortem capture.

PyTorch-port counterpart of ``stencil_tpu/observatory/recorder.py``.
When a campaign trips, degrades, is preempted or dies on an unhandled
error, the question is what was happening just before. The
:class:`FlightRecorder` holds the recent past — events (a bounded
``telemetry.RingSink``), the span tail, a metrics snapshot, the
health-probe history and the classified link map — and dumps it
atomically (a temporary file renamed into place, one file per incident)
when the resilience driver hits a trigger:

* a health-sentinel trip (after the rollback, so the dump shows both),
* a configuration degradation,
* SIGTERM preemption (before the preemption checkpoint),
* an unhandled error.

``python -m stencil_tpu_torch.observatory replay <dump>`` renders the
merged incident timeline and ``validate`` checks the dump's schema,
which is JAX's: a dump of either package passes the other's
``validate_dump``. Triggers arm with
``ResiliencePolicy.flight_recorder_dir`` or
``$STENCIL_FLIGHT_RECORDER_DIR``.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional, Union

#: bump when a dump key changes meaning; the validator keys on this
FLIGHT_SCHEMA_VERSION = 1

#: arms the recorder in the driver/service when no explicit dir is set
ENV_FLIGHT_DIR = "STENCIL_FLIGHT_RECORDER_DIR"


def _jsonable(v):
    return v if isinstance(v, (str, int, float, bool)) or v is None \
        else str(v)


class FlightRecorder:
    """Bounded in-memory black box with atomic incident dumps.

    Speaks the telemetry sink protocol (``emit``/``close``), so it
    plugs straight into an :class:`~stencil_tpu_torch.telemetry.EventLog`
    via ``add_sink`` — every versioned event record the run emits also
    lands in the recorder's ring. ``record_probe`` keeps the recent
    health/probe verdicts (:meth:`HealthStats.to_record` dicts, wall
    time stamped on arrival); ``registry``/``tracer`` are snapshotted
    lazily at dump time, never polled."""

    def __init__(self, run_id: Optional[str] = None,
                 events_capacity: int = 1024,
                 probes_capacity: int = 256, spans_tail: int = 256,
                 registry=None, tracer=None,
                 clock=time.time) -> None:
        from ..telemetry import RingSink, new_run_id
        self.run_id = run_id or new_run_id()
        self._ring = RingSink(events_capacity)
        self._probes: deque = deque(maxlen=int(probes_capacity))
        self._spans_tail = int(spans_tail)
        self._registry = registry
        self._tracer = tracer
        self._clock = clock
        self._lock = threading.Lock()
        self._n_dumps = 0
        self._linkmap: Optional[Dict] = None

    # -- the telemetry sink protocol ------------------------------------
    def emit(self, record: Dict) -> None:
        self._ring.emit(record)

    def close(self) -> None:
        pass

    # -- history feeds --------------------------------------------------
    def record_probe(self, record: Dict) -> None:
        rec = dict(record)
        rec.setdefault("recorded", float(self._clock()))
        with self._lock:
            self._probes.append(rec)

    def set_linkmap(self, summary: Optional[Dict]) -> None:
        """Attach the link observatory's classified traffic snapshot
        (``linkmap.LinkmapSummary.to_record()``): incident dumps then
        show per-(axis, link_class) modeled wire shares next to the
        events — which fabric tier the dying campaign was leaning
        on."""
        with self._lock:
            self._linkmap = dict(summary) if summary else None

    # -- capture --------------------------------------------------------
    def snapshot(self, reason: str, **attrs) -> Dict:
        """The black-box payload: everything the recorder holds, as of
        now."""
        spans: List[Dict] = []
        if self._tracer is not None:
            epoch = float(getattr(self._tracer, "epoch_unix", 0.0))
            for sp in self._tracer.finished()[-self._spans_tail:]:
                spans.append({
                    "name": sp.name, "span_id": sp.span_id,
                    "parent_id": sp.parent_id,
                    "start": epoch + sp.start_s,
                    "end": (epoch + sp.end_s
                            if sp.end_s is not None else None),
                    "attrs": {k: _jsonable(v)
                              for k, v in sp.attrs.items()},
                })
        with self._lock:
            probes = [dict(p) for p in self._probes]
            linkmap = dict(self._linkmap) if self._linkmap else None
        return {
            "schema": FLIGHT_SCHEMA_VERSION,
            "kind": "flight_recorder",
            "run": self.run_id,
            "time": float(self._clock()),
            "reason": str(reason),
            "attrs": {k: _jsonable(v) for k, v in attrs.items()},
            "events": self._ring.records(),
            "dropped_events": self._ring.dropped,
            "probes": probes,
            "spans": spans,
            "metrics": (self._registry.snapshot()
                        if self._registry is not None else None),
            "linkmap": linkmap,
        }

    def dump(self, directory: Union[str, Path], reason: str,
             **attrs) -> str:
        """Atomically write one incident dump into ``directory``
        (created if needed); returns the dump path. The tmp + rename
        publish means a reader never sees a torn black box — the same
        contract as checkpoint meta and the plan cache."""
        payload = self.snapshot(reason, **attrs)
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        with self._lock:
            n = self._n_dumps
            self._n_dumps += 1
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in str(reason))[:48]
        path = d / f"flight_{self.run_id}_{n:03d}_{safe}.json"
        fd, tmp = tempfile.mkstemp(dir=str(d), prefix=path.name,
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return str(path)


def safe_dump(recorder: Optional[FlightRecorder],
              directory: Optional[Union[str, Path]], reason: str,
              **attrs) -> Optional[str]:
    """Best-effort incident dump, shared by the driver and the
    service: a disarmed recorder is a no-op, and a FAILING dump warns
    and returns None — the black box must never mask the incident it
    records. Returns the dump path on success."""
    if recorder is None or not directory:
        return None
    from ..utils.logging import LOG_WARN
    try:
        path = recorder.dump(directory, reason, **attrs)
        LOG_WARN(f"flight recorder: {reason} black box -> {path}")
        return path
    except Exception as e:  # noqa: BLE001
        LOG_WARN(f"flight recorder dump failed: "
                 f"{type(e).__name__}: {e}")
        return None


def validate_dump(payload) -> List[str]:
    """Schema-check a flight-recorder dump (the CI gate). Accepts the
    payload dict or a path. Returns human-readable problems (empty =
    valid)."""
    problems: List[str] = []
    if isinstance(payload, (str, os.PathLike)):
        try:
            with open(payload, encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, ValueError) as e:
            return [f"cannot load dump: {type(e).__name__}: {e}"]
    if not isinstance(payload, dict):
        return ["top level must be a JSON object"]
    if payload.get("schema") != FLIGHT_SCHEMA_VERSION:
        problems.append(f"schema {payload.get('schema')!r} != "
                        f"{FLIGHT_SCHEMA_VERSION}")
    if payload.get("kind") != "flight_recorder":
        problems.append(f"kind {payload.get('kind')!r} != "
                        f"'flight_recorder'")
    for key, typ in (("run", str), ("reason", str)):
        if not isinstance(payload.get(key), typ) or not payload.get(key):
            problems.append(f"missing/invalid {key!r}")
    if not isinstance(payload.get("time"), (int, float)) \
            or isinstance(payload.get("time"), bool):
        problems.append("missing/invalid 'time'")
    for key in ("events", "probes", "spans"):
        if not isinstance(payload.get(key), list):
            problems.append(f"missing/invalid {key!r} (must be a list)")
    # the embedded events speak the unified telemetry schema
    if isinstance(payload.get("events"), list):
        from ..telemetry import validate_events
        problems.extend(f"events: {p}"
                        for p in validate_events(payload["events"]))
    for i, sp in enumerate(payload.get("spans") or []):
        if not isinstance(sp, dict) or not isinstance(sp.get("name"),
                                                      str):
            problems.append(f"span {i}: missing name")
        elif not isinstance(sp.get("start"), (int, float)):
            problems.append(f"span {i}: missing/invalid start")
    metrics = payload.get("metrics")
    if metrics is not None and (not isinstance(metrics, dict)
                                or "metrics" not in metrics):
        problems.append("'metrics' present but not a metrics snapshot")
    linkmap = payload.get("linkmap")
    if linkmap is not None and (not isinstance(linkmap, dict)
                                or "links" not in linkmap):
        problems.append("'linkmap' present but not a linkmap summary")
    return problems


def render_timeline(payload) -> str:
    """The merged incident timeline (``observatory replay``): events,
    probe verdicts, and span boundaries interleaved by wall time,
    offset-relative to the first entry so the story reads in seconds,
    newest history last. Accepts the payload dict or a path."""
    if isinstance(payload, (str, os.PathLike)):
        with open(payload, encoding="utf-8") as f:
            payload = json.load(f)

    def fmt_attrs(d: Dict, skip=()) -> str:
        parts = []
        for k in sorted(d):
            if k in skip:
                continue
            v = d[k]
            if isinstance(v, float):
                v = f"{v:.6g}"
            parts.append(f"{k}={v}")
        return " ".join(parts)

    rows: List = []  # (time, kind, text)
    for ev in payload.get("events") or []:
        t = ev.get("time")
        if not isinstance(t, (int, float)):
            continue
        extra = fmt_attrs({k: v for k, v in ev.items()
                           if k not in ("event", "time", "run", "seq",
                                        "schema", "span")})
        rows.append((float(t), "event",
                     f"{ev.get('event')}" + (f"  {extra}" if extra
                                             else "")))
    for pr in payload.get("probes") or []:
        t = pr.get("recorded")
        if not isinstance(t, (int, float)):
            continue
        verdict = "TRIPPED" if pr.get("tripped") else "ok"
        detail = f"step={pr.get('step')} {verdict}"
        if pr.get("reason"):
            detail += f" reason={pr.get('reason')}"
        rows.append((float(t), "probe", detail))
    for sp in payload.get("spans") or []:
        t = sp.get("start")
        if not isinstance(t, (int, float)):
            continue
        end = sp.get("end")
        dur = (f" [{1e3 * (end - t):.3f}ms]"
               if isinstance(end, (int, float)) else "")
        extra = fmt_attrs(sp.get("attrs") or {})
        rows.append((float(t), "span",
                     f"{sp.get('name')}{dur}"
                     + (f"  {extra}" if extra else "")))
    rows.sort(key=lambda r: r[0])
    t0 = rows[0][0] if rows else float(payload.get("time") or 0.0)
    lines = [
        f"flight recorder {payload.get('run')} — "
        f"reason={payload.get('reason')} "
        f"dumped={time.strftime('%Y-%m-%dT%H:%M:%S', time.gmtime(float(payload.get('time') or 0.0)))}Z "
        f"({len(payload.get('events') or [])} events, "
        f"{len(payload.get('probes') or [])} probes, "
        f"{len(payload.get('spans') or [])} spans"
        + (f", {payload['dropped_events']} events aged out"
           if payload.get("dropped_events") else "") + ")",
    ]
    attrs = payload.get("attrs") or {}
    if attrs:
        lines.append("  trigger: " + fmt_attrs(attrs))
    for t, kind, text in rows:
        lines.append(f"  {t - t0:+10.3f}s  {kind:<5}  {text}")
    return "\n".join(lines) + "\n"
