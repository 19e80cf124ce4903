"""The versioned telemetry event schema and its pluggable sinks.

PyTorch-port copy of ``stencil_tpu/telemetry/events.py`` (plain Python).
Every event (the resilience driver's report log among them) flows
through one :class:`EventLog`, which stamps each record
with the schema version, the run id, a monotonic per-run sequence
number, and (optionally) the span id of the enclosing telemetry span —
the keys a fleet log scraper needs to merge, order, and correlate
events from thousands of concurrent runs:

``{"event": kind, "time": <unix s>, "run": <id>, "seq": <n>,
"schema": 1, ["span": <id>,] **attrs}``

Sinks are deliberately dumb (``emit(record)`` / ``close()``):

* :class:`ListSink`   — append to a caller-owned list (the report
  dataclasses keep their serializable ``events`` fields);
* :class:`RingSink`   — bounded in-memory deque: a service that logs
  forever holds flat memory (the unbounded ``CampaignService.events``
  fix), with a dropped-record counter so truncation is never silent;
* :class:`JsonlSink`  — one JSON object per line, append-only (the CI
  artifact format);
* :class:`StreamJsonSink` — JSON lines to a stream (stderr by default;
  the ``STENCIL_LOG_FORMAT=json`` backend in ``utils/logging.py``).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

#: bump when a record key changes meaning; scrapers key on this
EVENT_SCHEMA_VERSION = 1


def new_run_id() -> str:
    """A fresh globally-unique run id (12 hex chars)."""
    return uuid.uuid4().hex[:12]


class ListSink:
    """Append records to a caller-owned list (kept serializable)."""

    def __init__(self, records: List[Dict]) -> None:
        self._records = records

    def emit(self, record: Dict) -> None:
        self._records.append(record)

    def close(self) -> None:
        pass


class RingSink:
    """Bounded in-memory ring: the newest ``capacity`` records.

    The fix for append-forever event lists — a service handling
    millions of requests holds flat memory. ``dropped`` counts records
    the ring aged out, so truncation shows up in the payload instead of
    silently shortening history."""

    def __init__(self, capacity: int = 4096) -> None:
        if int(capacity) < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self.dropped = 0
        # readers (records()) run on other threads than the emitting
        # EventLog — snapshotting a deque mid-append raises RuntimeError
        self._lock = threading.Lock()

    def emit(self, record: Dict) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(record)

    def records(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def close(self) -> None:
        pass


class JsonlSink:
    """One JSON object per line, appended to ``path`` (flushed per
    record — a crashed run keeps everything it logged)."""

    def __init__(self, path: str) -> None:
        self.path = str(path)
        self._fh = open(self.path, "a", encoding="utf-8")

    def emit(self, record: Dict) -> None:
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


class StreamJsonSink:
    """JSON lines to a stream; ``stream=None`` resolves ``sys.stderr``
    at emit time (so test harnesses that swap stderr still capture)."""

    def __init__(self, stream=None) -> None:
        self._stream = stream

    def emit(self, record: Dict) -> None:
        import sys

        stream = self._stream if self._stream is not None else sys.stderr
        print(json.dumps(record), file=stream)

    def close(self) -> None:
        pass


class EventLog:
    """The thread-safe stamping front end: every subsystem's events go
    through :meth:`emit`, which versions the record and fans it out to
    every sink."""

    def __init__(self, run_id: Optional[str] = None,
                 sinks: Sequence = (),
                 clock: Callable[[], float] = time.time) -> None:
        self.run_id = run_id or new_run_id()
        self._sinks = list(sinks)
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = 0

    def add_sink(self, sink) -> None:
        with self._lock:
            self._sinks.append(sink)

    #: record keys the log stamps itself — attrs may not shadow them
    RESERVED = frozenset(("event", "time", "run", "seq", "schema",
                          "span"))

    def emit(self, kind: str, span: Optional[str] = None,
             **attrs) -> Dict:
        """Stamp and fan out one event record; returns the record.
        ``attrs`` may not use the stamped schema keys (:attr:`RESERVED`)
        — a colliding attribute would silently corrupt the run/seq/time
        identity every scraper merges on, so it raises instead.

        Sink fan-out runs UNDER the log lock (stdlib-``logging``
        semantics, deliberately): ``validate_events`` requires per-run
        ``seq`` strictly increasing in sink order, and ``JsonlSink``'s
        per-record flush is the crash-durability contract — emitting
        outside the lock could interleave records out of seq order.
        High-rate paths (the service event log) use the in-memory
        :class:`RingSink`, which does no I/O."""
        bad = self.RESERVED.intersection(attrs)
        if bad:
            raise ValueError(
                f"event attrs may not shadow schema keys: {sorted(bad)}")
        with self._lock:
            seq = self._seq
            self._seq += 1
            record: Dict = {"event": kind, "time": self._clock(),
                            "run": self.run_id, "seq": seq,
                            "schema": EVENT_SCHEMA_VERSION}
            if span is not None:
                record["span"] = span
            record.update(attrs)
            for sink in self._sinks:
                # a failing sink (disk full, closed stream) must not
                # take down the loop being observed, nor starve the
                # remaining sinks of the record — warn on stderr
                # directly (LOG_* may itself route through an EventLog)
                try:
                    sink.emit(record)
                except Exception as e:  # noqa: BLE001
                    import sys

                    print(f"telemetry: {type(sink).__name__}.emit "
                          f"failed: {type(e).__name__}: {e}",
                          file=sys.stderr)
        return record

    def close(self) -> None:
        with self._lock:
            for sink in self._sinks:
                sink.close()


def validate_events(records: Sequence[Dict]) -> List[str]:
    """Schema-check a batch of event records (the CLI/CI validator):
    required keys present, types sane, and per-run sequence numbers
    strictly increasing. Returns human-readable problems (empty =
    valid)."""
    problems: List[str] = []
    last_seq: Dict[str, float] = {}
    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            problems.append(f"record {i}: not an object")
            continue
        for key, typ in (("event", str), ("run", str)):
            if not isinstance(rec.get(key), typ):
                problems.append(f"record {i}: missing/invalid {key!r}")
        for key in ("time", "seq", "schema"):
            if not isinstance(rec.get(key), (int, float)) \
                    or isinstance(rec.get(key), bool):
                problems.append(f"record {i}: missing/invalid {key!r}")
        if rec.get("schema") not in (None, EVENT_SCHEMA_VERSION):
            problems.append(
                f"record {i}: schema {rec.get('schema')!r} != "
                f"{EVENT_SCHEMA_VERSION}")
        run, seq = rec.get("run"), rec.get("seq")
        # ordering applies to any numeric seq (an external serializer
        # may write 1.0 — the type gate above accepts it, so the
        # monotonicity gate must too)
        if isinstance(run, str) and isinstance(seq, (int, float)) \
                and not isinstance(seq, bool):
            if run in last_seq and seq <= last_seq[run]:
                problems.append(
                    f"record {i}: seq {seq} not increasing for run "
                    f"{run} (last {last_seq[run]})")
            last_seq[run] = seq
    return problems
