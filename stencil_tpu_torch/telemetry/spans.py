"""Structured spans: one tree, three audiences.

PyTorch-port copy of ``stencil_tpu/telemetry/spans.py``. A telemetry
span (campaign -> segment -> checkpoint/restore) is simultaneously:

* a ``torch.profiler.record_function`` range — the span shows on a
  ``torch.profiler`` trace beside the kernels it launched;
* an NVTX range while CUDA is in use (the reference library's own
  annotation), for a profiler that reads them;
* an exportable record with a stable id (``<run>/<n>``), parent id,
  begin/end timestamps, and attributes — dumped as Chrome trace-event
  JSON (:meth:`Tracer.export_chrome_trace`) loadable in Perfetto or
  ``chrome://tracing``, no profiler session required.

The first two come from :func:`..utils.profiling.scope`; the third is
the in-process record a run can export.

:class:`Tracer` is thread-safe: each thread keeps its own span stack
(``threading.local``), finished spans land in one bounded ring.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

from ..utils.profiling import scope
from .events import new_run_id


@dataclasses.dataclass
class Span:
    """One finished (or live) span."""

    name: str
    span_id: str
    parent_id: Optional[str]
    start_s: float          # seconds since the tracer's epoch
    end_s: Optional[float] = None
    thread: int = 0
    attrs: Dict = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return (self.end_s - self.start_s) if self.end_s is not None \
            else 0.0


class Tracer:
    """Thread-safe in-process span recorder with Perfetto export."""

    #: export identity keys — span attrs may not shadow them (the
    #: same contract as ``EventLog.RESERVED``)
    RESERVED = frozenset(("span_id", "parent_id"))

    def __init__(self, run_id: Optional[str] = None,
                 capacity: int = 65536) -> None:
        self.run_id = run_id or new_run_id()
        self._lock = threading.Lock()
        self._counter = 0
        self._local = threading.local()
        self._finished: deque = deque(maxlen=int(capacity))
        self._dropped = 0
        self._epoch = time.perf_counter()
        #: wall-clock time of the epoch (Perfetto metadata)
        self.epoch_unix = time.time()

    # -- recording ------------------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _new_id(self) -> str:
        with self._lock:
            n = self._counter
            self._counter += 1
        return f"{self.run_id}/{n}"

    def current_span_id(self) -> Optional[str]:
        st = self._stack()
        return st[-1].span_id if st else None

    @contextmanager
    def span(self, name: str, **attrs) -> Iterator[Span]:
        """Open a child span of the thread's current span. Inside the
        block, the span is a profiler range (``utils.profiling.scope``)."""
        bad = self.RESERVED.intersection(attrs)
        if bad:
            raise ValueError(
                f"span attrs may not shadow identity keys: {sorted(bad)}")
        st = self._stack()
        sp = Span(name=name, span_id=self._new_id(),
                  parent_id=st[-1].span_id if st else None,
                  start_s=time.perf_counter() - self._epoch,
                  thread=threading.get_ident(), attrs=dict(attrs))
        st.append(sp)
        try:
            with scope(name):
                yield sp
        finally:
            sp.end_s = time.perf_counter() - self._epoch
            st.pop()
            with self._lock:
                if len(self._finished) == self._finished.maxlen:
                    self._dropped += 1
                self._finished.append(sp)

    def finished(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    @property
    def dropped(self) -> int:
        """Finished spans evicted from the ring — truncation is never
        silent (exported parent ids may reference evicted spans)."""
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()
            self._dropped = 0

    # -- export ---------------------------------------------------------
    def chrome_trace(self) -> Dict:
        """The Chrome trace-event payload (``ph: "X"`` complete events,
        microsecond timestamps) Perfetto and chrome://tracing load."""
        events = []
        pid = os.getpid()
        for sp in self.finished():
            args = {"span_id": sp.span_id}
            if sp.parent_id is not None:
                args["parent_id"] = sp.parent_id
            args.update({k: v for k, v in sp.attrs.items()
                         if isinstance(v, (str, int, float, bool))
                         or v is None})
            events.append({
                "name": sp.name, "cat": "stencil_tpu_torch", "ph": "X",
                "ts": round(sp.start_s * 1e6, 3),
                "dur": round(sp.duration_s * 1e6, 3),
                "pid": pid, "tid": sp.thread, "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"run": self.run_id,
                              "epoch_unix_s": self.epoch_unix,
                              "dropped_spans": self.dropped,
                              "tool": "stencil_tpu_torch.telemetry"}}

    def export_chrome_trace(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(), f, indent=1)


def validate_chrome_trace(payload) -> List[str]:
    """Structural validation against the trace-event format (the CI
    gate for exported traces). Accepts the payload dict or a path.
    Returns human-readable problems (empty = loads in Perfetto)."""
    problems: List[str] = []
    if isinstance(payload, (str, os.PathLike)):
        try:
            with open(payload, encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, ValueError) as e:
            return [f"cannot load trace: {type(e).__name__}: {e}"]
    if not isinstance(payload, dict):
        return ["top level must be a JSON object"]
    events = payload.get("traceEvents")
    if not isinstance(events, list):
        return ["missing traceEvents array"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        if not isinstance(ev.get("name"), str):
            problems.append(f"event {i}: missing name")
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            problems.append(f"event {i}: missing ph")
        for key in ("ts",) + (("dur",) if ph == "X" else ()):
            v = ev.get(key)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v < 0:
                problems.append(f"event {i}: missing/invalid {key!r}")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                problems.append(f"event {i}: missing/invalid {key!r}")
    return problems


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-default tracer (run loops; services own their own)."""
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-default tracer; returns the previous one."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev
