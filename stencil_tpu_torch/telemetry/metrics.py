"""Counters / gauges / histograms with a Prometheus text surface.

PyTorch-port copy of ``stencil_tpu/telemetry/metrics.py`` (plain
Python; ``http.py`` serves it at ``/metrics``). The
operational metrics layer: labeled counters, gauges, and
histograms in one thread-safe :class:`MetricsRegistry`, exportable two
ways — Prometheus text exposition (``to_prometheus_text``) and a JSON
snapshot (``snapshot``, the CI artifact format).

Metric names and labels are a stable contract (documented in README
"Observability"); tests and the CI gates assert the serving warm-path
invariants from this exported surface rather than internal fields —
:func:`metric_value` / :func:`snapshot_value` are the tiny accessors
they use, so the asserted artifact is exactly what an external scraper
sees.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

#: snapshot schema version (bump on breaking key changes)
METRICS_SCHEMA_VERSION = 1

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    """Escape a label value per exposition format 0.0.4 (backslash,
    double-quote, newline) — tenant-controlled strings must not be able
    to corrupt the scrape."""
    return (v.replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _label_text(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
    return "{" + inner + "}"


class _Metric:
    """Shared plumbing: a name, help text, and per-label-set values."""

    kind = ""

    def __init__(self, name: str, help: str, lock: threading.RLock
                 ) -> None:
        self.name = name
        self.help = help
        self._lock = lock
        self._values: Dict[LabelKey, float] = {}

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def _samples(self) -> List[Dict]:
        return [{"labels": dict(k), "value": v}
                for k, v in sorted(self._values.items())]


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _render_metric(out: List[str], name: str, kind: str, help: str,
                   samples) -> None:
    """Render one metric's HELP/TYPE header and samples (the JSON
    snapshot sample shape) as exposition text — the ONE place the
    line format lives, shared by the live scrape and the snapshot
    CLI so the two surfaces cannot drift."""
    if help:
        # HELP escapes backslash + newline (format 0.0.4) — a wrapped
        # help string must not corrupt the scrape
        esc = help.replace("\\", r"\\").replace("\n", r"\n")
        out.append(f"# HELP {name} {esc}")
    out.append(f"# TYPE {name} {kind}")
    for s in samples:
        key = _label_key(s.get("labels") or {})
        if kind == "histogram":
            for le, n in (s.get("buckets") or {}).items():
                lk = key + (("le", le),)
                out.append(f"{name}_bucket{_label_text(lk)} {n}")
            lk = key + (("le", "+Inf"),)
            out.append(f"{name}_bucket{_label_text(lk)} "
                       f"{s.get('count', 0)}")
            out.append(f"{name}_sum{_label_text(key)} "
                       f"{_format_value(s.get('sum', 0.0))}")
            out.append(f"{name}_count{_label_text(key)} "
                       f"{s.get('count', 0)}")
        else:
            out.append(f"{name}{_label_text(key)} "
                       f"{_format_value(s.get('value', 0.0))}")


class Counter(_Metric):
    """Monotonically increasing count (``*_total`` by convention)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Metric):
    """A value that goes up and down (queue depth, steps/s)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


#: latency-flavored default buckets (seconds)
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   60.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: each
    ``le``-bucket counts observations <= its bound, plus ``+Inf``)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.RLock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help, lock)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"histogram {name} needs >= 1 bucket")
        self.buckets: Tuple[float, ...] = tuple(bs)
        # per label set: [bucket counts..., +Inf count], sum
        self._hist: Dict[LabelKey, Tuple[List[int], float]] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            counts, total = self._hist.get(
                key, ([0] * (len(self.buckets) + 1), 0.0))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            counts[-1] += 1
            self._hist[key] = (counts, total + float(value))

    def value(self, **labels) -> float:
        raise TypeError(
            f"histogram {self.name} has no single value; use "
            f"count()/sum() or the *_bucket/_sum/_count series")

    def count(self, **labels) -> int:
        with self._lock:
            got = self._hist.get(_label_key(labels))
            return got[0][-1] if got else 0

    def sum(self, **labels) -> float:
        with self._lock:
            got = self._hist.get(_label_key(labels))
            return got[1] if got else 0.0

    def _samples(self) -> List[Dict]:
        out = []
        for k, (counts, total) in sorted(self._hist.items()):
            out.append({"labels": dict(k), "count": counts[-1],
                        "sum": total,
                        "buckets": {_format_value(b): counts[i]
                                    for i, b in enumerate(self.buckets)}})
        return out


class MetricsRegistry:
    """Thread-safe home of every metric one process/service exports.

    Registration is idempotent by name (re-registering returns the
    existing metric; a kind mismatch raises), so instrumentation code
    can declare metrics where it uses them."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            got = self._metrics.get(name)
            if got is not None:
                if not isinstance(got, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{got.kind}, not {cls.kind}")
                want = kw.get("buckets")
                if want is not None and tuple(
                        sorted(float(b) for b in want)) != got.buckets:
                    # silently keeping the first buckets would bin the
                    # caller's observations into bounds it never chose
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {got.buckets}, not {tuple(want)}")
                return got
            m = cls(name, help, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)  # type: ignore

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)  # type: ignore

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None
                  ) -> Histogram:
        """``buckets=None`` means no preference: creation uses
        :data:`DEFAULT_BUCKETS`, and re-declaring an existing histogram
        without buckets stays idempotent even when its first
        registration chose custom bounds (only an EXPLICIT conflicting
        choice raises)."""
        kw = {} if buckets is None else {"buckets": buckets}
        return self._register(Histogram, name, help, **kw)  # type: ignore

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    # -- export surfaces ------------------------------------------------
    def to_prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: List[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                _render_metric(out, name, m.kind, m.help, m._samples())
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict:
        """JSON-serializable snapshot (the CI artifact format)."""
        with self._lock:
            metrics = {
                name: {"type": m.kind, "help": m.help,
                       "samples": m._samples()}
                for name, m in sorted(self._metrics.items())}
        return {"schema": METRICS_SCHEMA_VERSION, "time": time.time(),
                "metrics": metrics}

    def write_snapshot(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.snapshot(), f, indent=1)


#: the process-default registry (run loops; services own their own)
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY


# ---------------------------------------------------------------------------
# accessors for exported surfaces (tests / CI assert through these, so
# the asserted artifact is exactly the external one)


_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:\\.|[^"\\])*)"')


def _unescape_label(v: str) -> str:
    return re.sub(r"\\(.)",
                  lambda m: {"n": "\n"}.get(m.group(1), m.group(1)), v)


def parse_prometheus_text(text: str) -> Dict[str, Dict[LabelKey, float]]:
    """Parse exposition text back to {name: {label key: value}}.
    Label values are unescaped per format 0.0.4, so values containing
    quotes, commas, or backslashes round-trip exactly."""
    out: Dict[str, Dict[LabelKey, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        if not head:
            continue
        if "{" in head:
            name, _, rest = head.partition("{")
            labels = {k: _unescape_label(v)
                      for k, v in _LABEL_RE.findall(rest)}
            key = _label_key(labels)
        else:
            name, key = head, ()
        out.setdefault(name, {})[key] = (
            math.inf if val == "+Inf" else float(val))
    return out


def metric_value(text_or_parsed: Union[str, Dict], name: str,
                 **labels) -> float:
    """The value of ``name{labels}`` in exposition text (missing ->
    0.0, the Prometheus absent-series convention)."""
    parsed = (parse_prometheus_text(text_or_parsed)
              if isinstance(text_or_parsed, str) else text_or_parsed)
    return parsed.get(name, {}).get(_label_key(labels), 0.0)


def snapshot_value(snap: Dict, name: str, **labels) -> float:
    """The value of ``name{labels}`` in a :meth:`MetricsRegistry.
    snapshot` payload (missing -> 0.0)."""
    want = _label_key(labels)
    metric = (snap.get("metrics") or {}).get(name)
    if not metric:
        return 0.0
    for sample in metric.get("samples", ()):
        if _label_key(sample.get("labels") or {}) == want:
            return float(sample.get("value",
                                    sample.get("count", 0.0)))
    return 0.0


def render_snapshot_text(snap: Dict) -> str:
    """Re-render a JSON snapshot as Prometheus text (the
    snapshot CLI output) — same
    renderer as the live scrape (:func:`_render_metric`)."""
    out: List[str] = []
    for name, m in sorted((snap.get("metrics") or {}).items()):
        _render_metric(out, name, m.get("type", ""), m.get("help", ""),
                       m.get("samples", ()))
    return "\n".join(out) + "\n"
