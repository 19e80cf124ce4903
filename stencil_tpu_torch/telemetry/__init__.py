"""Telemetry: the event log, spans, the metrics registry and the
step-metric columns that ride the health probe.

PyTorch-port counterpart of ``stencil_tpu/telemetry``, the parts the
resilience driver writes into:

* **one event schema** (``events.py``) — the versioned
  :class:`EventLog` (run id, monotonic seq, span id) with pluggable
  sinks;
* **structured spans** (``spans.py``) — a thread-safe tracer whose
  spans are profiler ranges (``utils/profiling.scope``) and exportable
  records (Chrome trace-event JSON for Perfetto);
* **metrics** (``metrics.py``) — labeled counters, gauges and
  histograms with Prometheus text and JSON snapshots;
* **step metrics** (``probe.py``) — counters riding the health probe's
  one reduction;
* **the ``/metrics`` server** (``http.py``, ``MetricsServer``) and the
  CLI (``python -m stencil_tpu_torch.telemetry``: ``snapshot``,
  ``validate-trace``, ``validate-events``).
"""

from .events import (EVENT_SCHEMA_VERSION, EventLog, JsonlSink,
                     ListSink, RingSink, StreamJsonSink, new_run_id,
                     validate_events)
from .http import MetricsServer
from .metrics import (DEFAULT_BUCKETS, METRICS_SCHEMA_VERSION, Counter,
                      Gauge, Histogram, MetricsRegistry, get_registry,
                      metric_value, parse_prometheus_text,
                      render_snapshot_text, snapshot_value)
from .probe import STEP_METRIC_NAMES, StepMetrics, step_metrics_for
from .spans import (Span, Tracer, get_tracer, set_tracer,
                    validate_chrome_trace)

__all__ = [
    "EVENT_SCHEMA_VERSION", "METRICS_SCHEMA_VERSION",
    "EventLog", "ListSink", "RingSink", "JsonlSink", "StreamJsonSink",
    "new_run_id", "validate_events",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "DEFAULT_BUCKETS", "metric_value", "parse_prometheus_text",
    "snapshot_value", "render_snapshot_text",
    "MetricsServer",
    "Span", "Tracer", "get_tracer", "set_tracer",
    "validate_chrome_trace",
    "STEP_METRIC_NAMES", "StepMetrics", "step_metrics_for",
]
