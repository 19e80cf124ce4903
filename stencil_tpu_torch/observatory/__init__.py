"""Performance observatory: the cost model's predictions held against
what the dispatches achieve.

PyTorch-port counterpart of ``stencil_tpu/observatory``, in four pieces:

* **Attribution** (:mod:`.attribution`) — :class:`PerfAttributor`
  pairs the measured seconds a step of every segment and stepwise
  window of the resilience driver (fenced by a synchronize of the
  state's cards) with the calibrated cost model's prediction for the
  active plan: ``stencil_perf_model_error_ratio{entry,method,s}`` and
  the achieved and modeled bytes/s; a drift detector emits
  ``perf_drift`` and, under ``retune_on_drift``, invalidates the plan's
  cache record.
* **Ledger** (:mod:`.ledger`) — one versioned bench-record schema that
  the apps' ``--ledger`` appends to; validate, diff and gate on the
  CLI.
* **Flight recorder** (:mod:`.recorder`) — a bounded black box dumped
  atomically on a trip, a degradation, SIGTERM or an unhandled error;
  ``replay`` renders the incident's timeline.
* **Link observatory** (:mod:`.linkmap`) — the modeled per-(src, dst)
  traffic matrix classified by link, a measured per-axis topology
  fingerprint the tuner reads, and the placement-quality report.

``python -m stencil_tpu_torch.observatory`` is the CLI.
"""

from .attribution import (METRIC_ACHIEVED_BYTES_PER_S,
                          METRIC_MODEL_ERROR_RATIO,
                          METRIC_MODELED_BYTES_PER_S, PerfAttributor,
                          make_drift_invalidator, model_step_seconds_for)
from .ledger import (LEDGER_SCHEMA_VERSION, append_record,
                     backfill_records, config_fingerprint,
                     default_ledger_path, diff_records, gate_regressions,
                     make_record, payload_records, read_ledger,
                     validate_record)
from .linkmap import (METRIC_LINK_BYTES_PER_STEP, METRIC_LINK_UTILIZATION,
                      LinkmapSummary, TrafficMatrix, allgather_traffic,
                      classify, link_attribution_for, load_topology,
                      measure_topology, method_traffic, migration_traffic,
                      pic_traffic, placement_report, save_topology,
                      sweep_traffic, topology_fingerprint,
                      topology_fingerprint_inputs)
from .recorder import (ENV_FLIGHT_DIR, FLIGHT_SCHEMA_VERSION,
                       FlightRecorder, render_timeline, safe_dump,
                       validate_dump)

__all__ = [
    "METRIC_LINK_BYTES_PER_STEP", "METRIC_LINK_UTILIZATION",
    "LinkmapSummary", "TrafficMatrix", "allgather_traffic", "classify",
    "link_attribution_for", "load_topology", "measure_topology",
    "method_traffic", "migration_traffic", "pic_traffic",
    "placement_report", "save_topology", "sweep_traffic",
    "topology_fingerprint", "topology_fingerprint_inputs",
    "PerfAttributor", "model_step_seconds_for", "make_drift_invalidator",
    "METRIC_MODEL_ERROR_RATIO", "METRIC_ACHIEVED_BYTES_PER_S",
    "METRIC_MODELED_BYTES_PER_S",
    "LEDGER_SCHEMA_VERSION", "make_record", "validate_record",
    "append_record", "read_ledger", "diff_records", "gate_regressions",
    "backfill_records", "payload_records", "config_fingerprint",
    "default_ledger_path",
    "FLIGHT_SCHEMA_VERSION", "ENV_FLIGHT_DIR", "FlightRecorder",
    "safe_dump", "validate_dump", "render_timeline",
]
