"""Step metrics: counters that ride the health probe.

PyTorch-port counterpart of ``stencil_tpu/telemetry/probe.py:38-127``.
The health probe already reduces one small vector per probe
(``resilience/health.py``); :class:`StepMetrics` packs two counters into
extra columns of that vector, so that no second reduction is needed:

* ``substeps``   — cumulative steps completed at probe time;
* ``wire_bytes`` — cumulative exchanged wire bytes, priced by the
  domain's byte model (``DistributedDomain.
  exchange_bytes_amortized_per_step``), amortized across temporal
  blocking.

Values travel as float32 (the probe vector's dtype): exact up to 2**24.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

#: the step-metric columns, in probe-vector order
STEP_METRIC_NAMES: Tuple[str, ...] = ("substeps", "wire_bytes")


class StepMetrics:
    """The counter block of one realized domain, for
    ``HealthSentinel(metrics=)`` and ``make_segment(metrics=)``.

    Counters are keyed to the campaign position ``step``: wire bytes
    for steps up to ``base_step`` were priced at the configuration(s) in
    force when they ran (``base_bytes``); later steps at this domain's
    current per-step figure. A reconfigured domain takes the old block
    through :meth:`rebased`, so the new price applies only from there."""

    names: Tuple[str, ...] = STEP_METRIC_NAMES

    def __init__(self, dd, base_step: int = 0,
                 base_bytes: float = 0.0) -> None:
        #: whole-mesh modeled wire bytes per STEP (amortized across
        #: temporal blocking)
        self.bytes_per_step = float(dd.exchange_bytes_amortized_per_step())
        self.base_step = int(base_step)
        self.base_bytes = float(base_bytes)

    def cumulative_bytes(self, step: int) -> float:
        """Modeled wire bytes for the campaign's first ``step`` steps."""
        return self.base_bytes + \
            max(0, int(step) - self.base_step) * self.bytes_per_step

    def rebased(self, dd, step: int) -> "StepMetrics":
        """The counter block for a reconfigured domain, carrying the
        bytes already accounted at ``step``."""
        return StepMetrics(dd, base_step=step,
                           base_bytes=self.cumulative_bytes(step))

    def host_values(self, step: int) -> np.ndarray:
        """The float32 metrics vector for a probe of ``step``, on the
        host (JAX's ``values`` puts it on the devices; the port's probes
        fill their columns from it on the card, with no copy)."""
        step = int(step)
        return np.asarray([float(step), self.cumulative_bytes(step)],
                          dtype=np.float32)

    def decode(self, metrics: Dict[str, float]) -> Dict[str, float]:
        """Derived figures from harvested probe metrics: the raw counters
        plus the amortized B/step they imply beside the model's."""
        out = dict(metrics)
        steps = out.get("substeps", 0.0)
        out["bytes_per_step_probe"] = (out.get("wire_bytes", 0.0) / steps
                                       if steps else 0.0)
        out["bytes_per_step_model"] = self.bytes_per_step
        return out


def step_metrics_for(dd):
    """A :class:`StepMetrics` for ``dd``, or None when the domain has no
    exchange byte model (never raises: telemetry must not take down the
    loop it observes)."""
    try:
        return StepMetrics(dd)
    except Exception:  # noqa: BLE001 - absent model -> no metrics
        return None
