"""Model-vs-measured attribution: what did the dispatch actually cost?

PyTorch-port counterpart of ``stencil_tpu/observatory/attribution.py``.
The calibrated cost model (``analysis/costmodel.configured_step_seconds``
for halo sweeps, ``migration_step_seconds`` for PIC) predicts what a
step should cost; :class:`PerfAttributor` measures what the dispatch
achieves — host seconds around it, fenced by a synchronize of the cards
that hold the state (the caller's ``block``), amortized over the
segment's ``k`` steps — and exports the ratio as
``stencil_perf_model_error_ratio{entry,method,s}`` beside the achieved
and modeled bytes/s. The dispatched work is not changed: attribution is
a host clock around it.

Drift detection: the first usable observation calibrates a reference
ratio, which stays fixed until :meth:`PerfAttributor.reset`; ``window``
consecutive observations that depart from it by more than ``tolerance``
(relative) emit one ``perf_drift`` event and fire ``on_drift`` — which,
under ``ResiliencePolicy.retune_on_drift``, invalidates the plan-cache
record so that the tuner re-measures.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

#: measured/modeled seconds-per-step of attributed dispatches
METRIC_MODEL_ERROR_RATIO = "stencil_perf_model_error_ratio"
#: wire bytes/s the dispatch achieved (model bytes / measured s)
METRIC_ACHIEVED_BYTES_PER_S = "stencil_perf_achieved_bytes_per_s"
#: wire bytes/s the calibrated model promises (model bytes / model s)
METRIC_MODELED_BYTES_PER_S = "stencil_perf_modeled_bytes_per_s"


def make_drift_invalidator(cache_path, log: Callable) -> Callable:
    """The ``on_drift`` hook of ``retune_on_drift``: drop the drifted
    plan's cache record (``tuning.invalidate_plan``) and log
    ``plan_invalidated`` through ``log(kind, **attrs)``."""
    def on_drift(attrs: Dict) -> None:
        fp = attrs.get("fingerprint")
        if not fp:
            return
        from ..tuning.cache import invalidate_plan
        removed = invalidate_plan(fp, cache_path)
        log("plan_invalidated", fingerprint=fp, removed=bool(removed))
    return on_drift


def model_step_seconds_for(dd) -> Optional[float]:
    """The cost model's exchange seconds per STEP for ``dd``'s
    configuration: ``configured_step_seconds`` with the tuned plan's
    fitted coefficients (the bottleneck combination across link classes,
    as the tuner ranks) when the domain carries a plan, the default
    intra-host link otherwise. None when nothing is priced (one shard,
    an unrealized domain, a geometry the model cannot host); never
    raises."""
    try:
        from ..analysis.costmodel import (DEFAULT_ICI_COEFFS,
                                          LinkCoefficients,
                                          configured_step_seconds)
        from ..parallel.methods import pick_method

        method = pick_method(dd.methods).name
        counts = dd.mesh_counts
        local = dd.local_size
        elem_sizes = tuple(dd._dtypes[q].itemsize for q in dd._names)
        coeffs = DEFAULT_ICI_COEFFS
        plan = getattr(dd, "plan", None)
        if plan is not None and getattr(plan, "coefficients", None):
            coeffs = LinkCoefficients(
                alpha_s=max(c["alpha_s"]
                            for c in plan.coefficients.values()),
                beta_bytes_per_s=min(c["beta_bytes_per_s"]
                                     for c in plan.coefficients.values()))
        groups = len({str(dd._dtypes[q]) for q in dd._names})
        model = configured_step_seconds(
            method, (local.z, local.y, local.x), dd.radius, counts,
            elem_sizes, int(dd.exchange_every), coeffs, groups)
        return model if model > 0.0 else None
    except Exception:  # noqa: BLE001 - no price -> attribution off
        return None


class PerfAttributor:
    """Measured-vs-modeled attribution of one dispatch entry point (JAX
    ``observatory/attribution.py:100-322``).

    ``entry``/``method``/``exchange_every`` label the gauges
    ``{entry,method,s}``. ``model_step_seconds`` is the prediction the
    measurements are paired with (falsy disables the attributor,
    :attr:`enabled`). ``emit(kind, **attrs)`` receives the
    ``perf_drift`` event; ``on_drift(attrs)`` fires once per drift
    episode. ``warmup`` observations export but neither calibrate nor
    count (the first dispatch builds kernels). ``clock`` is injectable
    for tests."""

    def __init__(self, entry: str, method: str = "", exchange_every: int = 1,
                 model_step_seconds: Optional[float] = None,
                 model_bytes_per_step: float = 0.0,
                 tolerance: float = 0.5, window: int = 3,
                 warmup: int = 0,
                 emit: Optional[Callable] = None,
                 on_drift: Optional[Callable[[Dict], None]] = None,
                 fingerprint: Optional[str] = None,
                 registry=None,
                 link_bytes_per_step: Optional[Dict] = None,
                 link_peak_bytes_per_s: Optional[Dict] = None,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        if float(tolerance) <= 0:
            raise ValueError(f"tolerance must be > 0, got {tolerance}")
        if int(window) < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.entry = str(entry)
        self.method = str(method)
        self.exchange_every = int(exchange_every)
        self.model_step_seconds = (float(model_step_seconds)
                                   if model_step_seconds else 0.0)
        self.model_bytes_per_step = float(model_bytes_per_step)
        self.tolerance = float(tolerance)
        self.window = int(window)
        self._warmup = max(int(warmup), 0)
        self.fingerprint = fingerprint
        self._emit = emit
        self._on_drift = on_drift
        self._clock = clock
        if registry is None:
            from ..telemetry import get_registry
            registry = get_registry()
        self._g_ratio = registry.gauge(
            METRIC_MODEL_ERROR_RATIO,
            "measured/modeled seconds-per-step of attributed dispatches "
            "(fenced by a synchronize of the state's cards, amortized "
            "over the segment's k steps); 0 = not yet observed / reset "
            "after a re-tune")
        self._g_achieved = registry.gauge(
            METRIC_ACHIEVED_BYTES_PER_S,
            "wire B/s the attributed dispatch actually achieved "
            "(modeled bytes over measured seconds)")
        self._g_modeled = registry.gauge(
            METRIC_MODELED_BYTES_PER_S,
            "wire B/s the calibrated cost model promises for the "
            "active plan")
        self.link_bytes_per_step: Dict = dict(link_bytes_per_step or {})
        self.link_peak_bytes_per_s: Dict = dict(link_peak_bytes_per_s
                                                or {})
        from .linkmap import (METRIC_LINK_BYTES_PER_STEP,
                              METRIC_LINK_UTILIZATION)
        self._g_link_bytes = registry.gauge(
            METRIC_LINK_BYTES_PER_STEP,
            "modeled wire B/step per mesh axis and link class (self / "
            "ici-hop<k> / dcn), classified against the deployed "
            "device order")
        self._g_link_util = registry.gauge(
            METRIC_LINK_UTILIZATION,
            "achieved/fitted-peak wire utilization per mesh axis and "
            "link class: the link's modeled B/step over the measured "
            "step seconds, against the fitted beta for that axis; 0 = "
            "not yet observed / reset after a re-tune")
        self.last_ratio: Optional[float] = None
        self._baseline: Optional[float] = None
        self._streak = 0
        self._drifted = False

    @property
    def enabled(self) -> bool:
        return self.model_step_seconds > 0.0

    def labels(self) -> Dict[str, str]:
        return {"entry": self.entry, "method": self.method,
                "s": str(self.exchange_every)}

    @contextlib.contextmanager
    def dispatch(self, k: int, block: Callable[[], None],
                 step: Optional[int] = None):
        """Time one dispatch advancing ``k`` steps: from entry to after
        ``block()`` (the synchronize of the state's cards: queued work
        must not be credited with the seconds it merely deferred), then
        :meth:`observe`. A disabled attributor passes through."""
        if not self.enabled:
            yield self
            return
        t0 = self._clock()
        yield self
        block()
        self.observe(k, self._clock() - t0, step=step)

    def observe(self, k: int, seconds: float,
                step: Optional[int] = None) -> Optional[Dict]:
        """Attribute one dispatch of ``k`` steps taking ``seconds``:
        export the gauges, run the drift detector, return the
        ``perf_drift`` attrs when this observation fired one."""
        if not self.enabled:
            return None
        measured = float(seconds) / max(int(k), 1)
        ratio = measured / self.model_step_seconds
        self.last_ratio = ratio
        labels = self.labels()
        self._g_ratio.set(ratio, **labels)
        if self.model_bytes_per_step > 0.0 and measured > 0.0:
            self._g_achieved.set(self.model_bytes_per_step / measured,
                                 **labels)
            self._g_modeled.set(
                self.model_bytes_per_step / self.model_step_seconds,
                **labels)
        self._export_links(measured)
        if self._warmup > 0:
            self._warmup -= 1
            return None
        if not self._baseline:
            # the first usable (nonzero) ratio calibrates
            self._baseline = ratio
            return None
        # the reference stays fixed until reset(): a moving one would
        # walk along with a slow degradation and never flag it
        rel = abs(ratio - self._baseline) / self._baseline
        if rel <= self.tolerance:
            self._streak = 0
            self._drifted = False
            return None
        self._streak += 1
        if self._streak < self.window or self._drifted:
            return None
        self._drifted = True
        attrs: Dict = {
            "entry": self.entry, "method": self.method,
            "s": self.exchange_every, "ratio": ratio,
            "baseline": self._baseline, "consecutive": self._streak,
            "tolerance": self.tolerance, "window": self.window,
        }
        if step is not None:
            attrs["step"] = int(step)
        if self.fingerprint:
            attrs["fingerprint"] = self.fingerprint
        if self._emit is not None:
            self._emit("perf_drift", **attrs)
        if self._on_drift is not None:
            self._on_drift(dict(attrs))
        return attrs

    def _export_links(self, measured_step_seconds: float,
                      clear: bool = False) -> None:
        """The per-link gauges of one observation (``clear`` zeroes
        them)."""
        for (axis, klass), nbytes in self.link_bytes_per_step.items():
            labels = {"axis": str(axis), "link_class": str(klass)}
            self._g_link_bytes.set(0.0 if clear else float(nbytes),
                                   **labels)
            peak = self.link_peak_bytes_per_s.get(str(axis))
            if clear:
                self._g_link_util.set(0.0, **labels)
            elif peak and measured_step_seconds > 0.0:
                achieved = float(nbytes) / measured_step_seconds
                self._g_link_util.set(achieved / float(peak), **labels)

    def reset(self, model_step_seconds: Optional[float] = None,
              fingerprint: Optional[str] = None) -> None:
        """A re-tuned or rebuilt plan supersedes what was observed: the
        gauge back to 0, the reference dropped, the latch re-armed."""
        if model_step_seconds is not None:
            self.model_step_seconds = float(model_step_seconds)
        if fingerprint is not None:
            self.fingerprint = fingerprint
        self._g_ratio.set(0.0, **self.labels())
        self._export_links(0.0, clear=True)
        self.last_ratio = None
        self._baseline = None
        self._streak = 0
        self._drifted = False
