"""Profiling scopes, phase timers and the setup, exchange and autotune
reports.

PyTorch-port counterpart of ``stencil_tpu/utils/profiling.py`` (the
analog of the reference's NVTX ranges and its STENCIL_SETUP_STATS /
STENCIL_EXCHANGE_STATS reductions, src/stencil.cu:36-48,311,1003-1080,
1174-1181): ``scope`` is a named range on a ``torch.profiler`` trace
(``record_function``) and, while CUDA is in use, an NVTX range; the
telemetry spans (``telemetry/spans.py``) wrap it. ``trace`` captures a
``torch.profiler`` session into a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def scope(name: str) -> Iterator[None]:
    """Label the host range ``name`` on the profiler timeline (and as
    an NVTX range once CUDA is initialized)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a host and device profile (``torch.profiler``) of the
    block into ``<log_dir>/trace.json`` (Chrome trace format, viewable
    in Perfetto): the nsys recipe of the reference's README."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseTimer:
    """Named wall-clock phases with the max-over-processes reduction the
    reference's setup stats use (one process: identity)."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)

    def reduced(self) -> Dict[str, float]:
        """The seconds of each phase, the maximum over the ranks of the
        process group (a collective when one is up)."""
        from ..parallel.multihost import all_gather_objects, process_count

        if process_count() == 1:
            return dict(self.seconds)
        every = all_gather_objects(dict(self.seconds))
        names = sorted({n for d in every for n in d})
        return {n: max(d.get(n, 0.0) for d in every) for n in names}


def setup_stats_report(dd) -> str:
    """One-line setup-time report (the STENCIL_SETUP_STATS print,
    reference: src/stencil.cu:205-236)."""
    parts = [f"{k}={v:.6f}s" for k, v in dd.setup_seconds.items()]
    return "setup: " + " ".join(parts)


def exchange_stats_report(dd) -> str:
    """Exchange-time report (STENCIL_EXCHANGE_STATS; needs
    ``dd.enable_timing(True)``), with the analytic wire bytes of
    ``dd.exchange_bytes_total()`` and the whole-mesh rate they imply at
    the trimean; under temporal blocking the per-step amortization; and
    the plan's provenance when the autotuner decided (JAX
    ``utils/profiling.py:85-125``)."""
    if not dd.exchange_seconds:
        return "exchange: no samples (enable_timing first)"
    from ..numerics import trimean

    xs = dd.exchange_seconds
    line = (f"exchange: n={len(xs)} min={min(xs):.6e}s "
            f"trimean={trimean(xs):.6e}s")
    try:
        expected = int(dd.exchange_bytes_total())
    except (AttributeError, TypeError):
        return line
    tm = trimean(xs)
    if expected and tm > 0:
        line += (f" expected={expected}B/exchange (analytic)"
                 f" eff={expected / tm / 1e9:.2f}GB/s")
    s = getattr(dd, "exchange_every", 1)
    if s > 1 and expected and tm > 0:
        amortized = dd.exchange_bytes_amortized_per_step()
        line += (f" exchange_every={s}"
                 f" amortized={amortized:.0f}B/step"
                 f" ({tm / s:.6e}s/step exchange cost)")
    prov = getattr(dd, "plan_provenance", "default")
    if prov != "default":
        line += f" plan={prov}"
    return line


def autotune_report(plan) -> str:
    """Multi-line report of a ``tuning.Plan``: the decision, its
    provenance, the measured link coefficients and the best four
    candidates' costs (JAX ``utils/profiling.py:128-149``)."""
    lines = [f"autotune: {plan.config.key()} provenance={plan.provenance}"
             f" measurements={plan.measurements}"
             f" fingerprint={plan.fingerprint[:12]}..."]
    for link, c in sorted(plan.coefficients.items()):
        lines.append(f"  link {link}: alpha={c['alpha_s']:.3e}s"
                     f" beta={c['beta_bytes_per_s']:.3e}B/s (measured)")
    ranked = sorted(plan.costs.items(),
                    key=lambda kv: kv[1].get(
                        "measured_s", kv[1].get("predicted_s", 0.0)))
    for key, rec in ranked[:4]:
        meas = (f" measured={rec['measured_s']:.3e}s/step"
                if "measured_s" in rec else " (pruned by model)")
        lines.append(f"  {key}: predicted="
                     f"{rec.get('predicted_s', float('nan')):.3e}s/step"
                     f"{meas}")
    return "\n".join(lines)
