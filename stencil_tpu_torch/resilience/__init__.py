"""Driver-level robustness: health sentinels, fault injection, and
checkpoint-rollback recovery.

PyTorch-port counterpart of ``stencil_tpu/resilience``:

* :mod:`.health` — the on-device probe (one small reduction, one
  all-reduce across ranks) with asynchronous host readback and a
  divergence predicate;
* :mod:`.faults` — deterministic, seeded fault injection (NaN steps,
  corrupted halos, lost particles, checkpoint bit-rot, transient save
  ``IOError``, SIGTERM preemption, and the serving faults a fleet
  consumes);
* :mod:`.driver` — ``run_resilient``: checkpoint / watch / roll back /
  degrade / resume around any per-step engine.
"""

from .driver import (ResilienceError, ResiliencePolicy, ResilienceReport,
                     StepConfig, degradation_ladder, run_resilient)
from .faults import (AdmissionFlood, CheckpointCorruption, FaultPlan,
                     HaloCorruption, NaNInjection, ParticleLoss,
                     Preemption, ReplicaCrash, SlowReplica,
                     TransientSaveFailure)
from .health import HealthSentinel, HealthStats, make_probe, probe_shard

__all__ = [
    "AdmissionFlood",
    "CheckpointCorruption",
    "FaultPlan",
    "HaloCorruption",
    "HealthSentinel",
    "HealthStats",
    "NaNInjection",
    "ParticleLoss",
    "Preemption",
    "ReplicaCrash",
    "ResilienceError",
    "ResiliencePolicy",
    "ResilienceReport",
    "SlowReplica",
    "StepConfig",
    "TransientSaveFailure",
    "degradation_ladder",
    "make_probe",
    "probe_shard",
    "run_resilient",
]
