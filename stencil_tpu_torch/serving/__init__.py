"""Ensemble serving: batched campaigns behind an async multi-tenant
service.

PyTorch-port counterpart of ``stencil_tpu/serving``:

* **Batched ensembles** (:mod:`.ensemble`) — a leading member axis runs
  through the plain stencil math, the exchange (B4 sweeps the member
  views as rows of one launch table) and the health probe, so ONE
  dispatch advances N independent simulations (distinct initial
  conditions and per-member physics parameters) with the launches and
  messages of one; the wire carries exactly N x the bytes. Health
  sentinels are per member (:class:`.ensemble.EnsembleSentinel`).

* **The campaign service** (:mod:`.queue`, :mod:`.service`) — requests
  queue up, admission packs fingerprint-compatible requests (the
  :mod:`..tuning` fingerprint) into one ensemble dispatch, the
  persistent tuning-plan cache supplies the exchange plan with zero
  re-measurement, checkpoints live in per-tenant namespaces, snapshot
  readback polls events, and rollback and preempt/resume apply per
  campaign.

* **The fleet** (:mod:`.slo`, :mod:`.fleet`) — N service replicas
  behind bucketing, SLO shedding, rendezvous routing, replica-crash
  recovery and rebalancing.

``python -m stencil_tpu_torch.apps.serve`` and ``apps.fleet`` are the
runnable front ends.
"""

from .ensemble import (EnsembleAstaroth, EnsembleHealth, EnsembleJacobi,
                       EnsembleSentinel, configured_domain,
                       domain_fingerprint, make_ensemble_probe)
from .fleet import (REPLICA_STATES, Fleet, RequestShed,
                    TransientDispatchError)
from .queue import (CampaignHandle, CampaignRequest, DeadlineExpired,
                    RequestQueue)
from .service import (CampaignResult, CampaignService, ReplicaCrashed,
                      ServiceStats)
from .slo import (DEFAULT_BUCKETS, SHED_REASONS, BucketError,
                  GridBucketer, SloPolicy, rendezvous_replica)

__all__ = [
    "EnsembleJacobi", "EnsembleAstaroth", "EnsembleSentinel",
    "EnsembleHealth", "make_ensemble_probe", "configured_domain",
    "domain_fingerprint", "CampaignRequest", "CampaignHandle",
    "RequestQueue", "CampaignService", "CampaignResult", "ServiceStats",
    "DeadlineExpired", "ReplicaCrashed",
    "Fleet", "RequestShed", "TransientDispatchError", "REPLICA_STATES",
    "GridBucketer", "SloPolicy", "BucketError", "rendezvous_replica",
    "DEFAULT_BUCKETS", "SHED_REASONS",
]
