"""Admission policy for the serving fleet: shape bucketing, SLO
thresholds, and rendezvous tenant routing.

PyTorch-port counterpart of ``stencil_tpu/serving/slo.py``; the three
policies are pure and the same:

* :class:`GridBucketer` — pads arbitrary user grids UP to a small
  declared bucket set, so the per-replica engine cache is bounded by
  ``len(buckets)`` engines however many distinct grids users ask for.
  The padded request is fingerprinted at the BUCKET shape, so it reuses
  the bucket-shaped engine.

* :class:`SloPolicy` — the declared shed thresholds over the two
  signals the service exports (``stencil_service_queue_depth`` and
  ``stencil_service_admission_latency_seconds``). Requests at or above
  ``protected_priority`` are never shed; lower-priority work is shed
  with a NAMED reason (:data:`SHED_REASONS`) the moment a signal
  crosses its threshold — loudly (a ``request_shed`` event and
  ``stencil_fleet_shed_total``).

* :func:`rendezvous_replica` — highest-random-weight (rendezvous)
  hashing of the admission key over the live replica set, by sha256:
  every client agrees on the owner without coordination, the same keys
  map to the same owners as in the JAX package, and a replica's death
  remaps ONLY the keys it owned.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence, Tuple

Grid = Tuple[int, int, int]

#: grids a default fleet admits at (all divisible by the 2x2x2 test
#: mesh); callers with other meshes declare their own bucket set
DEFAULT_BUCKETS: Tuple[Grid, ...] = ((8, 8, 8), (16, 16, 16),
                                     (24, 24, 24), (32, 32, 32))

#: the named shed reasons — the `reason` label vocabulary of
#: stencil_fleet_shed_total and the request_shed event
SHED_REASONS: Tuple[str, ...] = ("queue_depth", "admission_latency")


class BucketError(ValueError):
    """No declared bucket can hold the requested grid."""


class GridBucketer:
    """Pad user grids up to a declared bucket set.

    A request whose grid fits inside a bucket (every dimension <= the
    bucket's) is admitted AT the smallest such bucket — the campaign
    runs at the bucket resolution, a declared admission contract. A
    grid larger than every bucket is rejected loudly
    (:class:`BucketError`), never silently truncated.
    """

    def __init__(self, buckets: Sequence[Grid] = DEFAULT_BUCKETS) -> None:
        if not buckets:
            raise ValueError("bucket set must not be empty")
        norm = []
        for b in buckets:
            g = tuple(int(v) for v in b)
            if len(g) != 3 or any(v < 1 for v in g):
                raise ValueError(f"bucket {b!r} is not a positive "
                                 f"(z, y, x) grid")
            norm.append(g)
        # smallest-first by volume (ties: lexicographic) so bucket_for
        # picks the cheapest bucket that fits
        self.buckets: Tuple[Grid, ...] = tuple(
            sorted(set(norm), key=lambda g: (g[0] * g[1] * g[2], g)))

    def bucket_for(self, grid: Grid) -> Grid:
        """The smallest declared bucket holding ``grid``."""
        g = tuple(int(v) for v in grid)
        for b in self.buckets:
            if all(gv <= bv for gv, bv in zip(g, b)):
                return b
        raise BucketError(
            f"grid {g} fits no declared bucket {list(self.buckets)} — "
            f"declare a larger bucket or reject the request")

    def apply(self, req):
        """``(request', padded)``: the request admitted at its bucket
        grid (a ``dataclasses.replace`` copy when padding changed the
        grid; the original object otherwise)."""
        bucket = self.bucket_for(req.grid)
        if tuple(req.grid) == bucket:
            return req, False
        return dataclasses.replace(req, grid=bucket), True


@dataclasses.dataclass(frozen=True)
class SloPolicy:
    """Declared shed thresholds over the exported admission signals.

    ``None`` disables a threshold. ``protected_priority`` is the
    admission floor: requests with ``priority >=`` it are NEVER shed
    (the fleet sheds lowest-priority work first, by construction —
    the default protects every default-priority request and sheds
    only work explicitly submitted below it, e.g. a flood at
    priority 0)."""

    max_queue_depth: Optional[int] = 64
    max_admission_latency_seconds: Optional[float] = None
    protected_priority: int = 1

    def shed_reason(self, priority: int, queue_depth: float,
                    admission_latency_seconds: Optional[float]
                    ) -> Optional[str]:
        """The named reason to shed this request, or None to admit."""
        if int(priority) >= self.protected_priority:
            return None
        if (self.max_queue_depth is not None
                and queue_depth >= self.max_queue_depth):
            return "queue_depth"
        if (self.max_admission_latency_seconds is not None
                and admission_latency_seconds is not None
                and admission_latency_seconds
                > self.max_admission_latency_seconds):
            return "admission_latency"
        return None


def rendezvous_replica(key: str, replicas: Sequence[str]) -> str:
    """Highest-random-weight owner of ``key`` among ``replicas``.

    sha256 keeps the weight stable across processes and Python runs
    (no PYTHONHASHSEED dependence) — every fleet member and every
    test agrees on the same owner."""
    if not replicas:
        raise ValueError("no replicas to route to")
    return max(
        replicas,
        key=lambda name: hashlib.sha256(
            f"{key}|{name}".encode()).hexdigest())
