"""Campaign requests and the admission queue.

PyTorch-port counterpart of ``stencil_tpu/serving/queue.py``. A
:class:`CampaignRequest` describes one tenant's simulation: model,
grid, step budget, per-member physics parameters, and the tenant's
resilience policy knobs. At submit time the request is fingerprinted
with the SAME problem fingerprint the autotuner caches plans under
(:func:`.ensemble.domain_fingerprint`), so "these requests can share an
ensemble engine" and "this request can reuse a cached exchange plan"
are one question with one answer. The port's fingerprint names its own
platform (``"gpu"`` and the card on CUDA devices), so its strings differ
from the JAX package's; the groupings they make are the same.

:class:`RequestQueue` is the admission structure, priority-ordered
with stable FIFO within a priority class: ``pop_batch(width)`` removes
the highest-priority oldest request plus every younger request with
the SAME fingerprint (up to ``width``) — the batch a single ensemble
dispatch serves. Requests with other fingerprints keep their queue
order for later batches. Requests carrying a ``deadline_seconds`` that
has already expired are rejected AT POP (:class:`DeadlineExpired` on
their handle, plus the queue's ``on_expired`` callback — the service
turns it into a ``request_expired`` event) instead of burning a batch
slot on dead work.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


class DeadlineExpired(RuntimeError):
    """The request's deadline passed before admission."""


@dataclasses.dataclass
class CampaignRequest:
    """One tenant's simulation campaign."""

    tenant: str
    campaign: str
    model: str = "jacobi"               # jacobi | astaroth
    grid: Tuple[int, int, int] = (8, 8, 8)
    n_steps: int = 4
    dtype: str = "float32"
    boundary: str = "PERIODIC"
    mesh_shape: Optional[Tuple[int, int, int]] = None
    #: per-member physics parameters (e.g. jacobi hot_temp/cold_temp,
    #: astaroth nu_visc/eta/zeta/cs_sound); unset keys use defaults
    params: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: seeds the member's initial conditions (model-specific)
    init_seed: int = 0
    # -- per-tenant policy knobs (the resilience ladder, per campaign)
    check_every: int = 1        # sentinel probe cadence (member steps)
    ckpt_every: int = 0         # 0 = anchor checkpoint at step 0 only
    snapshot_every: int = 0     # 0 = final snapshot only
    max_retries: int = 2        # rollbacks before the campaign fails
    #: test/chaos hook: poison this member at the given member-step
    #: (None = no injection); fires once
    chaos_nan_step: Optional[int] = None
    # -- SLO knobs (fleet admission; see serving/slo.py)
    #: admission class: higher pops first; stable FIFO within a class.
    #: The fleet sheds work BELOW its policy's protected_priority
    #: under overload. Default 1 = protected under the default policy.
    priority: int = 1
    #: wall-clock admission deadline from submit; an expired request
    #: is rejected at pop with a request_expired event (None = none)
    deadline_seconds: Optional[float] = None

    def validate(self) -> None:
        from ..utils.checkpoint import validate_checkpoint_component
        validate_checkpoint_component(self.tenant, kind="tenant id")
        validate_checkpoint_component(self.campaign, kind="campaign id")
        if self.model not in ("jacobi", "astaroth"):
            raise ValueError(f"unknown model {self.model!r}")
        if int(self.n_steps) < 1:
            raise ValueError(f"n_steps must be >= 1, got {self.n_steps}")
        if int(self.check_every) < 1:
            raise ValueError("check_every must be >= 1")
        if self.deadline_seconds is not None \
                and float(self.deadline_seconds) <= 0:
            raise ValueError(
                f"deadline_seconds must be > 0 when set, got "
                f"{self.deadline_seconds}")


def request_fingerprint(req: CampaignRequest, devices=None) -> str:
    """The problem fingerprint of a request — the admission AND
    plan-cache key (requests sharing it share a compiled executable and
    a tuned exchange plan)."""
    from .ensemble import domain_fingerprint, request_domain

    return domain_fingerprint(request_domain(req, devices))


class CampaignHandle:
    """The submitter's side of a campaign: wait on :meth:`result`."""

    def __init__(self, request: CampaignRequest) -> None:
        self.request = request
        #: set at submit time (the admission/plan-cache key)
        self.fingerprint: Optional[str] = None
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    # -- service side ---------------------------------------------------
    def _resolve(self, result) -> None:
        self._result = result
        self._done.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._done.set()

    # -- client side ----------------------------------------------------
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until the campaign completes (or fails, re-raising its
        error; or ``TimeoutError`` after ``timeout`` seconds)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"campaign {self.request.tenant}/{self.request.campaign}"
                f" not done after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


@dataclasses.dataclass
class _Entry:
    request: CampaignRequest
    handle: CampaignHandle
    fingerprint: str
    seq: int
    #: submit wall time — the service's admission-latency metric
    #: (time from submit to batch start) reads it
    submitted: float = dataclasses.field(default_factory=time.time)


class RequestQueue:
    """Thread-safe priority queue with fingerprint-compatible batch
    admission (stable FIFO within a priority class; back-compat: all
    default-priority requests behave exactly as the old FIFO)."""

    def __init__(self, devices=None,
                 on_expired: Optional[Callable[["_Entry"], None]] = None
                 ) -> None:
        self._devices = devices
        self._entries: List[_Entry] = []
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._seq = 0
        #: called (outside handle resolution) for each entry rejected
        #: at pop with an expired deadline — the service's event hook
        self._on_expired = on_expired

    def submit(self, req: CampaignRequest) -> CampaignHandle:
        req.validate()
        fp = request_fingerprint(req, devices=self._devices)
        handle = CampaignHandle(req)
        handle.fingerprint = fp
        with self._lock:
            self._entries.append(_Entry(req, handle, fp, self._seq))
            self._seq += 1
            self._not_empty.notify_all()
        return handle

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def wait_nonempty(self, timeout: Optional[float] = None) -> bool:
        with self._lock:
            if self._entries:
                return True
            return self._not_empty.wait_for(
                lambda: bool(self._entries), timeout)

    def pop_batch(self, width: int) -> List[_Entry]:
        """The next admission batch: the highest-priority oldest
        request (stable FIFO within a priority class) and every
        younger fingerprint-identical request, up to ``width``
        members. Other fingerprints keep their positions. Entries
        whose deadline already passed are rejected here — their
        handles fail with :class:`DeadlineExpired` and ``on_expired``
        fires per entry — so a batch slot is never spent on work the
        tenant has already given up on."""
        now = time.time()
        with self._lock:
            expired = [e for e in self._entries
                       if e.request.deadline_seconds is not None
                       and now - e.submitted
                       > float(e.request.deadline_seconds)]
            if expired:
                gone = set(map(id, expired))
                self._entries = [e for e in self._entries
                                 if id(e) not in gone]
            if not self._entries:
                batch, head = [], None
            else:
                # priority class first, then submit order — max() is
                # stable in neither direction, so order the key by
                # (priority, -seq) and take the max explicitly
                head = max(self._entries,
                           key=lambda e: (e.request.priority, -e.seq))
                batch = []
                rest: List[_Entry] = []
                for e in sorted(self._entries,
                                key=lambda e: (-e.request.priority,
                                               e.seq)):
                    if e.fingerprint == head.fingerprint \
                            and len(batch) < int(width):
                        batch.append(e)
                    else:
                        rest.append(e)
                rest.sort(key=lambda e: e.seq)  # keep queue order
                self._entries = rest
        for e in expired:
            e.handle._fail(DeadlineExpired(
                f"{e.request.tenant}/{e.request.campaign}: deadline "
                f"{e.request.deadline_seconds}s expired after "
                f"{now - e.submitted:.3f}s in queue"))
            if self._on_expired is not None:
                self._on_expired(e)
        return batch

    def drain_entries(self) -> List[_Entry]:
        """Remove and return EVERY queued entry (queue order) — the
        fleet's reshard primitive when a replica degrades."""
        with self._lock:
            entries, self._entries = self._entries, []
            return entries

    def take(self, tenant: str, campaign: str) -> Optional[_Entry]:
        """Remove and return the queued entry for one campaign (None
        when it is not queued) — the fleet's migration primitive."""
        with self._lock:
            for i, e in enumerate(self._entries):
                if e.request.tenant == tenant \
                        and e.request.campaign == campaign:
                    return self._entries.pop(i)
        return None
