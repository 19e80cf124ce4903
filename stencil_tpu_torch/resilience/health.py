"""Health probe and sentinel: divergence detection kept on the device.

PyTorch-port counterpart of ``stencil_tpu/resilience/health.py`` (the
probe and the sentinel, which the recovery driver ``driver.py`` runs):

* per quantity, two scalars are reduced on the shard's device — the
  count of non-finite cells and the max |finite| value — stacked into
  one small ``(2, n_quantities)`` float32 vector (``probe_shard``);
* the whole mesh reduces those vectors with ONE max: an ``amax`` of the
  stacked per-shard vectors on the first shard's device in one process,
  and one ``torch.distributed.all_reduce(op=MAX)`` across ranks, as
  JAX's single ``pmax`` (``probe_mesh``). "Any shard saw a non-finite
  cell" is ``max(per-shard counts) > 0``;
* readback is asynchronous: ``probe()`` queues the reduction and a
  non-blocking copy into pinned host memory followed by a CUDA event;
  ``poll()`` harvests the entries whose event has completed
  (``Event.query()``, JAX's ``is_ready``) and never blocks unless asked
  (``poll(block=True)``).

The probe reads the PADDED fields (halos included): a corrupted halo
trips the sentinel even when the next exchange would overwrite it.

The divergence predicate (on the host, on harvested stats): non-finite
count > 0, or max-abs growth by more than ``growth_factor`` over a
sliding window of recent healthy probes.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

#: rows of the probe vector
ROW_NONFINITE = 0
ROW_MAX_ABS = 1

#: an extra probe column: one value per mesh position (None at other
#: ranks' positions) or one replicated value
ExtraColumn = Union[float, Sequence[Optional[torch.Tensor]]]


def probe_shard(fields: Dict[str, torch.Tensor],
                extra: Optional[Dict[str, Union[float, torch.Tensor]]]
                = None) -> torch.Tensor:
    """One shard's health stats: a ``(2, n)`` float32 vector on the
    shard's device — row 0 the non-finite cell count, row 1 the max
    |finite| value — in the dict's quantity order. A tensor of more than
    three dimensions is reduced over its last three: a batched
    ``(N, Z, Y, X)``
    ensemble shard gives one ``(N, 2, n)`` row a member (JAX's
    ``make_ensemble_probe``, a vmapped ``probe_shard``). ``extra``: named
    scalar columns appended after the quantities (the value in BOTH
    rows), e.g. telemetry step metrics or PIC's overflow count, so that
    they ride the same reduction. The whole-mesh max is
    ``probe_mesh``'s (JAX's ``probe_shard`` includes its ``pmax``)."""
    cols = []
    dev = None
    for p in fields.values():
        dev = p.device
        # a tensor of up to three dimensions (a field, a particle lane)
        # reduces whole; a batched one per leading index
        cells = (-3, -2, -1) if p.dim() > 3 else tuple(range(p.dim()))
        nonfinite = (~torch.isfinite(p)).sum(cells).to(torch.float32)
        # |p| with every non-finite cell set to 0: JAX's
        # where(isfinite(p), abs(p), 0) in one temporary
        mag = p.abs().nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)
        cols.append(torch.stack([nonfinite,
                                 mag.amax(cells).to(torch.float32)], -1))
    for v in (extra or {}).values():
        v = (v.to(dev, torch.float32).reshape(())
             if isinstance(v, torch.Tensor)
             else torch.full((), float(v), dtype=torch.float32, device=dev))
        cols.append(torch.stack([v, v]).expand(cols[0].shape))
    return torch.stack(cols, dim=-1)


def probe_mesh(fields: Dict[str, Sequence[Optional[torch.Tensor]]],
               mesh=None,
               extra: Optional[Dict[str, ExtraColumn]] = None
               ) -> torch.Tensor:
    """The ``(2, n + len(extra))`` whole-mesh probe vector (``(N, 2,
    n)`` for batched ensemble shards):
    ``probe_shard`` on every shard this process holds (``fields[q]``:
    one padded tensor per mesh position, None at other ranks'), the
    elementwise max of those vectors (one ``amax`` of their stack, on
    the first one's device) and, on a mesh that spans processes, ONE
    ``all_reduce(op=MAX)`` over the process group (under gloo a CUDA
    vector crosses through host memory, which waits for the card)."""
    names = list(fields)
    vecs = []
    for i, first in enumerate(fields[names[0]]):
        if first is None:
            continue
        ex = {m: (v[i] if isinstance(v, (list, tuple)) else v)
              for m, v in (extra or {}).items()}
        vecs.append(probe_shard({q: fields[q][i] for q in names}, ex))
    dev = vecs[0].device
    out = (vecs[0] if len(vecs) == 1 else
           torch.stack([v.to(dev) for v in vecs]).amax(dim=0))
    if mesh is not None and mesh.spans_ranks:
        import torch.distributed as dist

        from ..parallel.multihost import backend

        staged = out.is_cuda and backend() == "gloo"
        buf = out.cpu() if staged else out
        dist.all_reduce(buf, op=dist.ReduceOp.MAX)
        out = buf.to(dev) if staged else buf
    return out


def make_probe(mesh, names: Sequence[str],
               extra_names: Sequence[str] = ()):
    """The whole-mesh probe: ``fn(fields) -> (2, len(names))`` float32
    stats of the named quantities (order pinned by ``names``) over the
    shard lists of ``fields``. With ``extra_names`` it is ``fn(fields,
    metrics_vec)``: ``metrics_vec`` holds one host float per extra name
    (e.g. ``StepMetrics.host_values``), replicated on every shard and
    riding the same reduction."""
    names = list(names)
    extras = list(extra_names)

    if extras:
        def fn_m(fields, vec):
            return probe_mesh({q: fields[q] for q in names}, mesh,
                              dict(zip(extras, (float(v) for v in vec))))
        return fn_m

    def fn(fields):
        return probe_mesh({q: fields[q] for q in names}, mesh)
    return fn


@dataclasses.dataclass
class HealthStats:
    """One harvested probe result plus the divergence verdict.

    ``metrics`` holds any extra columns that rode the probe (empty on
    plain probes)."""

    step: int
    nonfinite: Dict[str, int]
    max_abs: Dict[str, float]
    tripped: bool = False
    reason: str = ""
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_record(self) -> Dict:
        rec = {"step": self.step, "nonfinite": dict(self.nonfinite),
               "max_abs": dict(self.max_abs), "tripped": self.tripped,
               "reason": self.reason}
        if self.metrics:
            rec["metrics"] = dict(self.metrics)
        return rec


@dataclasses.dataclass
class _Pending:
    """A queued probe: its step (a tuple of steps for a segment trace),
    the host copy and the event recorded after that copy (None on the
    CPU, where the copy is the tensor itself)."""

    step: Union[int, Tuple[int, ...]]
    host: torch.Tensor
    event: Optional[torch.cuda.Event]


def _to_host(step, arr: torch.Tensor) -> _Pending:
    """Queue ``arr``'s copy into pinned host memory on its device's
    current stream, and an event after it."""
    if not arr.is_cuda:
        return _Pending(step, arr, None)
    host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
    stream = torch.cuda.current_stream(arr.device)
    with torch.cuda.stream(stream):
        host.copy_(arr, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(stream)
    return _Pending(step, host, ev)


class HealthSentinel:
    """The step loop's watchdog over a realized ``DistributedDomain``.

    ``probe(fields, step)`` queues the reduction and its copy to the
    host (returns at once); ``poll()`` harvests ready results and
    evaluates the divergence predicate; :attr:`tripped` holds the first
    unhealthy result until :meth:`reset`."""

    def __init__(self, dd, window: int = 8,
                 growth_factor: float = 1e6, metrics=None,
                 probe_fn=None, names: Optional[Sequence[str]] = None,
                 extra_names: Optional[Sequence[str]] = None) -> None:
        self.names = list(names) if names is not None else list(dd._names)
        self.window = int(window)
        self.growth_factor = float(growth_factor)
        #: telemetry step-metrics provider (``.names`` + ``.values(step)``),
        #: e.g. ``telemetry.probe.StepMetrics``: its counters ride the
        #: probe's one reduction
        self._metrics = metrics
        #: custom probe ``probe_fn(fields, step) -> (2, n + k)`` (models
        #: with non-field state, as PIC's particle lanes and its overflow
        #: column); ``extra_names`` labels the k trailing columns, which
        #: :meth:`poll` decodes into ``HealthStats.metrics``
        self._custom_probe = probe_fn
        if probe_fn is not None:
            if metrics is not None:
                raise ValueError("pass either metrics= (host-side "
                                 "columns) or probe_fn= (in-graph "
                                 "columns), not both")
            self._probe_fn = probe_fn
            self._extra_names = tuple(extra_names or ())
        else:
            self._extra_names = (tuple(metrics.names)
                                 if metrics is not None else ())
            self._probe_fn = make_probe(dd.mesh, self.names,
                                        extra_names=self._extra_names)
        self._pending: Deque[_Pending] = deque()
        self._history: Dict[str, Deque[float]] = {
            q: deque(maxlen=self.window) for q in self.names}
        self._tripped: Optional[HealthStats] = None

    # -- dispatch side --------------------------------------------------
    def probe(self, fields: Dict[str, Sequence[torch.Tensor]],
              step: int) -> None:
        """Queue one health probe of ``fields`` (``{q: shards}``) at
        ``step`` (does not block)."""
        if self._custom_probe is not None:
            arr = self._custom_probe(dict(fields), step)
        elif self._metrics is not None:
            arr = self._probe_fn(dict(fields),
                                 self._metrics.host_values(step))
        else:
            arr = self._probe_fn(dict(fields))
        self._pending.append(_to_host(step, arr))

    def observe_segment(self, trace, steps: Sequence[int]) -> None:
        """Queue a segment's probe trace (``parallel/megastep.py``;
        ``trace`` a ``SegmentTrace`` or its ``array``): one row per
        entry of ``steps`` (campaign steps, oldest first). ``poll``
        expands the rows, oldest first, through the same divergence
        predicate, so the exact tripped step inside the segment is
        known without replaying it."""
        self._pending.append(_to_host(tuple(int(s) for s in steps),
                                      getattr(trace, "array", trace)))

    def has_pending(self, step: int) -> bool:
        """True when a probe of ``step`` is already queued, alone or as
        a row of a segment trace."""
        for e in self._pending:
            if step in (e.step if isinstance(e.step, tuple) else (e.step,)):
                return True
        return False

    # -- harvest side ---------------------------------------------------
    def poll(self, block: bool = False) -> List[HealthStats]:
        """Harvest completed probes (all of them when ``block``), oldest
        first, evaluating the divergence predicate on each; segment
        traces expand into one result per row."""
        out: List[HealthStats] = []
        while self._pending:
            e = self._pending[0]
            if e.event is not None:
                if not block and not e.event.query():
                    break
                e.event.synchronize()
            self._pending.popleft()
            host = e.host.numpy()
            if isinstance(e.step, tuple):
                for j, s in enumerate(e.step):
                    out.append(self._evaluate(s, host[j]))
            else:
                out.append(self._evaluate(e.step, host))
        return out

    @property
    def tripped(self) -> Optional[HealthStats]:
        """The first unhealthy probe since the last :meth:`reset`."""
        return self._tripped

    def reset(self) -> None:
        """Forget pending probes, history and the tripped verdict (the
        state was rolled back)."""
        self._pending.clear()
        for h in self._history.values():
            h.clear()
        self._tripped = None

    # -- predicate ------------------------------------------------------
    def _evaluate(self, step: int, host: np.ndarray) -> HealthStats:
        nonfinite = {q: int(host[ROW_NONFINITE, i])
                     for i, q in enumerate(self.names)}
        max_abs = {q: float(host[ROW_MAX_ABS, i])
                   for i, q in enumerate(self.names)}
        stats = HealthStats(step, nonfinite, max_abs)
        if self._extra_names:
            n = len(self.names)
            stats.metrics = {m: float(host[ROW_NONFINITE, n + i])
                             for i, m in enumerate(self._extra_names)}
        bad_nf = [q for q, n in nonfinite.items() if n > 0]
        if bad_nf:
            stats.tripped = True
            stats.reason = (f"non-finite cells in {bad_nf} "
                            f"({ {q: nonfinite[q] for q in bad_nf} })")
        else:
            grown = []
            for q in self.names:
                hist = self._history[q]
                if hist:
                    baseline = min(hist)
                    if baseline > 0 and \
                            max_abs[q] > self.growth_factor * baseline:
                        grown.append(q)
            if grown:
                stats.tripped = True
                stats.reason = (f"max-abs grew more than "
                                f"x{self.growth_factor:g} over the "
                                f"window for {grown}")
            else:
                for q in self.names:
                    self._history[q].append(max_abs[q])
        if stats.tripped and self._tripped is None:
            self._tripped = stats
        return stats
