"""Megastep: a campaign segment of ``k`` steps with the health probe on
the device.

PyTorch-port counterpart of ``stencil_tpu/parallel/megastep.py``. In
JAX a segment is ONE compiled program; here it is what that program
means, run eagerly on the callers' streams:

* it advances the state ``k`` steps through the SAME per-shard bodies
  (and CUDA kernels) the stepwise run loops use, chunked as the blocked
  loops chunk (``segment_chunks``: whole groups of the path's
  ``stride``, then single steps);
* after a chunk, every ``probe_every`` steps and always at the final
  step, one ``resilience.health`` probe row is reduced on the device
  and stacked into a trace tensor that stays on the card
  (``SegmentTrace.array``), with the telemetry step-metric columns
  (``telemetry/probe.py``) filled from the segment's base values;
* nothing inside a segment reads the device from the host, so the host
  only queues work; ``HealthSentinel.observe_segment`` harvests the
  trace later and names the exact step that tripped.

A model declares what its segment carries by a :class:`CarryContract`
and registers a :class:`SegmentCompiler`; a path that cannot run one
returns a falsy :class:`SegmentDecline` (``decline``), never None.

What the JAX contract also carries and the port has no counterpart for
until its CUDA-graph capture: PartitionSpecs, buffer donation (the
state is advanced in place or adopted), the precision certifier's
compute dtype and wire formats, and ``Segment.fn`` (the jitted program;
None here).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..resilience.health import probe_mesh
from ..telemetry.probe import STEP_METRIC_NAMES

#: the longest segment JAX unrolls into one program; the drivers cut
#: longer spans into several segments
MAX_UNROLL = 64


@dataclasses.dataclass(frozen=True)
class CarryContract:
    """A model's declaration of what its segment carries.

    * ``probe_view(state) -> {name: [shard, ...]}`` — the quantities the
      health probe reduces, one tensor per mesh position (None at other
      ranks' positions), padded;
    * ``probe_extra(state) -> {name: [0-dim tensor, ...]}`` — extra
      probe columns riding the same reduction, one value per mesh
      position (PIC's cumulative migration-overflow count), after any
      metric columns;
    * ``stride`` — the steps one ``advance(state, c, idx)`` call moves
      when ``c`` equals it: a temporal group (``lcm(3, s)/3``
      iterations for Astaroth), or a kernel's in-kernel step count
      (K2/B6 run N steps a launch, so a chunk is one launch). Chunks of
      1 are the single-step tail."""

    probe_view: Callable[[Any], Dict[str, Sequence]]
    probe_extra: Optional[Callable[[Any], Dict[str, Sequence]]] = None
    stride: int = 1


# -- decline-reason vocabulary ----------------------------------------
#: the built path registered no segment builder at all
DECLINE_NO_BUILDER = "no-fused-builder"
#: a remote-write kernel whose schedule certificate is missing or says
#: ``replay_safe=false``
DECLINE_UNCERTIFIED_SCHEDULE = "uncertified-rdma-schedule"
#: the path keeps live state outside the segment carry (Astaroth's
#: interior-resident kernel paths)
DECLINE_INTERIOR_RESIDENT_STATE = "interior-resident-state"
#: the driver was constructed with fuse_segments disabled
DECLINE_POLICY_DISABLED = "policy-disabled"
#: the engine handed the driver no make_segment factory
DECLINE_NO_FACTORY = "no-segment-factory"
#: rebuild() after degradation returned no segment factory
DECLINE_REBUILD_NO_FACTORY = "rebuild-no-segment-factory"

DECLINE_REASONS = frozenset({
    DECLINE_NO_BUILDER, DECLINE_UNCERTIFIED_SCHEDULE,
    DECLINE_INTERIOR_RESIDENT_STATE, DECLINE_POLICY_DISABLED,
    DECLINE_NO_FACTORY, DECLINE_REBUILD_NO_FACTORY,
})


class SegmentDecline:
    """A falsy ``make_segment`` result that says why no segment exists
    for the built path: ``code`` one of the ``DECLINE_*`` vocabulary,
    ``reason`` the prose."""

    def __init__(self, model: str, path: str, reason: str,
                 code: str = DECLINE_NO_BUILDER) -> None:
        self.model = str(model)
        self.path = str(path)
        self.reason = str(reason)
        self.code = str(code)

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        return (f"SegmentDecline({self.model}[{self.path}] "
                f"[{self.code}]: {self.reason})")


_DECLINES_WARNED: set = set()


def decline(model: str, path: str, reason: str,
            code: str = DECLINE_NO_BUILDER) -> SegmentDecline:
    """Record a decline loudly (one warning per (model, path, reason))
    and return the falsy :class:`SegmentDecline`. ``code`` must come
    from ``DECLINE_REASONS``."""
    from ..utils.logging import LOG_WARN

    if code not in DECLINE_REASONS:
        raise ValueError(
            f"unknown decline code {code!r}; the vocabulary is "
            f"{sorted(DECLINE_REASONS)} (parallel/megastep.py)")
    key = (model, path, reason)
    if key not in _DECLINES_WARNED:
        _DECLINES_WARNED.add(key)
        LOG_WARN(f"{model}[{path}] declines megastep fusion "
                 f"[{code}]: {reason} — campaigns on this path run "
                 f"stepwise")
    return SegmentDecline(model, path, reason, code)


def certificate_gate(certificate) -> Optional[str]:
    """None when a schedule ``certificate`` licenses running a remote-
    write kernel's launches back to back inside a segment
    (``replay_safe``), else the decline reason citing it (code
    :data:`DECLINE_UNCERTIFIED_SCHEDULE`)."""
    if certificate is not None and getattr(certificate, "replay_safe",
                                           False):
        return None
    if certificate is None:
        return ("uncertified RDMA schedule: no schedule certificate "
                "for this kernel")
    cited = "; ".join(getattr(certificate, "reasons", ()) or ()) \
        or "certifier returned no reasons"
    return (f"uncertified RDMA schedule (replay_safe=false over "
            f"replay={getattr(certificate, 'replay', '?')}): {cited}")


def segment_chunks(k: int, stride: int = 1) -> List[int]:
    """The chunk sizes of a ``k``-step segment whose advance moves
    ``stride`` steps a call: whole groups first, then single steps."""
    k = int(k)
    stride = max(int(stride), 1)
    return [stride] * (k // stride) + [1] * (k % stride)


def probe_rel_steps(chunks: Sequence[int], probe_every: int = 1
                    ) -> Tuple[int, ...]:
    """The cumulative step count at each probe row: a row after a chunk
    once ``probe_every`` steps have passed since the last, and always
    after the final chunk."""
    probe_every = max(int(probe_every), 1)
    rel: List[int] = []
    done = last = 0
    total = sum(chunks)
    for c in chunks:
        done += c
        if done - last >= probe_every or done == total:
            rel.append(done)
            last = done
    return tuple(rel)


def health_probe(probe_view: Callable[[Any], dict],
                 base_vec=None,
                 metric_names: Sequence[str] = (),
                 bytes_per_step: float = 0.0,
                 mesh=None,
                 probe_extra: Optional[Callable[[Any], dict]] = None):
    """The segment's probe: ``probe(state, done)`` is one whole-mesh
    ``resilience.health`` probe row over ``probe_view(state)``, with the
    telemetry columns from ``base_vec = [base_substeps,
    base_wire_bytes]`` (row ``done`` carries ``base + done`` substeps
    and ``base + done * bytes_per_step`` wire bytes, in float32 as JAX
    computes them) and then ``probe_extra(state)``'s columns, all on
    the one reduction. The columns are filled on the device from host
    scalars: no copy waits for the card."""
    metric_names = tuple(metric_names)
    for m in metric_names:
        if m not in STEP_METRIC_NAMES:
            raise ValueError(f"unknown megastep metric column {m!r} "
                             f"(have {STEP_METRIC_NAMES})")

    def probe(state, done: int):
        extra: Dict[str, Any] = {}
        if metric_names:
            base = np.asarray(base_vec, dtype=np.float32)
            vals = {"substeps": base[0] + np.float32(done),
                    "wire_bytes": base[1] + np.float32(
                        float(done) * float(bytes_per_step))}
            extra = {m: float(vals[m]) for m in metric_names}
        if probe_extra is not None:
            extra.update(probe_extra(state))
        return probe_mesh(probe_view(state), mesh, extra)

    return probe


def fused_segment_shard(state, advance, probe, chunks: Sequence[int],
                        probe_every: int = 1):
    """The segment body: advance ``state`` through ``chunks``
    (``advance(state, chunk_steps, idx)`` per chunk), with one
    ``probe(state, done)`` row at each :func:`probe_rel_steps` point.
    Returns ``(state, trace)``, ``trace`` the rows stacked along a new
    leading axis, on the probe's device."""
    probe_every = max(int(probe_every), 1)
    rows = []
    done = last = 0
    total = sum(chunks)
    for idx, c in enumerate(chunks):
        state = advance(state, int(c), idx)
        done += int(c)
        if done - last >= probe_every or done == total:
            rows.append(probe(state, done))
            last = done
    return state, torch.stack(rows)


@dataclasses.dataclass
class SegmentTrace:
    """A segment's stacked probe trace, still on the device.

    ``array`` is ``(n_rows, 2, n_cols)``; ``steps`` holds each row's
    step count RELATIVE to the segment's start; readback is the
    consumer's (``HealthSentinel.observe_segment``)."""

    array: Any
    steps: Tuple[int, ...]
    base_step: int = 0

    @property
    def abs_steps(self) -> List[int]:
        return [self.base_step + r for r in self.steps]


class Segment:
    """One campaign segment bound to its owner's state.

    ``run(base_step)`` advances the owner's state by :attr:`steps` steps
    and returns the :class:`SegmentTrace` (on the device, no wait).
    ``fn`` is None: JAX's is the jitted program, which the port gains
    with its CUDA-graph capture."""

    def __init__(self, run_fn: Callable[[int], SegmentTrace],
                 steps: int, probe_steps: Tuple[int, ...],
                 fn: Optional[Callable] = None) -> None:
        self._run = run_fn
        self.steps = int(steps)
        self.probe_steps = tuple(probe_steps)
        self.fn = fn

    def run(self, base_step: int = 0) -> SegmentTrace:
        return self._run(int(base_step))


def metric_base_vec(metrics, base_step: int) -> np.ndarray:
    """The float32 ``[substeps, wire_bytes]`` base of a segment's metric
    columns, on the host: ``metrics.host_values(base_step)``, or zeros
    when no metrics ride."""
    if metrics is not None:
        return metrics.host_values(int(base_step))
    return np.zeros((2,), np.float32)


def make_segment_fn(mesh, advance, probe_view,
                    chunks: Sequence[int], probe_every: int = 1,
                    metric_names: Sequence[str] = (),
                    bytes_per_step: float = 0.0,
                    probe_extra: Optional[Callable] = None,
                    session: Optional[Callable] = None):
    """The segment program: ``fn(state, base_vec) -> (state, trace)``.
    ``advance(state, steps, idx)`` moves the whole mesh's state (the
    shards' exchanges span the mesh); ``probe_view(state) -> {name:
    shards}``; ``probe_extra`` as in :class:`CarryContract`;
    ``session()``, when given, is a context manager the chunks run in
    (B7's stream ordering, ``OverlapRecv.session``)."""
    chunks = [int(c) for c in chunks]

    def fn(state, vec):
        probe = health_probe(probe_view, base_vec=vec,
                             metric_names=metric_names,
                             bytes_per_step=bytes_per_step, mesh=mesh,
                             probe_extra=probe_extra)
        with (session() if session is not None
              else contextlib.nullcontext()):
            return fused_segment_shard(state, advance, probe, chunks,
                                       probe_every)

    return fn


def make_carry_segment_fn(mesh, contract: CarryContract, advance,
                          chunks: Sequence[int], probe_every: int = 1,
                          metric_names: Sequence[str] = (),
                          bytes_per_step: float = 0.0,
                          session: Optional[Callable] = None):
    """:func:`make_segment_fn` driven by a :class:`CarryContract`."""
    return make_segment_fn(mesh, advance, contract.probe_view, chunks,
                           probe_every=probe_every,
                           metric_names=metric_names,
                           bytes_per_step=bytes_per_step,
                           probe_extra=contract.probe_extra,
                           session=session)


class SegmentCompiler:
    """A model's segment factory: bind a :class:`CarryContract`, the
    model's ``advance(state, c, idx)`` (``c`` the contract's stride for
    a whole group or in-kernel chunk, 1 for a tail step), ``state_fn()``
    (the live carry) and ``adopt(out)`` (install the result) once; every
    ``(check_every, probe_every, metrics)`` request then makes a
    :class:`Segment` through the same machinery, the program cached per
    ``(k, probe_every, bytes_per_step)``. ``use_metrics=False`` drops the
    telemetry columns (models whose sentinel decodes columns of its own,
    as PIC's overflow). ``session`` as in :func:`make_segment_fn`."""

    def __init__(self, mesh, contract: CarryContract, advance,
                 state_fn: Callable[[], Any],
                 adopt: Callable[[Any], None],
                 use_metrics: bool = True,
                 session: Optional[Callable] = None) -> None:
        self.mesh = mesh
        self.contract = contract
        self._advance = advance
        self._state_fn = state_fn
        self._adopt = adopt
        self._use_metrics = bool(use_metrics)
        self._session = session
        self._cache: Dict = {}

    def __call__(self, check_every: int, probe_every: int = 1,
                 metrics=None) -> Segment:
        k = int(check_every)
        if k < 1:
            raise ValueError(f"check_every must be >= 1, got "
                             f"{check_every}")
        probe_every = max(int(probe_every), 1)
        if not self._use_metrics:
            metrics = None
        chunks = segment_chunks(k, self.contract.stride)
        key = (k, probe_every,
               None if metrics is None
               else float(metrics.bytes_per_step))
        fn = self._cache.get(key)
        if fn is None:
            fn = make_carry_segment_fn(
                self.mesh, self.contract, self._advance, chunks,
                probe_every=probe_every,
                metric_names=(metrics.names if metrics is not None
                              else ()),
                bytes_per_step=(metrics.bytes_per_step
                                if metrics is not None else 0.0),
                session=self._session)
            self._cache[key] = fn
        rel = probe_rel_steps(chunks, probe_every)

        def run(base_step: int) -> SegmentTrace:
            out, trace = fn(self._state_fn(),
                            metric_base_vec(metrics, base_step))
            self._adopt(out)
            return SegmentTrace(trace, rel, base_step)

        return Segment(run, k, rel)


def make_domain_segment(dd, shard_step, check_every: int,
                        probe_every: int = 1,
                        metrics=None) -> Segment:
    """A segment over a realized ``DistributedDomain``'s fields:
    ``shard_step(fields) -> fields`` applied ``check_every`` times, with
    the probe over every registered quantity. ``fields`` is the
    domain's ``{name: [padded shard, ...]}`` dict (the whole mesh: an
    exchange spans the shards); the step may update the shards in place
    or return new ones, which become ``dd.curr``. The compiler is cached
    on the domain by the step function."""
    names = list(dd._names)
    cache = getattr(dd, "_segment_compilers", None)
    if cache is None:
        cache = {}
        dd._segment_compilers = cache
    compiler = cache.get(shard_step)
    if compiler is None:
        contract = CarryContract(
            probe_view=lambda fields: {q: fields[q] for q in names})

        def adopt(out):
            dd.curr = dict(out)

        compiler = SegmentCompiler(
            dd.mesh, contract,
            lambda fields, c, i: shard_step(fields),
            lambda: dict(dd.curr), adopt)
        cache[shard_step] = compiler
    return compiler(check_every, probe_every=probe_every,
                    metrics=metrics)
