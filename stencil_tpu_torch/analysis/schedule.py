"""Checker 12: the remote-write flag schedules, certified under replay.

PyTorch-port counterpart of ``stencil_tpu/analysis/schedule.py``. JAX
extracts each Pallas kernel's semaphore schedule from its jaxpr; the
port's remote-write kernels (B4, B7, B13/B14) are ordered by schedules
it writes out itself: device-side counters between cards of two ranks
(``parallel/ipc.py`` ``b4_schedule``, ``overlap_a_schedule``,
``overlap_b_schedule``) and, between the positions one rank drives,
CUDA events (``ops/cuda_overlap.ShardOrdering``: launch A waits for its
targets' last launch B, launch B for its sources' launch A), both as the
pure schedules ``ordering_a_schedule`` / ``ordering_b_schedule`` that
``ShardOrdering`` carries out. Here an event is a counter too: recorded
in phase t it holds t + 1, and a wait asks for the phase the host order
gives it.

A schedule is a program a stream: (label, ``ipc.FlagOp``, what the step
reads, what it writes), a launch's buffers as (buffer, phase). The
schedule replayed ``replay`` times (k steps or exchanges) runs in many
interleavings of the streams (seeded random choices among the streams
that can move: a wait blocks until its counter is at least its value),
and JAX's three conditions are checked on every one:

* (a) no counter is re-armed in flight: every signal raises its counter
  (a repeated value would let a later wait pass on an earlier phase's
  signal), and no launch writes a buffer of phase p before every reader
  of its phase p - 1 ran (a store landing on data still being read);
* (b) no wait deadlocks (every interleaving ends), and no flag signal is
  left over at a replay boundary (each is awaited at its value);
* (c) no launch reads a buffer of phase p before every writer of phase p
  ran (a read of a receive buffer before its SENT wait).

``max_in_flight`` is the most remote stores (a launch's write into a
buffer another stream reads) issued and not yet read, over the
interleavings run. Each target pins its value (JAX's
``SCHEDULE_EXPECT``), so that a change of the schedule's shape fails the
checker instead of certifying anew.
"""

from __future__ import annotations

import dataclasses
import random
from typing import (Callable, Dict, Hashable, List, Optional, Sequence,
                    Tuple)

from ..geometry import Dim3
from .report import Finding

#: replays certified by default (JAX ``DEFAULT_REPLAY``)
DEFAULT_REPLAY = 4
#: interleavings run a certificate
DEFAULT_SEEDS = 24



@dataclasses.dataclass
class ScheduleCertificate:
    """JAX's certificate fields: ``replay_safe`` iff conditions (a), (b)
    and (c) hold in every interleaving run; ``reasons`` name each
    violation; ``max_in_flight`` as the module says."""

    kernel: str
    replay: int
    max_in_flight: int
    replay_safe: bool
    reasons: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {"kernel": self.kernel, "replay": self.replay,
                "max_in_flight": self.max_in_flight,
                "replay_safe": self.replay_safe,
                "reasons": list(self.reasons)}


@dataclasses.dataclass(frozen=True)
class Step:
    """One step of a stream's program: the ``ipc.FlagOp``, and for a
    launch the (buffer, phase) pairs it reads and writes. ``label[-1]``
    is the replay (step or exchange) the step belongs to."""
    label: Tuple
    op: object
    reads: Tuple = ()
    writes: Tuple = ()

    @property
    def replay(self) -> int:
        return self.label[-1]


Programs = Dict[Hashable, List[Step]]


@dataclasses.dataclass
class ScheduleSpec:
    """A schedule to certify: ``programs(replay)`` gives every stream's
    program over ``replay`` steps; ``expect_remote`` guards against a
    vacuous pass (the schedule must store into another stream's
    buffers); ``expect_max_in_flight`` pins the pressure;
    ``fused_by_megastep`` marks a schedule whose certificate a segment
    builder consumes."""
    kernel: str
    programs: Callable[[int], Programs]
    replay: int = DEFAULT_REPLAY
    expect_remote: bool = True
    expect_max_in_flight: Optional[int] = None
    fused_by_megastep: bool = False
    seeds: int = DEFAULT_SEEDS


@dataclasses.dataclass
class ScheduleTarget:
    name: str
    build: Callable[[], ScheduleSpec]

    checker = "schedule"


def _key(op) -> Tuple:
    return (op.card, op.kind, op.slot)


def _is_flag(op) -> bool:
    from ..ops.cuda_overlap import EV_READ, EV_SENT

    return op.kind not in (EV_SENT, EV_READ)


def _simulate(programs: Programs, seed: int) -> Tuple[int, List[str]]:
    """One interleaving: (the most stores in flight, the violations)."""
    rng = random.Random(seed)
    pc = {k: 0 for k in programs}
    counter: Dict[Tuple, int] = {}
    writers: Dict[Tuple, set] = {}
    readers: Dict[Tuple, set] = {}
    for k, prog in programs.items():
        for n, st in enumerate(prog):
            for b in st.writes:
                writers.setdefault(b, set()).add((k, n))
            for b in st.reads:
                readers.setdefault(b, set()).add((k, n))
    done: set = set()
    in_flight: set = set()
    peak = 0
    reasons: List[str] = []

    def runnable(k) -> bool:
        if pc[k] >= len(programs[k]):
            return False
        op = programs[k][pc[k]].op
        return op.op != "wait" or counter.get(_key(op), 0) >= op.value

    while True:
        ready = [k for k in programs if runnable(k)]
        if not ready:
            break
        k = rng.choice(ready)
        n = pc[k]
        st = programs[k][n]
        pc[k] += 1
        op = st.op
        if op.op == "signal":
            if op.value <= counter.get(_key(op), 0):
                reasons.append(
                    f"(a) counter {_key(op)} re-armed at {op.value} while "
                    f"it holds {counter.get(_key(op), 0)} ({st.label}): a "
                    f"later wait can pass on an earlier phase's signal")
            counter[_key(op)] = max(op.value, counter.get(_key(op), 0))
            continue
        if op.op != "launch":
            continue
        for buf, phase in st.reads:
            late = [w for w in writers.get((buf, phase), ())
                    if w not in done and w[0] != k]
            if late:
                reasons.append(
                    f"(c) {st.label} reads {buf} of phase {phase} before "
                    f"its writer {programs[late[0][0]][late[0][1]].label}")
        for buf, phase in st.writes:
            late = [r for r in readers.get((buf, phase - 1), ())
                    if r not in done and r[0] != k]
            if late:
                reasons.append(
                    f"(a) {st.label} stores into {buf} of phase {phase} "
                    f"while {programs[late[0][0]][late[0][1]].label} still "
                    f"reads phase {phase - 1}")
        done.add((k, n))
        for buf, phase in st.writes:
            if any(r[0] != k for r in readers.get((buf, phase), ())):
                in_flight.add((k, n, buf, phase))
        in_flight = {w for w in in_flight
                     if not all(r in done or r[0] == w[0]
                                for r in readers.get((w[2], w[3]), ()))}
        peak = max(peak, len(in_flight))
    stuck = [k for k in programs if pc[k] < len(programs[k])]
    if stuck:
        st = programs[stuck[0]][pc[stuck[0]]]
        reasons.append(f"(b) deadlock: {len(stuck)} stream(s) blocked, "
                       f"e.g. {st.label} waiting for "
                       f"{_key(st.op)} >= {st.op.value}")
    return peak, reasons


def leftover_signals(programs: Programs, replay: int) -> List[str]:
    """(b) at the boundary: every flag signal of the first ``replay``
    replays of ``programs`` (which run one replay more, the continuation
    a later run makes) must be awaited at its value; events are
    records, overwritten harmlessly."""
    waits = {(_key(st.op), st.op.value) for prog in programs.values()
             for st in prog if st.op.op == "wait"}
    out = []
    for prog in programs.values():
        for st in prog:
            op = st.op
            if op.op == "signal" and _is_flag(op) and st.replay < replay \
                    and (_key(op), op.value) not in waits:
                out.append(f"(b) signal {_key(op)} = {op.value} "
                           f"({st.label}) is never awaited: it is left "
                           f"over at the replay boundary")
    return out


def certify(spec: ScheduleSpec) -> ScheduleCertificate:
    """The certificate of ``spec``'s schedule replayed ``spec.replay``
    times."""
    programs = spec.programs(spec.replay)
    reasons = leftover_signals(spec.programs(spec.replay + 1), spec.replay)
    peak = 0
    for seed in range(spec.seeds):
        p, r = _simulate(programs, seed)
        peak = max(peak, p)
        reasons.extend(r)
    reasons = sorted(set(reasons))
    return ScheduleCertificate(spec.kernel, spec.replay, peak,
                               not reasons, reasons)


def check_schedule(target: ScheduleTarget):
    try:
        spec = target.build()
    except Exception as e:  # noqa: BLE001
        return [Finding("schedule", target.name,
                        f"target build failed: {type(e).__name__}: {e}")]
    cert = certify(spec)
    findings = [Finding("schedule", target.name, r) for r in cert.reasons]
    remote = any(st.writes for prog in spec.programs(1).values()
                 for st in prog)
    if spec.expect_remote and not remote:
        findings.append(Finding(
            "schedule", target.name,
            "the schedule stores into no other stream's buffer: nothing "
            "was certified"))
    if (spec.expect_max_in_flight is not None
            and cert.max_in_flight != spec.expect_max_in_flight):
        findings.append(Finding(
            "schedule", target.name,
            f"max_in_flight {cert.max_in_flight} != the pinned "
            f"{spec.expect_max_in_flight}: the schedule's shape changed"))
    if spec.fused_by_megastep and not cert.replay_safe:
        findings.append(Finding(
            "schedule", target.name,
            "a schedule the segment builder fuses is not replay-safe"))
    return findings, {"certificate": cert.to_dict(),
                      "fused_by_megastep": spec.fused_by_megastep}


# ---------------------------------------------------------------------------
# the port's schedules as programs
# ---------------------------------------------------------------------------
def b4_programs(counts: Dim3, sweeps: int = 3, exchanges: int = 1
                ) -> Programs:
    """B4 on a mesh of ``counts`` whose every card is a rank of its own:
    per card and exchange, the step's compute (it reads its halos of the
    previous exchange), then ``ipc.b4_schedule``: sweep s stores into
    every other card's halos of sweep s and reads the card's own of
    sweep s - 1 (the edges it forwards)."""
    from ..parallel import ipc

    n = Dim3.of(counts).flatten()
    cards = [(r, "cuda:0") for r in range(n)]
    leads = {c: r for r, c in enumerate(cards)}
    ticks = [0] * ipc.KINDS
    programs: Programs = {c: [] for c in cards}
    for e in range(exchanges):
        ticks[ipc.READY] += 1
        swept = []
        for _ in range(sweeps):
            ticks[ipc.SWEPT] += 1
            swept.append(ticks[ipc.SWEPT])
        for c in cards:
            programs[c].append(Step(
                ("compute", c[0], e), ipc.FlagOp("launch", -1, -1, 0, c),
                reads=tuple((("halo", c, s), e - 1) for s in range(sweeps))
                if e else ()))
            for op in ipc.b4_schedule(c, leads, ticks[ipc.READY], swept):
                if op.op != "launch":
                    programs[c].append(Step(("b4", c[0], e), op))
                    continue
                s = op.slot
                programs[c].append(Step(
                    ("sweep", c[0], s, e), op,
                    reads=((("halo", c, s - 1), e),) if s else (),
                    writes=tuple((("halo", d, s), e) for d in cards
                                 if d != c)))
    return programs


def overlap_programs(n: int, targets_of: Callable[[int], Sequence[int]],
                     ranks: Sequence[int], steps: int) -> Programs:
    """B7's (or B13/B14's) launches A and B on every position over
    ``steps`` steps, as ``ShardOrdering`` orders them: the schedules of
    ``ops/cuda_overlap.ordering_a_schedule`` / ``ordering_b_schedule``
    (the functions ``launch_a`` / ``launch_b`` carry out), with the
    values its ``begin_a`` / ``begin_b`` tick. Launch A of i stores into
    the receive buffers of its targets; launch B of j reads its own."""
    from ..ops import cuda_overlap as co
    from ..parallel import ipc

    cards = {i: (ranks[i], "cuda:0") for i in range(n)}
    targets = [sorted(set(targets_of(i))) for i in range(n)]
    sources = [sorted({i for i in range(n) if j in targets[i]})
               for j in range(n)]
    programs: Programs = {i: [] for i in range(n)}
    ticks = [0] * ipc.KINDS
    b_value = 0
    for t in range(steps):
        read_before = b_value
        ticks[ipc.SENT] += 1
        sent = ticks[ipc.SENT]
        for i in range(n):
            remote = {j: cards[j] for j in range(n) if ranks[j] != ranks[i]}
            for op in co.ordering_a_schedule(i, targets[i], remote, cards[i],
                                             sent, read_before):
                programs[i].append(Step(("A", i, t), op, writes=tuple(
                    (("recv", j), t) for j in targets[i] if j != i)
                    if op.op == "launch" else ()))
        ticks[ipc.READ] += 1
        b_value = ticks[ipc.READ]
        for j in range(n):
            remote = {i: cards[i] for i in range(n) if ranks[i] != ranks[j]}
            for op in co.ordering_b_schedule(j, sources[j], remote, cards[j],
                                             sent, b_value):
                programs[j].append(Step(
                    ("B", j, t), op,
                    reads=((("recv", j), t),) if op.op == "launch" else ()))
    return programs


def local_programs(n: int, steps: int) -> Programs:
    """A kernel that stores into no other position (B5: its slabs landed
    before it, on its own stream): one launch a position and step."""
    from ..parallel import ipc

    return {i: [Step(("B5", i, t), ipc.FlagOp("launch", -1, i, 0, i))
                for t in range(steps)] for i in range(n)}


def b7_targets(counts: Dim3) -> Callable[[int], List[int]]:
    from ..ops.cuda_overlap import send_targets

    return lambda i: list(send_targets(i, counts).values())


def b13_targets(counts: Dim3, hr: int, side: int = 8
                ) -> Callable[[int], List[int]]:
    from ..ops.cuda_mhd_overlap import send_pieces

    return lambda i: [j for _, j, _ in send_pieces(i, counts, side, side, hr)]


def overlap_spec(kernel: str, counts: Dim3, targets_of,
                 ranks: Optional[Sequence[int]] = None,
                 replay: int = DEFAULT_REPLAY,
                 expect_max_in_flight: Optional[int] = None,
                 fused_by_megastep: bool = False) -> ScheduleSpec:
    """The schedule of an overlap kernel on ``counts`` with the positions'
    owner ``ranks`` (None: one process, every relation an event)."""
    n = Dim3.of(counts).flatten()
    rk = list(ranks) if ranks is not None else [0] * n
    return ScheduleSpec(
        kernel, lambda k: overlap_programs(n, targets_of, rk, k),
        replay=replay, expect_max_in_flight=expect_max_in_flight,
        fused_by_megastep=fused_by_megastep)


#: the B7 certificates the Jacobi ``overlap`` segment asked for, keyed by
#: the mesh, the ranks and the certifier (a monkeypatched certifier is
#: never shadowed by a cached verdict); JAX ``_OVERLAP_CERT_MEMO``
_OVERLAP_CERT_MEMO: Dict[Tuple, ScheduleCertificate] = {}


def overlap_certificate(counts: Dim3, ranks: Optional[Sequence[int]] = None,
                        replay: int = DEFAULT_REPLAY) -> ScheduleCertificate:
    """B7's certificate on a mesh of ``counts`` whose positions ``ranks``
    own (None: one process), memoized."""
    key = (tuple(Dim3.of(counts)), None if ranks is None else tuple(ranks),
           replay, id(certify))
    cert = _OVERLAP_CERT_MEMO.get(key)
    if cert is None:
        cert = certify(overlap_spec("ops.cuda_overlap.jacobi7_overlap_cuda",
                                    Dim3.of(counts), b7_targets(
                                        Dim3.of(counts)), ranks, replay))
        _OVERLAP_CERT_MEMO[key] = cert
    return cert

