"""The cross-rank flag schedules of ``stencil_tpu_torch.parallel.ipc``, pure.

``b4_schedule`` (B4's sweeps) and ``overlap_a_schedule`` /
``overlap_b_schedule`` (rules (a) and (b) of B7 and B13/B14) say which
counter each card signals and waits for, sweep by sweep and step by
step; on the card ``PeerFlags.run`` carries them out with stream memory
operations. Here every stream's schedule runs in a simulated
interleaving (seeded random choices among the streams that can move): a
signal writes its value, a wait blocks until the counter is at least
its value. Held, for every interleaving: no stream is left blocked,
every launch happens after what must precede it (the data hazards the
flags stand for), and no wait is ever satisfied by an earlier step's
signal. A scheme that re-signals one value every step — what a
cross-process event re-recorded each step amounts to — is caught by the
same check.
"""

import random

import pytest

from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.ops.cuda_mhd_overlap import send_pieces
from stencil_tpu_torch.ops.cuda_overlap import send_targets
from stencil_tpu_torch.parallel import ipc

SEEDS = range(40)


class Sim:
    """Streams of (label, op) programs over shared counters."""

    def __init__(self, programs, strict=True):
        self.strict = strict
        self.programs = {k: list(v) for k, v in programs.items()}
        self.pc = {k: 0 for k in programs}
        self.counter = {}
        self.writer = {}
        self.done = []

    def runnable(self, k):
        if self.pc[k] >= len(self.programs[k]):
            return False
        _, op = self.programs[k][self.pc[k]]
        if op.op != "wait":
            return True
        return self.counter.get((op.card, op.kind, op.slot), 0) >= op.value

    def run(self, seed, on_launch, on_wait):
        rng = random.Random(seed)
        while True:
            ready = [k for k in self.programs if self.runnable(k)]
            if not ready:
                break
            k = rng.choice(ready)
            label, op = self.programs[k][self.pc[k]]
            self.pc[k] += 1
            key = (op.card, op.kind, op.slot)
            if op.op == "signal":
                assert not self.strict or op.value > self.counter.get(
                    key, 0), ("a counter must only grow", k, label, op)
                self.counter[key] = op.value
                self.writer[key] = label
            elif op.op == "wait":
                on_wait(k, label, op, self.writer[key])
            else:
                on_launch(k, label, op)
                self.done.append((k, label))
        stuck = [k for k in self.programs
                 if self.pc[k] < len(self.programs[k])]
        assert not stuck, f"blocked streams {stuck}"


def b4_programs(n_cards, sweeps, exchanges, monotone=True):
    """Every card on a rank of its own; each card's program over
    ``exchanges`` exchanges of ``sweeps`` sweeps, with the values every
    rank's channel ticks in the same order."""
    cards = [(r, "cuda:0") for r in range(n_cards)]
    leads = {c: 2 * r for r, c in enumerate(cards)}
    ticks = [0] * ipc.KINDS
    programs = {c: [] for c in cards}
    for k in range(exchanges):
        ticks[ipc.READY] += 1
        ready = ticks[ipc.READY] if monotone else 1
        swept = []
        for _ in range(sweeps):
            ticks[ipc.SWEPT] += 1
            swept.append(ticks[ipc.SWEPT] if monotone else 1)
        for c in cards:
            own = {**{d: leads[d] for d in cards if d != c}, c: leads[c]}
            # the card's reads of its halos before exchange k (the step
            # after exchange k - 1): a launch-like marker
            programs[c].append((("compute", k), ipc.FlagOp(
                "launch", -1, -1, 0, c)))
            programs[c] += [(("b4", k), op) for op in
                            ipc.b4_schedule(c, own, ready, swept)]
    return cards, programs


def check_b4(cards, programs, sweeps, seed, strict=True):
    sim = Sim(programs, strict)
    # per card: the exchange whose compute ran last, the sweeps launched
    state = {c: {"compute": -1, "launched": {}} for c in cards}

    def on_launch(c, label, op):
        if label[0] == "compute":
            k = label[1]
            # the step's compute reads halos every other card wrote in
            # exchange k - 1: all of them must have landed
            if k:
                for d in cards:
                    if d != c:
                        assert state[d]["launched"].get(k - 1, -1) \
                            == sweeps - 1, ("compute before halos", c, k)
            state[c]["compute"] = k
            return
        k, s = label[1], op.slot
        for d in cards:
            if d == c:
                continue
            # d's halos may be written: its compute of step k ran
            assert state[d]["compute"] >= k, ("write before ready", c, k, s)
            if s:
                assert state[d]["launched"].get(k, -1) >= s - 1, (
                    "sweep before the previous one landed", c, k, s)
        state[c]["launched"][k] = s

    def on_wait(c, label, op, writer):
        assert writer[1] >= label[1], (
            "a wait satisfied by an earlier exchange's signal", c, label,
            writer, op)

    sim.run(seed, on_launch, on_wait)


@pytest.mark.parametrize("n_cards,sweeps", [(2, 3), (4, 3), (3, 1)])
def test_b4_schedule_orders_every_sweep(n_cards, sweeps):
    """Three exchanges over 2, 3 or 4 ranks: every interleaving ends,
    a card writes into another's halos only after that card's previous
    readers ran (READY), sweep s + 1 only after every card's sweep s
    (SWEPT), the next compute only after every store of the exchange,
    and every wait is met by a signal of its own exchange or later."""
    for seed in SEEDS:
        cards, programs = b4_programs(n_cards, sweeps, 3)
        check_b4(cards, programs, sweeps, seed)


def test_b4_schedule_shape():
    """Card (0, cuda:0) of two ranks, three sweeps: signal READY, wait
    for the other's READY, then per sweep (waits for the other's
    previous SWEPT,) the launch and SWEPT; last, the wait for the other's
    final SWEPT."""
    me, other = (0, "cuda:0"), (1, "cuda:0")
    ops = ipc.b4_schedule(me, {me: 0, other: 2}, 7, [20, 21, 22])
    got = [(o.op, o.kind, o.slot, o.value, o.card) for o in ops]
    assert got == [
        ("signal", ipc.READY, 0, 7, other), ("wait", ipc.READY, 2, 7, me),
        ("launch", -1, 0, 0, me), ("signal", ipc.SWEPT, 0, 20, other),
        ("wait", ipc.SWEPT, 2, 20, me), ("launch", -1, 1, 0, me),
        ("signal", ipc.SWEPT, 0, 21, other),
        ("wait", ipc.SWEPT, 2, 21, me), ("launch", -1, 2, 0, me),
        ("signal", ipc.SWEPT, 0, 22, other),
        ("wait", ipc.SWEPT, 2, 22, me)]


def test_b4_schedule_with_one_value_a_step_is_caught():
    """Re-signalling value 1 every exchange (an event re-recorded each
    step, unordered by the host) lets a wait pass on the previous
    exchange's signal: the check finds it in some interleaving."""
    caught = 0
    for seed in SEEDS:
        cards, programs = b4_programs(2, 3, 3, monotone=False)
        try:
            check_b4(cards, programs, 3, seed, strict=False)
        except AssertionError:
            caught += 1
    assert caught > 0


def overlap_programs(counts, targets_of, ranks, steps, monotone=True):
    """Every position's stream over ``steps`` steps of launch A then
    launch B, with the values a ``ShardOrdering`` computes (its
    ``begin_a``/``begin_b`` ticks); relations between positions of one
    rank are left to events (not simulated)."""
    n = counts.flatten()
    cards = {i: (ranks[i], "cuda:0") for i in range(n)}
    targets = [sorted(set(targets_of(i))) for i in range(n)]
    sources = [sorted({i for i in range(n) if j in targets[i]})
               for j in range(n)]
    programs = {i: [] for i in range(n)}
    ticks = [0] * ipc.KINDS
    b_value = 0
    for t in range(steps):
        read_before = b_value
        ticks[ipc.SENT] += 1
        sent = ticks[ipc.SENT] if monotone else 1
        ticks[ipc.READ] += 1
        b_value = ticks[ipc.READ] if monotone else 1
        for i in range(n):
            remote = {j: cards[j] for j in range(n) if ranks[j] != ranks[i]}
            programs[i] += [(("A", t), op) for op in ipc.overlap_a_schedule(
                i, targets[i], remote, cards[i], sent, read_before)]
        for j in range(n):
            remote = {i: cards[i] for i in range(n) if ranks[i] != ranks[j]}
            programs[j] += [(("B", t), op) for op in ipc.overlap_b_schedule(
                j, sources[j], remote, cards[j], sent, b_value)]
    return targets, sources, programs


def check_overlap(targets, sources, programs, ranks, seed, strict=True):
    n = len(targets)
    a_done = {i: -1 for i in range(n)}
    b_done = {i: -1 for i in range(n)}

    def on_launch(k, label, op):
        phase, t = label
        if phase == "A":
            # rule (a): every remote target has read its buffers of t - 1
            for j in targets[k]:
                if ranks[j] != ranks[k]:
                    assert b_done[j] >= t - 1, ("rule (a)", k, j, t)
            a_done[k] = t
        else:
            # rule (b): every remote source has stored this step's rows
            for i in sources[k]:
                if ranks[i] != ranks[k]:
                    assert a_done[i] >= t, ("rule (b)", k, i, t)
            b_done[k] = t

    def on_wait(k, label, op, writer):
        assert writer[1] >= label[1] - (1 if op.kind == ipc.READ else 0), (
            "a wait satisfied by an earlier step's signal", k, label,
            writer, op)

    Sim(programs, strict).run(seed, on_launch, on_wait)


MESHES = [Dim3(1, 2, 2), Dim3(1, 3, 4), Dim3(1, 1, 4)]


@pytest.mark.parametrize("counts", MESHES, ids=str)
@pytest.mark.parametrize("kernel", ["b7", "b13"])
@pytest.mark.parametrize("grouping", ["own", "halves"])
def test_overlap_schedule_keeps_rules_a_and_b(counts, kernel, grouping):
    """Four steps of B7's (face neighbours) or B13's (faces and
    diagonals) sends over meshes whose every position is its own rank,
    or over two ranks holding the halves: every interleaving ends, rule
    (a) and rule (b) hold between every pair of positions on two ranks,
    and every wait is met by its own step's signal (READ: the previous
    step's) or a later one."""
    n = counts.flatten()
    ranks = (list(range(n)) if grouping == "own"
             else [0] * (n // 2) + [1] * (n - n // 2))
    if kernel == "b7":
        def targets_of(i):
            return send_targets(i, counts).values()
    else:
        def targets_of(i):
            return [j for _, j, _ in send_pieces(i, counts, 8, 8, 3)]
    for seed in SEEDS:
        targets, sources, programs = overlap_programs(counts, targets_of,
                                                      ranks, 4)
        check_overlap(targets, sources, programs, ranks, seed)


def test_overlap_schedule_with_one_value_a_step_is_caught():
    counts = Dim3(1, 2, 2)
    caught = 0
    for seed in SEEDS:
        targets, sources, programs = overlap_programs(
            counts, lambda i: send_targets(i, counts).values(),
            list(range(4)), 4, monotone=False)
        try:
            check_overlap(targets, sources, programs, list(range(4)), seed,
                          strict=False)
        except AssertionError:
            caught += 1
    assert caught > 0


def test_overlap_a_schedule_signals_each_remote_card_once():
    """Two remote targets on one card get one SENT; the first A phase of
    an ordering waits for no READ."""
    remote = {2: (1, "cuda:0"), 3: (1, "cuda:0")}
    ops = ipc.overlap_a_schedule(0, [0, 1, 2, 3], remote, (0, "cuda:0"), 5,
                                 0)
    assert [(o.op, o.kind, o.slot, o.value, o.card) for o in ops] == [
        ("launch", -1, 0, 0, (0, "cuda:0")),
        ("signal", ipc.SENT, 0, 5, (1, "cuda:0"))]
    ops = ipc.overlap_b_schedule(1, [0, 2, 3], remote, (0, "cuda:0"), 5, 9)
    assert [(o.op, o.slot, o.value) for o in ops] == [
        ("wait", 2, 5), ("wait", 3, 5), ("launch", 1, 0), ("signal", 1, 9)]
