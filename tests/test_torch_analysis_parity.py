"""The port's analysis verdicts against JAX's, and the certificate the
Jacobi ``overlap`` segment consumes.

* footprint: for each of JAX's 15 footprint targets, the per-direction
  radius the port's NaN probe finds equals the one JAX's checker derives
  from the jaxpr (``footprint._collect_accesses``, ``required_radius``);
* schedule: ``replay_safe`` of the port's 6 schedule targets equals
  JAX's certificates, and the two targets the segment builder consumes
  (``fused_by_megastep``) are safe; the schedule checker catches a
  schedule whose every flag value repeats, and the event order of
  ``ShardOrdering`` with one wait dropped;
* the ``overlap`` segment is built only with a replay-safe certificate
  (a monkeypatched unsafe certifier makes it decline with
  ``uncertified-rdma-schedule`` and the certificate's reasons), and runs
  bitwise its stepwise twin on the CPU mesh.

JAX's checkers run inside ``torch_port_support.reference_modules`` (jax
0.9 moved the ``jax.core`` names its analysis package reads), on the
fake 8-device CPU mesh of ``tests/conftest.py``.
"""

import numpy as np
import pytest
import torch

from stencil_tpu_torch.analysis import registry
from stencil_tpu_torch.analysis import schedule as sch
from stencil_tpu_torch.analysis.footprint import dir_name, probe_radius
from stencil_tpu_torch.geometry import Dim3
from torch_port_support import reference_modules


@pytest.fixture(scope="module")
def jax_verdicts():
    """JAX's footprint radii (per target, per direction) and schedule
    certificates (per target name)."""
    with reference_modules():
        from stencil_tpu.analysis import footprint as jfp
        from stencil_tpu.analysis import registry as jreg
        from stencil_tpu.analysis import schedule as jsch
        from stencil_tpu.analysis.jaxprs import trace

        radii, certs = {}, {}
        for t in jreg.default_targets():
            if t.checker == "footprint":
                spec = t.build()
                pad_lo, _ = spec.resolved_pads()
                closed = trace(spec.fn, *spec.args)
                roots = {closed.jaxpr.invars[i]
                         for i in spec.padded_argnums}
                acc, issues = [], []
                jfp._collect_accesses(closed.jaxpr, roots, pad_lo,
                                      spec.interior, acc, issues)
                radii[t.name] = {tuple(d): k for d, k in
                                 jfp.required_radius(acc).items()}
            elif t.checker == "schedule":
                _, metrics = jsch.check_schedule(t)
                certs[t.name] = metrics
        return radii, certs


def _port_targets(checker):
    return {t.name: t for t in registry.default_targets(card=False)
            if t.checker == checker}


def test_footprint_radii_equal_jax(jax_verdicts):
    radii, _ = jax_verdicts
    port = _port_targets("footprint")
    assert len(radii) == 15 and set(radii) <= set(port)
    for name, want in radii.items():
        got, _ = probe_radius(port[name].build())
        assert {d: got[d] for d in want} == want, (
            name, {dir_name(d): (got[d], want[d]) for d in want
                   if got[d] != want[d]})


def test_schedule_verdicts_equal_jax(jax_verdicts):
    _, certs = jax_verdicts
    port = _port_targets("schedule")
    assert len(certs) == 6 and set(certs) == set(port)
    fused = 0
    for name, jm in certs.items():
        jcert = jm.get("certificate", jm)
        spec = port[name].build()
        cert = sch.certify(spec)
        assert cert.replay_safe == jcert["replay_safe"], (name, cert)
        assert cert.replay == jcert["replay"] == sch.DEFAULT_REPLAY
        if spec.fused_by_megastep:
            fused += 1
            assert cert.replay_safe, name
    assert fused == 2


def test_schedule_with_one_value_a_phase_is_not_certified():
    """Every SENT/READ value 1 (an event re-recorded each step, unordered
    by the host): the certifier refuses it with condition (a)."""
    counts = Dim3(1, 2, 2)
    spec = sch.overlap_spec("b7", counts, sch.b7_targets(counts),
                            list(range(4)))
    good = spec.programs

    def one_value(k):
        from dataclasses import replace

        return {i: [replace(st, op=replace(st.op, value=1))
                    if st.op.op != "launch" and st.op.kind in (2, 3)
                    else st for st in prog]
                for i, prog in good(k).items()}

    spec.programs = one_value
    cert = sch.certify(spec)
    assert not cert.replay_safe
    assert any(r.startswith("(a)") for r in cert.reasons)


@pytest.mark.parametrize("launch", ["a", "b"])
def test_dropped_event_wait_is_not_certified(monkeypatch, launch):
    """``ShardOrdering``'s ordering schedule with one event wait dropped
    (position 0's launch A no longer waits for a target's launch B, or
    its launch B for a source's launch A), on the one-process (1, 2, 2)
    mesh: the certificate is not replay-safe, and the ``overlap``
    segment declines with its reasons."""
    from stencil_tpu_torch.ops import cuda_overlap as co
    from stencil_tpu_torch.parallel import megastep as ms

    real = getattr(co, f"ordering_{launch}_schedule")
    kind = co.EV_READ if launch == "a" else co.EV_SENT

    def dropped(i, *args):
        ops = real(i, *args)
        waits = [n for n, op in enumerate(ops)
                 if op.op == "wait" and op.kind == kind]
        if i == 0 and waits:
            del ops[waits[0]]
        return ops

    monkeypatch.setattr(co, f"ordering_{launch}_schedule", dropped)
    monkeypatch.setattr(sch, "_OVERLAP_CERT_MEMO", {})
    counts = Dim3(1, 2, 2)
    cert = sch.certify(sch.overlap_spec("b7", counts,
                                        sch.b7_targets(counts)))
    assert not cert.replay_safe
    assert any(r.startswith("(a)" if launch == "a" else "(c)")
               for r in cert.reasons), cert.reasons
    seg = _overlap_model().make_segment(4)
    assert not seg and seg.code == ms.DECLINE_UNCERTIFIED_SCHEDULE
    assert cert.reasons[0] in seg.reason


def test_shard_ordering_carries_out_its_ordering_schedules(monkeypatch):
    """``ShardOrdering.launch_a`` / ``launch_b`` on stand-in streams and
    events do what ``ordering_a_schedule`` / ``ordering_b_schedule`` say
    (the schedules the certificate replays), in their order, over three
    steps of a one-process (1, 2, 2) mesh."""
    import contextlib

    from stencil_tpu_torch.ops import cuda_overlap as co

    log = []

    class Event:
        def __init__(self):
            self.name = None

        def record(self, stream):
            log.append(("signal", self.name, stream.i))

    class Stream:
        def __init__(self, i):
            self.i = i

        def wait_event(self, ev):
            log.append(("wait", ev.name, self.i))

    class Streams:
        def __init__(self, devices):
            self.streams = [Stream(i) for i in range(len(devices))]

        def __getitem__(self, i):
            return self.streams[i]

    monkeypatch.setattr(co, "ShardStreams", Streams)
    monkeypatch.setattr(co, "enable_peer_access", lambda a, b: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    counts = Dim3(1, 2, 2)
    n = counts.flatten()
    targets = sch.b7_targets(counts)
    o = co.ShardOrdering([torch.device("cuda:0")] * n,
                         [targets(i) for i in range(n)])
    for i in range(n):
        o.sent[i].name, o.read[i].name = (co.EV_SENT, i), (co.EV_READ, i)
    want = []
    for t in range(3):
        o.begin_a()
        for i in range(n):
            with o.launch_a(i):
                log.append(("launch", i))
            want += [("launch", op.slot) if op.op == "launch" else
                     (op.op, (op.kind, op.slot), i)
                     for op in co.ordering_a_schedule(
                         i, o.targets[i], {}, None, t + 1, t)]
        o.begin_b()
        for j in range(n):
            with o.launch_b(j):
                log.append(("launch", j))
            want += [("launch", op.slot) if op.op == "launch" else
                     (op.op, (op.kind, op.slot), j)
                     for op in co.ordering_b_schedule(
                         j, o.sources[j], {}, None, t + 1, t + 1)]
    assert log == want
    assert ("wait", (co.EV_READ, 1), 0) in log
    assert ("wait", (co.EV_SENT, 1), 0) in log


def _overlap_model():
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    m = Jacobi3D(16, 16, 16, kernel="halo", overlap=True,
                 mesh_shape=(1, 2, 2), devices=["cpu"] * 4)
    m.init()
    return m


def test_overlap_segment_declines_an_unsafe_certificate(monkeypatch):
    from stencil_tpu_torch.parallel import megastep as ms

    def unsafe(spec):
        return sch.ScheduleCertificate(spec.kernel, spec.replay, 0, False,
                                       ["(c) a test's refusal"])

    monkeypatch.setattr(sch, "certify", unsafe)
    m = _overlap_model()
    assert m.kernel_path == "overlap"
    assert not m._schedule_certificate.replay_safe
    seg = m.make_segment(4)
    assert not seg
    assert seg.code == ms.DECLINE_UNCERTIFIED_SCHEDULE
    assert "(c) a test's refusal" in seg.reason


def test_certified_overlap_segment_is_bitwise_its_stepwise_run():
    m, ref = _overlap_model(), _overlap_model()
    cert = m._schedule_certificate
    assert cert.replay_safe and cert.kernel.endswith("jacobi7_overlap_cuda")
    assert sch.overlap_certificate(m.dd.mesh_counts, None) is cert
    seg = m.make_segment(4, probe_every=2)
    assert seg
    trace = seg.run(0)
    for _ in range(4):
        ref.run(1)
    for a, b in zip(m.dd.curr["temp"], ref.dd.curr["temp"]):
        assert torch.equal(a, b)
    assert np.isfinite(np.asarray(trace.array)).all()
