"""The port's resilience driver (``stencil_tpu_torch/resilience``:
``driver.py``, ``faults.py``; ``utils/checkpoint.py``) against the JAX
package's, for the fault plans of JAX's ``tests/test_resilience.py``.

Each case runs ``Jacobi3D.run_resilient`` in both packages (16^3 on the
(2,2,2) mesh, ``xla``; JAX on its fake CPU devices, the port on CPU
shards) and compares the reports: the events as ``(kind, step)`` pairs
(the performance-observatory events, ``perf_*``, are left out: they
follow each run's own clock, and ``test_perf_drift_events_equal_jax``
holds them under a fake one; ``same_events``: the
same multiset and the same order but for the checkpoints, whose async
write JAX's dispatch may report later), the step, rollback,
save-retry and degradation counts, the final configuration — and the
final fields bitwise against JAX's and against a clean run. JAX's
reference campaigns run once per module and are shared.

Astaroth (``xla``, float64, (2,2,2)): the same events, fields within 64
eps x max of JAX's and bitwise against the port's clean run. PIC (NGP,
float64, (2,2,2)) with a ``ParticleLoss``: the same events, particles
and rho within rtol 1e-12 of JAX's (its jitted step contracts into
FMAs, ``tests/test_torch_pic.py``), bitwise against the port's clean
run.
"""

import importlib.util
import signal
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stencil_tpu_torch.models.jacobi import Jacobi3D
from stencil_tpu_torch.parallel.methods import Method
from stencil_tpu_torch.resilience import (FaultPlan, NaNInjection,
                                          Preemption, ResilienceError,
                                          ResiliencePolicy, StepConfig,
                                          TransientSaveFailure,
                                          degradation_ladder)
from stencil_tpu_torch.utils.checkpoint import all_steps, checkpoint_meta
from torch_port_support import reference_block_planner, same_events

jax.config.update("jax_platforms", "cpu")

N = 16
STEPS = 12


def fast_policy(**kw):
    kw.setdefault("check_every", 1)
    kw.setdefault("ckpt_every", 4)
    kw.setdefault("base_delay", 0.0)
    kw.setdefault("sleep", lambda s: None)
    return kw


def _plan(mod, spec):
    """A FaultPlan of module ``mod`` (either package's resilience) from a
    plain description."""
    kw = {}
    for kind, args in spec.items():
        cls = {"nans": mod.NaNInjection, "halos": mod.HaloCorruption,
               "save_failures": mod.TransientSaveFailure,
               "ckpt_corruptions": mod.CheckpointCorruption,
               "preemptions": mod.Preemption,
               "particle_losses": mod.ParticleLoss}[kind]
        kw[kind] = [cls(**a) for a in args]
    return mod.FaultPlan(**kw)


def _chip_smoke():
    """The repo's ``chip_smoke.py`` (its phase constants; importing it
    touches no card)."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _no_decline(events):
    return [e for e in events if e[0] != "fused_decline"]


def _events(rep):
    return [(e["event"], e.get("step")) for e in rep.events
            if not e["event"].startswith("perf_")]


def _summary(rep):
    return (rep.steps, rep.rollbacks, rep.save_retries,
            list(rep.degradations), rep.preempted, rep.resumed_from,
            rep.final_config, rep.fused)


#: name -> (FaultPlan description, policy overrides, Jacobi kwargs)
CASES = {
    "nan": ({"nans": [dict(step=7)]}, {}, {}),
    "halo": ({"halos": [dict(step=6, shard=(1, 0, 1))]}, {}, {}),
    "save_failure": ({"save_failures": [dict(step=4, failures=2)]}, {},
                     {}),
    "corrupt_truncate": ({"nans": [dict(step=6)],
                          "ckpt_corruptions": [dict(step=4,
                                                    mode="truncate")]},
                         {}, {}),
    "corrupt_bitflip": ({"nans": [dict(step=6)],
                         "ckpt_corruptions": [dict(step=4,
                                                   mode="bitflip")]},
                        {}, {}),
    "degrade": ({"nans": [dict(step=3, repeat=2)]}, {"max_retries": 1},
                {"exchange_every": 4}),
    "two_incidents": ({"nans": [dict(step=3), dict(step=9)]},
                      {"max_retries": 1}, {}),
    "stepwise": ({"nans": [dict(step=5)]}, {"fuse_segments": False}, {}),
    "preempt": ({"preemptions": [dict(step=6)]}, {"check_every": 2}, {}),
    "preempt_poisoned": ({"nans": [dict(step=5)],
                          "preemptions": [dict(step=5)]},
                         {"check_every": 100}, {}),
}

_JAX_RUNS = {}


def _jax_run(name, tmp_path_factory):
    """JAX's campaign for case ``name`` (and, for the preemption cases,
    its resume), once per module."""
    if name in _JAX_RUNS:
        return _JAX_RUNS[name]
    spec, pol, kw = CASES.get(name, ({}, {}, {}))
    d = str(tmp_path_factory.mktemp(f"jax_{name}"))
    # JAX's resilience package reads jax.core.Jaxpr: import and run it
    # inside one planner patch (which drops the modules afterwards)
    with reference_block_planner():
        from stencil_tpu import resilience as jr
        from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
        from stencil_tpu.utils.checkpoint import all_steps as j_all_steps
        j = JJacobi3D(N, N, N, mesh_shape=(2, 2, 2), dtype=np.float32,
                      devices=jax.devices()[:8], **kw)
        j.init()
        if name == "clean":
            j.run(STEPS)
            out = (None, j.temperature(), None)
        else:
            rep = j.run_resilient(
                STEPS, policy=jr.ResiliencePolicy(**fast_policy(**pol)),
                ckpt_dir=d, faults=_plan(jr, spec))
            resumed = None
            if rep.preempted:
                k = JJacobi3D(N, N, N, mesh_shape=(2, 2, 2),
                              dtype=np.float32, devices=jax.devices()[:8],
                              **kw)
                k.init()
                rep2 = k.run_resilient(
                    STEPS, policy=jr.ResiliencePolicy(**fast_policy()),
                    ckpt_dir=d)
                resumed = (_events(rep2), _summary(rep2), k.temperature(),
                           sorted(int(s) for s in j_all_steps(d)))
            out = ((_events(rep), _summary(rep)), j.temperature(), resumed)
    _JAX_RUNS[name] = out
    return out


def make_jacobi(**kw):
    j = Jacobi3D(N, N, N, mesh_shape=(2, 2, 2), devices=["cpu"] * 8,
                 kernel="xla", **kw)
    j.init()
    return j


@pytest.fixture(scope="module")
def clean_final():
    j = make_jacobi()
    j.run(STEPS)
    return j.temperature()


@pytest.mark.parametrize("name", list(CASES))
def test_fault_plan_report_and_fields_equal_jax(name, tmp_path,
                                                tmp_path_factory,
                                                clean_final):
    spec, pol, kw = CASES[name]
    (want_events, want_summary), want_field, want_resumed = \
        _jax_run(name, tmp_path_factory)
    np.testing.assert_array_equal(_jax_run("clean", tmp_path_factory)[1],
                                  clean_final)
    import stencil_tpu_torch.resilience as pr
    j = make_jacobi(**kw)
    rep = j.run_resilient(STEPS, policy=ResiliencePolicy(
        **fast_policy(**pol)), ckpt_dir=str(tmp_path),
        faults=_plan(pr, spec))
    assert same_events(_events(rep), want_events)
    assert _summary(rep) == want_summary
    np.testing.assert_array_equal(j.temperature(), want_field)
    if not rep.preempted:
        np.testing.assert_array_equal(j.temperature(), clean_final)
        return
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    meta = checkpoint_meta(str(tmp_path))
    assert meta["completed_steps"] == max(all_steps(str(tmp_path)))
    k = make_jacobi(**kw)
    rep2 = k.run_resilient(STEPS, policy=ResiliencePolicy(**fast_policy()),
                           ckpt_dir=str(tmp_path))
    events, summary, field, steps = want_resumed
    assert same_events(_events(rep2), events)
    assert _summary(rep2) == summary
    assert all_steps(str(tmp_path)) == steps
    np.testing.assert_array_equal(k.temperature(), field)
    np.testing.assert_array_equal(k.temperature(), clean_final)


def test_preemption_meta_is_tagged(tmp_path):
    j = make_jacobi()
    rep = j.run_resilient(STEPS, policy=ResiliencePolicy(
        **fast_policy(check_every=2)), ckpt_dir=str(tmp_path),
        faults=FaultPlan(preemptions=[Preemption(step=6)]))
    assert rep.preempted and rep.steps == 6
    meta = checkpoint_meta(str(tmp_path))
    assert meta["preempted"] is True and meta["completed_steps"] == 6
    assert meta["config"] == "PpermuteSlab[s=1]"


def test_persistent_save_failure_raises(tmp_path):
    j = make_jacobi()
    plan = FaultPlan(save_failures=[TransientSaveFailure(step=4,
                                                         failures=99)])
    with pytest.raises(OSError, match="injected"):
        j.run_resilient(STEPS, policy=ResiliencePolicy(
            **fast_policy(save_attempts=3)), ckpt_dir=str(tmp_path),
            faults=plan)


def test_watchdog_mode_without_ckpt_dir_raises():
    j = make_jacobi()
    with pytest.raises(ResilienceError, match="nothing to roll back"):
        j.run_resilient(STEPS, policy=ResiliencePolicy(**fast_policy()),
                        faults=FaultPlan(nans=[NaNInjection(step=3)]))


def test_retries_and_ladder_exhausted_raise(tmp_path):
    j = make_jacobi()
    with pytest.raises(ResilienceError, match="retries exhausted"):
        j.run_resilient(STEPS, policy=ResiliencePolicy(
            **fast_policy(max_retries=1, degrade=False)),
            ckpt_dir=str(tmp_path),
            faults=FaultPlan(nans=[NaNInjection(step=3, repeat=99)]))


def test_infeasible_ladder_rung_skipped_not_fatal(tmp_path):
    """JAX's case: on an uneven grid only the copy engines realize, so
    the AllGather rung is infeasible and the run ends in
    ResilienceError, never a raw NotImplementedError."""
    j = Jacobi3D(17, 17, 17, mesh_shape=(2, 2, 2), devices=["cpu"] * 8,
                 kernel="xla")
    j.init()
    with pytest.raises(ResilienceError, match="no degradation"):
        j.run_resilient(STEPS, policy=ResiliencePolicy(
            **fast_policy(max_retries=0)), ckpt_dir=str(tmp_path),
            faults=FaultPlan(nans=[NaNInjection(step=2, repeat=99)]))


def test_degradation_ladder_equals_jax():
    with reference_block_planner():
        from stencil_tpu import resilience as jr
        from stencil_tpu.parallel.methods import Method as JMethod
        for m, s in ((Method.PpermutePacked, 4), (Method.PpermuteSlab, 1),
                     (Method.PallasDMA, 2), (Method.AllGather, 1)):
            want = jr.degradation_ladder(JMethod[m.name], s,
                                         runnable=lambda x: True)
            got = degradation_ladder(m, s)
            assert [c.key() for c in got] == [c.key() for c in want]
    assert degradation_ladder(Method.PpermutePacked, 4) == [
        StepConfig(Method.PpermutePacked, 2),
        StepConfig(Method.PpermutePacked, 1),
        StepConfig(Method.PpermuteSlab, 1),
        StepConfig(Method.AllGather, 1)]


def test_fused_loop_probes_ride_the_segment_trace(tmp_path, monkeypatch):
    """JAX's case: with segments every step's health arrives as a row of
    the segment's trace — no standalone probe on the fault-free path."""
    from stencil_tpu_torch.resilience import driver as drv

    probes, traces = [], []

    class Counting(drv.HealthSentinel):
        def probe(self, fields, step):
            probes.append(step)
            super().probe(fields, step)

        def observe_segment(self, trace, steps):
            traces.append(tuple(steps))
            super().observe_segment(trace, steps)

    monkeypatch.setattr(drv, "HealthSentinel", Counting)
    j = make_jacobi()
    rep = j.run_resilient(4, policy=ResiliencePolicy(
        **fast_policy(ckpt_every=2, check_every=2)), ckpt_dir=str(tmp_path))
    assert rep.steps == 4 and rep.fused
    assert probes == [] and traces == [(1, 2), (3, 4)]


def _drifting_clock(monkeypatch, mod, steps):
    """Make every ``PerfAttributor`` of observatory module ``mod`` time
    with a clock whose k-th dispatch lasts ``steps[k]`` seconds."""
    import functools

    seq = [x for d in steps for x in (0.0, d)]
    t = [0.0]

    def clock():
        t[0] += seq.pop(0) if seq else 1.0
        return t[0]

    init = mod.PerfAttributor.__init__
    monkeypatch.setattr(mod.PerfAttributor, "__init__",
                        functools.partialmethod(init, clock=clock))


#: segment seconds of a 12-step campaign in 2-step segments: a warm-up,
#: the reference, one more alike, then three at 3x — a drift at step 12
DRIFT = [5.0, 1.0, 1.0, 3.0, 3.0, 3.0]


def _drift_attrs(events):
    return [(e["step"], e["consecutive"], e["s"], e["method"], e["entry"],
             e["tolerance"], e["window"], round(e["ratio"] / e["baseline"],
                                                12))
            for e in events if e["event"] == "perf_drift"]


def test_perf_drift_events_equal_jax(tmp_path, monkeypatch):
    """The driver's attributor under a fake clock: the same
    ``perf_drift`` events as JAX's driver for the same segment times
    (the ratios' scale differs with the default link price; their
    departure from the reference does not)."""
    from stencil_tpu_torch.observatory import attribution as pa

    pol = fast_policy(check_every=2, ckpt_every=4)
    _drifting_clock(monkeypatch, pa, DRIFT)
    j = make_jacobi()
    rep = j.run_resilient(STEPS, policy=ResiliencePolicy(**pol),
                          ckpt_dir=str(tmp_path / "port"))
    got = _drift_attrs(rep.events)
    with reference_block_planner():
        from stencil_tpu import resilience as jr
        from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
        from stencil_tpu.observatory import attribution as ja

        _drifting_clock(monkeypatch, ja, DRIFT)
        k = JJacobi3D(N, N, N, mesh_shape=(2, 2, 2), dtype=np.float32,
                      devices=jax.devices()[:8])
        k.init()
        jrep = k.run_resilient(STEPS, policy=jr.ResiliencePolicy(**pol),
                               ckpt_dir=str(tmp_path / "jax"))
        want = _drift_attrs(jrep.events)
    assert got == want == [(12, 3, 1, "PpermuteSlab", "jacobi", 0.5, 3,
                            3.0)]


def test_observatory_options_raise_naming_a12(tmp_path, monkeypatch):
    """The A12 options that raised before the observatory was ported now
    run: ``flight_recorder_dir`` (and ``$STENCIL_FLIGHT_RECORDER_DIR``)
    dump each incident in JAX's schema, and ``retune_on_drift`` drops
    the tuned plan's cache record on a drift (``plan_invalidated``)."""
    from stencil_tpu_torch.observatory import attribution as pa
    from stencil_tpu_torch.observatory.recorder import validate_dump
    from stencil_tpu_torch import tuning
    from stencil_tpu_torch.tuning import FakeTimer, load_plan

    import stencil_tpu_torch.resilience as prs
    flight = tmp_path / "flight"
    rep = make_jacobi().run_resilient(
        STEPS, policy=ResiliencePolicy(**fast_policy(
            flight_recorder_dir=str(flight))),
        ckpt_dir=str(tmp_path / "a"),
        faults=_plan(prs, {"nans": [dict(step=7)]}))
    dumps = sorted(flight.iterdir())
    assert rep.rollbacks == 1 and len(dumps) == 1
    assert "sentinel_trip" in dumps[0].name
    assert validate_dump(dumps[0]) == []
    monkeypatch.setenv("STENCIL_FLIGHT_RECORDER_DIR", str(tmp_path / "env"))
    make_jacobi().run_resilient(
        STEPS, policy=ResiliencePolicy(**fast_policy()),
        ckpt_dir=str(tmp_path / "b"),
        faults=_plan(prs, {"preemptions": [dict(step=6)]}))
    assert [p.name.split("_")[-1] for p in (tmp_path / "env").iterdir()] \
        == ["preempt.json"]
    monkeypatch.delenv("STENCIL_FLIGHT_RECORDER_DIR")
    cache = tmp_path / "plans.json"
    monkeypatch.setenv("STENCIL_TUNE_CACHE", str(cache))
    monkeypatch.setattr(tuning, "MeshTimer", lambda *a, **kw: FakeTimer())
    j = make_jacobi(methods=Method.Auto)
    fp = j.dd.plan.fingerprint
    assert load_plan(fp, cache) is not None
    _drifting_clock(monkeypatch, pa, DRIFT)
    rep = j.run_resilient(STEPS, policy=ResiliencePolicy(**fast_policy(
        check_every=2, ckpt_every=4, retune_on_drift=True,
        plan_cache_path=str(cache))), ckpt_dir=str(tmp_path / "c"))
    kinds = [e["event"] for e in rep.events]
    assert "perf_drift" in kinds
    inval = [e for e in rep.events if e["event"] == "plan_invalidated"]
    assert inval and inval[0]["fingerprint"] == fp and inval[0]["removed"]
    assert load_plan(fp, cache) is None


def test_run_loop_counters_use_jax_names(tmp_path):
    from stencil_tpu_torch.telemetry import get_registry
    reg = get_registry()
    before = reg.counter("stencil_run_steps_total").value()
    rb = reg.counter("stencil_run_rollbacks_total").value()
    j = make_jacobi()
    j.run_resilient(8, policy=ResiliencePolicy(**fast_policy()),
                    ckpt_dir=str(tmp_path),
                    faults=FaultPlan(nans=[NaNInjection(step=6)]))
    # 8 steps plus the replayed window 5..6
    assert reg.counter("stencil_run_steps_total").value() - before == 10
    assert reg.counter("stencil_run_rollbacks_total").value() - rb == 1
    text = reg.to_prometheus_text()
    for name in ("stencil_run_checkpoints_total",
                 "stencil_run_degradations_total",
                 "stencil_run_fused_dispatch_total",
                 "stencil_run_steps_per_s"):
        assert name in text


def test_single_compile_guard_counts_builds(monkeypatch):
    from stencil_tpu_torch.analysis.recompile import (RecompileGuardError,
                                                      SingleCompileGuard)
    from stencil_tpu_torch.ops import _build

    g = SingleCompileGuard()
    fac = object()
    g.observe(fac)
    g.observe(fac)
    monkeypatch.setattr(_build, "BUILDS", _build.BUILDS + 1)
    with pytest.raises(RecompileGuardError):
        g.observe(fac)


def test_transfer_guard_is_null_on_the_cpu(monkeypatch):
    from stencil_tpu_torch.analysis.transfer import hot_loop_transfer_guard

    with hot_loop_transfer_guard([torch.device("cpu")]):
        torch.ones(3).sum().item()
    monkeypatch.setenv("STENCIL_ALLOW_TRANSFERS", "1")
    with hot_loop_transfer_guard(["cuda:0"]):
        pass


# ---------------------------------------------------------------------------
# Astaroth and PIC
# ---------------------------------------------------------------------------
def test_astaroth_resilient_with_accumulators(tmp_path, tmp_path_factory):
    """JAX's case: the RK accumulators ride the checkpoint; recovery
    from a NaN at iteration 3 is bitwise the port's clean run and within
    64 eps x max of JAX's, with JAX's events (both stepwise: JAX's
    fused MHD segment takes tens of seconds to compile)."""
    from stencil_tpu_torch.models.astaroth import Astaroth

    steps = 4
    pol = fast_policy(ckpt_every=2, fuse_segments=False)
    with reference_block_planner():
        from stencil_tpu import resilience as jr
        from stencil_tpu.models.astaroth import Astaroth as JAstaroth
        ja = JAstaroth(8, 8, 8, mesh_shape=(2, 2, 2), dtype=np.float64,
                       devices=jax.devices()[:8], kernel="xla")
        ja.init()
        jrep = ja.run_resilient(
            steps, policy=jr.ResiliencePolicy(**pol),
            ckpt_dir=str(tmp_path_factory.mktemp("jax_astaroth")),
            faults=jr.FaultPlan(nans=[jr.NaNInjection(step=3,
                                                      quantity="uux")]))

    def port():
        a = Astaroth(8, 8, 8, mesh_shape=(2, 2, 2), dtype=torch.float64,
                     devices=["cpu"] * 8, kernel="xla")
        a.init()
        return a

    clean = port()
    clean.run(steps)
    b = port()
    rep = b.run_resilient(steps, policy=ResiliencePolicy(**pol),
                          ckpt_dir=str(tmp_path),
                          faults=FaultPlan(nans=[NaNInjection(
                              step=3, quantity="uux")]))
    assert same_events(_events(rep), _events(jrep))
    assert _summary(rep) == _summary(jrep)
    assert _no_decline(_events(rep)) == \
        _chip_smoke().RES_EVENTS["astaroth nan"]
    assert rep.steps == steps and rep.rollbacks == 1
    for q in ("lnrho", "uux", "uuy", "uuz", "ax", "ay", "az", "ss"):
        np.testing.assert_array_equal(b.field(q), clean.field(q))
        want = ja.field(q)
        tol = 64 * np.finfo(np.float64).eps * np.abs(want).max()
        np.testing.assert_allclose(b.field(q), want, rtol=0, atol=tol)
        np.testing.assert_array_equal(b.accumulator(q),
                                      clean.accumulator(q))


def test_pic_resilient_particle_loss(tmp_path, tmp_path_factory):
    """A ParticleLoss at step 3 NaNs two live records of shard (1,0,0);
    the sentinel (rho and the lanes) trips, the lanes come back from the
    checkpoint extras, and the run ends bitwise the port's clean run and
    within rtol 1e-12 of JAX's, with JAX's events. The exported particle
    counter advances by particles x (steps + replayed window)."""
    from stencil_tpu_torch.models.pic import Pic
    from stencil_tpu_torch.telemetry import get_registry

    steps, n = 6, 48
    pol = fast_policy(ckpt_every=2, check_every=2)
    spec = {"particle_losses": [dict(step=3, count=2, shard=(1, 0, 0))]}
    with reference_block_planner():
        from stencil_tpu import resilience as jr
        from stencil_tpu.models.pic import Pic as JPic
        jp = JPic(8, 8, 8, n, mesh_shape=(2, 2, 2), dtype=np.float64,
                  devices=jax.devices()[:8], deposition="ngp", seed=4)
        jrep = jp.run_resilient(
            steps, policy=jr.ResiliencePolicy(**pol),
            ckpt_dir=str(tmp_path_factory.mktemp("jax_pic")),
            faults=_plan(jr, spec))

    def port():
        return Pic(8, 8, 8, n, mesh_shape=(2, 2, 2), dtype=torch.float64,
                   devices=["cpu"] * 8, deposition="ngp", seed=4)

    clean = port()
    clean.run(steps)
    reg = get_registry()
    before = reg.counter("stencil_run_particles_total").value()
    pp = port()
    import stencil_tpu_torch.resilience as pr
    rep = pp.run_resilient(steps, policy=ResiliencePolicy(**pol),
                           ckpt_dir=str(tmp_path), faults=_plan(pr, spec))
    assert same_events(_events(rep), _events(jrep))
    assert _summary(rep) == _summary(jrep)
    assert _no_decline(_events(rep)) == _chip_smoke().RES_EVENTS["pic loss"]
    lost = [e for e in rep.events if e["event"] == "fault_particle_loss"]
    jlost = [e for e in jrep.events if e["event"] == "fault_particle_loss"]
    assert lost[0]["slots"] == jlost[0]["slots"]
    assert reg.counter("stencil_run_particles_total").value() - before == \
        rep.steps * n
    got, want = pp.particles_to_host(), clean.particles_to_host()
    jwant = jp.particles_to_host()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if k != "overflow":
            np.testing.assert_allclose(got[k], jwant[k], rtol=1e-12,
                                       err_msg=k)
    np.testing.assert_array_equal(pp.rho(), clean.rho())
    np.testing.assert_allclose(pp.rho(), jp.rho(), rtol=0, atol=1e-12)
    assert pp.total_charge() == jp.total_charge() == float(n)


#: chip_smoke.py's Jacobi plans: (label, the port's CPU model kwargs)
CHIP_JACOBI = (("wrap nan", {"kernel": "wrap"}),
               ("halo degrade", {"kernel": "halo", "mesh_shape": (1, 2, 2),
                                 "exchange_every": 2}),
               ("wrap preempt", {"kernel": "wrap"}))


@pytest.mark.parametrize("label,kw", CHIP_JACOBI)
def test_chip_smoke_plans_give_jax_events(label, kw, tmp_path,
                                          tmp_path_factory):
    """``chip_smoke.py``'s resilience phase holds its campaigns to
    ``RES_EVENTS``: those lists are JAX's driver's events for the same
    plans (JAX ``xla`` on (1,2,2); ``same_events``), and the port gives
    them on the CPU, in order, on the path the card runs."""
    cs = _chip_smoke()
    spec, pol, n = cs.RES_PLANS[label]
    want = cs.RES_EVENTS[label]
    with reference_block_planner():
        from stencil_tpu import resilience as jr
        from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
        jkw = {"exchange_every": kw["exchange_every"]} \
            if "exchange_every" in kw else {}
        j = JJacobi3D(N, N, N, mesh_shape=(1, 2, 2), dtype=np.float32,
                      devices=jax.devices()[:4], **jkw)
        j.init()
        jrep = j.run_resilient(
            n, policy=jr.ResiliencePolicy(**fast_policy(max_to_keep=2,
                                                        **pol)),
            ckpt_dir=str(tmp_path_factory.mktemp("jax_chip")),
            faults=_plan(jr, spec))
    assert same_events(_no_decline(_events(jrep)), want)
    mesh = kw.pop("mesh_shape", (1, 1, 1))
    p = Jacobi3D(32, 32, 32, mesh_shape=mesh,
                 devices=["cpu"] * int(np.prod(mesh)), **kw)
    p.init()
    import stencil_tpu_torch.resilience as pr
    rep = p.run_resilient(n, policy=ResiliencePolicy(
        **fast_policy(max_to_keep=2, **pol)), ckpt_dir=str(tmp_path),
        faults=_plan(pr, spec))
    assert _no_decline(_events(rep)) == want
    assert len(all_steps(str(tmp_path))) <= 2
