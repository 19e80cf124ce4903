"""The port's exchange autotuner (``stencil_tpu_torch/tuning``,
``tune.py``, ``Method.Auto``, ``DistributedDomain.autotune`` /
``apply_plan``) against the JAX package's ``stencil_tpu/tuning``.

The same numpy-seeded ring-shift samples fit the same alpha-beta
coefficients; ``run_autotune`` under ``FakeTimer`` with the same
explicit ``runnable`` and coefficients picks the same winner, prices
every candidate the same (rel 1e-12), prunes the same candidates and
counts the same measurements. ``runnable`` is passed to both: JAX's
default drops ``PallasDMA`` off a TPU, the port's runs every method. A
JAX plan record loads into the port's ``Plan`` and applies to a port
domain. The cache is held under threads, on a corrupt file and after an
invalidation. JAX is imported under ``reference_modules`` (jax 0.9 moved
the ``jax.core`` names its analysis package reads).
"""

import json
import threading

import numpy as np
import pytest
import torch

from stencil_tpu_torch import Dim3, Radius
from stencil_tpu_torch import tuning as pt
from stencil_tpu_torch.analysis.costmodel import LinkCoefficients
from stencil_tpu_torch.distributed import DistributedDomain
from stencil_tpu_torch.models.jacobi import Jacobi3D
from stencil_tpu_torch.parallel.methods import Method
from stencil_tpu_torch.tuning import cache as pcache
from torch_port_support import reference_modules

REL = 1e-12
CPU4 = ["cpu"] * 4


@pytest.fixture(scope="module")
def jt():
    with reference_modules():
        import stencil_tpu.tuning as jax_tuning

        yield jax_tuning


def _jgeom(jt, g: pt.TuneGeometry):
    from stencil_tpu.geometry import Dim3 as JDim3, Radius as JRadius

    r = g.radius
    jr = JRadius.constant(0)
    for d in __import__("stencil_tpu.geometry",
                        fromlist=["all_directions"]).all_directions():
        jr.set_dir(d, r.dir(Dim3(d.x, d.y, d.z)))
    return jt.TuneGeometry(g.shard_interior_zyx, g.min_interior_zyx, jr,
                           JDim3(*g.counts), g.elem_sizes, g.uneven,
                           g.nonperiodic, g.dtype_strs)


GEOMS = [
    pt.TuneGeometry((16, 16, 16), (16, 16, 16), Radius.constant(1),
                    Dim3(2, 2, 2), (4,), dtype_strs=("float32",)),
    pt.TuneGeometry((32, 16, 16), (31, 16, 16),
                    Radius.face_edge_corner(2, 1, 1), Dim3(1, 2, 4),
                    (4, 4, 8), uneven=True,
                    dtype_strs=("float32", "float32", "float64")),
    pt.TuneGeometry((64, 64, 8), (64, 64, 8), Radius.constant(2),
                    Dim3(4, 1, 1), (4, 4), nonperiodic=True,
                    dtype_strs=("float32", "float32")),
    pt.TuneGeometry((256, 256, 512), (256, 256, 512), Radius.constant(1),
                    Dim3(1, 2, 2), (4,), dtype_strs=("float32",)),
]

INPUTS = {"platform": "test", "grid": [1, 2, 3], "library_version": "x"}


def test_fit_alpha_beta_on_seeded_samples(jt):
    from stencil_tpu.tuning import fit as jfit

    rng = np.random.default_rng(22)
    for _ in range(20):
        sizes = sorted(int(v) for v in rng.integers(1, 1 << 22, 4))
        alpha, beta = rng.uniform(1e-6, 1e-4), rng.uniform(1e9, 1e12)
        samples = [(b, alpha + b / beta * rng.uniform(0.9, 1.1))
                   for b in sizes]
        got = pt.fit_alpha_beta(samples)
        want = jfit.fit_alpha_beta(samples)
        assert got.alpha_s == pytest.approx(want.alpha_s, rel=REL)
        assert got.beta_bytes_per_s == pytest.approx(want.beta_bytes_per_s,
                                                     rel=REL)
    for degenerate in ([(4096, 1e-5)], [(10, 2e-5), (10, 3e-5)],
                       [(10, 5e-5), (20, 4e-5)]):
        got, want = pt.fit_alpha_beta(degenerate), \
            jfit.fit_alpha_beta(degenerate)
        assert (got.alpha_s, got.beta_bytes_per_s) == \
            (want.alpha_s, want.beta_bytes_per_s)
    with pytest.raises(ValueError):
        pt.fit_alpha_beta([])


def _everything(m):
    return True


@pytest.mark.parametrize("g", GEOMS)
def test_candidate_space_equals_jax(jt, g):
    jg = _jgeom(jt, g)
    depths = (1, 2, 4, {"z": 2}, (1, 2, 2))
    for wf, wl, ovl in ((("f32",), ("slab",), (False,)),
                        (("f32", "bf16"), ("slab", "irredundant"),
                         (False, True))):
        got = pt.candidate_space(g, depths, ovl, runnable=_everything,
                                 wire_formats=wf, wire_layouts=wl)
        want = jt.candidate_space(jg, depths, ovl, runnable=_everything,
                                  wire_formats=wf, wire_layouts=wl)
        assert [c.key() for c in got] == [c.key() for c in want]
        assert all(pt.Candidate.from_key(c.key()) == c for c in got)


@pytest.mark.parametrize("g", GEOMS)
@pytest.mark.parametrize("case", ["plain", "scaled", "dcn", "narrow"])
def test_run_autotune_under_fake_timer_equals_jax(jt, tmp_path, g, case):
    """The same winner, per-candidate costs, pruning and measurement
    counts; the port's timer sees the same candidates in the same
    order."""
    from stencil_tpu.analysis.costmodel import LinkCoefficients as JLink

    jg = _jgeom(jt, g)
    kw = dict(depths=(1, 2, 4), max_measurements=3)
    pkw, jkw = {}, {}
    coeffs = (3e-6, 2e10)
    if case == "scaled":
        pkw = jkw = {"scale": {"PpermuteSlab": 3.0, "AllGather": 0.5}}
    if case == "dcn":
        pkw = {"dcn_coeffs": LinkCoefficients(5e-5, 3e9)}
        jkw = {"dcn_coeffs": JLink(5e-5, 3e9)}
        kw["dcn_axis"] = 2
    if case == "narrow":
        kw.update(wire_formats=("f32", "bf16"),
                  wire_layouts=("slab", "irredundant"),
                  overlap_options=(False, True))
    got = pt.run_autotune(
        g, dict(INPUTS), pt.FakeTimer(LinkCoefficients(*coeffs), **pkw),
        cache_path=tmp_path / "port.json", runnable=_everything, **kw)
    want = jt.run_autotune(
        jg, dict(INPUTS), jt.FakeTimer(JLink(*coeffs), **jkw),
        cache_path=tmp_path / "jax.json", runnable=_everything, **kw)
    assert got.config.key() == want.config.key()
    assert got.fingerprint == want.fingerprint
    assert got.measurements == want.measurements
    assert got.predicted_best_depth == want.predicted_best_depth
    assert got.coefficients.keys() == want.coefficients.keys()
    for link in want.coefficients:
        for k in ("alpha_s", "beta_bytes_per_s"):
            assert got.coefficients[link][k] == pytest.approx(
                want.coefficients[link][k], rel=REL)
    assert list(got.costs) == list(want.costs)
    for key, rec in want.costs.items():
        assert got.costs[key].keys() == rec.keys(), key
        for k, v in rec.items():
            assert got.costs[key][k] == pytest.approx(v, rel=REL), key
    # the cache hit measures nothing and returns the same configuration
    again = pt.run_autotune(g, dict(INPUTS), pt.FakeTimer(),
                            cache_path=tmp_path / "port.json",
                            runnable=_everything, **kw)
    assert again.provenance == "cached" and again.measurements == 0
    assert again.config == got.config


def test_fingerprint_inputs_equal_jax(jt):
    from stencil_tpu.geometry import Radius as JRadius

    for r, jr in ((Radius.constant(1), JRadius.constant(1)),
                  (Radius.face_edge_corner(2, 1, 0),
                   JRadius.face_edge_corner(2, 1, 0))):
        kw = dict(platform="cpu", device_count=8, mesh_shape=[2, 2, 2],
                  grid=[32, 32, 32], quantities={"a": "float32",
                                                 "b": "float64"},
                  boundary="PERIODIC", n_slices=2, library_version="0.1.0",
                  wire_format="bf16", wire_layout="irredundant",
                  exchange_depths=(1, 1, 2), placement="qap")
        got = pt.fingerprint_inputs(radius=r, **kw)
        want = jt.fingerprint_inputs(radius=jr, **kw)
        assert got == want and pt.fingerprint(got) == jt.fingerprint(want)
    # the port's own identity: its version and the card's name
    mine = pt.fingerprint_inputs("gpu", 4, [1, 2, 2], [8, 8, 8],
                                 Radius.constant(1), {"t": "float32"},
                                 "PERIODIC", device_kind="H100")
    assert mine["library_version"] == "0.1.0+torch"
    assert mine["device_kind"] == "H100"


def test_migration_ranking_equals_jax(jt):
    from stencil_tpu.analysis.costmodel import LinkCoefficients as JLink
    from stencil_tpu.geometry import Dim3 as JDim3

    for n, frac, counts in ((1000, 0.25, (2, 2, 2)), (64, 0.1, (1, 1, 4)),
                            (5000, 0.05, (4, 2, 1))):
        got = pt.rank_migration_candidates(
            n, 7, Dim3(*counts), 4, frac, LinkCoefficients(1e-5, 1e10))
        want = jt.rank_migration_candidates(
            n, 7, JDim3(*counts), 4, frac, JLink(1e-5, 1e10))
        assert [c.key() for _, c in got] == [c.key() for _, c in want]
        for (a, _), (b, _) in zip(got, want):
            assert a == pytest.approx(b, rel=REL)
    with pytest.raises(ValueError):
        pt.rank_migration_candidates(100, 7, Dim3(2, 2, 2), 4, 10.0)


def _fake_tuner(monkeypatch, cache, timer=None):
    """``Method.Auto`` at realize() under ``timer`` (default a plain
    ``FakeTimer``) in place of the real ``MeshTimer``, its plans in
    ``cache`` (JAX ``test_method_auto_resolves_at_realize``)."""
    monkeypatch.setenv("STENCIL_TUNE_CACHE", str(cache))
    timer = timer if timer is not None else pt.FakeTimer()
    monkeypatch.setattr(pt, "MeshTimer", lambda *a, **kw: timer)


def _domain(x=16, y=16, z=16, mesh=(2, 2, 1), fields=1):
    dd = DistributedDomain(x, y, z, devices=CPU4)
    dd.set_mesh_shape(mesh)
    dd.set_radius(1)
    for i in range(fields):
        dd.add_data(f"q{i}", torch.float32)
    return dd


def test_jax_plan_record_loads_and_applies(jt, tmp_path):
    """The carried-across state: a JAX ``Plan.to_record()`` (through a
    JSON file) is the port's ``Plan``, and ``apply_plan`` sets the
    domain's method, depths, wire and placement."""
    from stencil_tpu.tuning.plan import Candidate as JCand, Plan as JPlan

    jplan = JPlan(config=JCand("PpermutePacked", 2, False, "bf16", "slab",
                               (1, 2, 2)),
                  fingerprint="f" * 32,
                  coefficients={"ici": {"alpha_s": 1e-5,
                                        "beta_bytes_per_s": 2e10}},
                  costs={"PpermutePacked[s=1.2.2,wire=bf16]":
                         {"predicted_s": 1e-4, "measured_s": 2e-4}},
                  provenance="tuned", measurements=5, created=1.5,
                  library_version="0.1.0", predicted_best_depth=2,
                  tiling={"jacobi7_halo_pallas": {"block": [8, 16]}},
                  placement="trivial")
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(jplan.to_record()))
    plan = pt.Plan.from_record(json.loads(path.read_text()))
    assert plan.to_record() == jplan.to_record()
    dd = _domain(x=16, y=16, z=32, mesh=(1, 2, 2))
    dd.apply_plan(plan)
    assert dd.methods == Method.PpermutePacked
    assert tuple(dd.exchange_depths) == (1, 2, 2) and dd.exchange_every == 2
    assert dd.wire_format == "bf16" and dd.placement_mode == "trivial"
    dd.realize()
    assert dd.plan_provenance == "tuned"
    # and back: a port plan loads into JAX's
    assert JPlan.from_record(plan.to_record()).to_record() == \
        jplan.to_record()


def test_autotune_domain_and_method_auto(tmp_path, monkeypatch):
    """``Method.Auto`` resolves at realize() through the cache; a second
    domain of the same problem is a hit that measures nothing; the plan
    file records the provenance."""
    cache = tmp_path / "plans.json"
    _fake_tuner(monkeypatch, cache, pt.FakeTimer(
        scale={"PpermuteSlab": 9.0, "AllGather": 9.0}))
    dd = _domain()
    dd.set_methods(Method.Auto)
    dd.set_output_prefix(str(tmp_path / "p_"))
    dd.realize()
    assert dd.methods == Method.PpermutePacked and dd.exchange_every == 8
    assert dd.plan.provenance == "tuned" and dd.plan.measurements == 7
    text = (tmp_path / "p_plan.txt").read_text()
    assert "plan provenance: tuned" in text and \
        "plan config: PpermutePacked[s=8]" in text
    dd2 = _domain()
    dd2.set_methods(Method.Auto)
    dd2.realize()
    assert dd2.plan.provenance == "cached" and dd2.plan.measurements == 0
    assert dd2.methods == Method.PpermutePacked
    with pytest.raises(RuntimeError):
        dd2.autotune()


def test_jacobi_auto_equals_named_winner(tmp_path, monkeypatch):
    """``Jacobi3D`` built with ``Method.Auto`` runs the winner: bitwise
    the same run with the winner named; the ``pallas`` path keeps depth
    1 of the depths the tuner sweeps."""
    _fake_tuner(monkeypatch, tmp_path / "p.json",
                pt.FakeTimer(scale={"PallasDMA": 0.1}))
    j = Jacobi3D(16, 16, 16, mesh_shape=(1, 2, 2), devices=CPU4,
                 kernel="pallas", methods=Method.Auto)
    assert j.dd.plan.config.key() == "PallasDMA[s=1]"
    assert all("[s=1" in k for k in j.dd.plan.costs)
    k = Jacobi3D(16, 16, 16, mesh_shape=(1, 2, 2), devices=CPU4,
                 kernel="pallas", methods=Method.PallasDMA)
    for m in (j, k):
        m.init()
        m.run(4)
    np.testing.assert_array_equal(j.temperature(), k.temperature())
    _fake_tuner(monkeypatch, tmp_path / "q.json")
    x = Jacobi3D(16, 16, 16, mesh_shape=(1, 2, 2), devices=CPU4,
                 kernel="xla", methods=Method.Auto)
    assert x.dd.exchange_every == x.dd.plan.config.exchange_every
    assert x.kernel_path.startswith(
        "xla-temporal" if x.dd.exchange_every > 1 else "xla")


def test_mesh_timer_times_the_deployed_exchange():
    """The real timer on CPU shards: one ring shift a size, and every
    method's exchange round (uniform and per-axis) returns a positive
    time, the median of its windows; a search under it keeps each timed
    candidate's least and most window in the plan."""
    from stencil_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh((1, 2, 2), ["cpu"] * 4)
    timer = pt.MeshTimer(mesh, Dim3(8, 8, 8), [torch.float32], reps=1)
    assert timer.pingpong(4096) > 0 and timer.pingpong_axis("x", 64) > 0
    g = pt.TuneGeometry((8, 8, 8), (8, 8, 8), Radius.constant(1),
                        Dim3(1, 2, 2), (4,))
    for c in pt.candidate_space(g, (1, 2, {"z": 2})):
        t = timer.exchange_round(c, g)
        w = timer.last_windows
        assert t > 0 and len(w) == pt.measure.WINDOWS, c.key()
        assert min(w) <= t <= max(w)
    plan = pt.run_autotune(g, {"grid": [8, 16, 16]}, timer,
                           read_cache=False, write_cache=False,
                           depths=(1,), max_measurements=2)
    timed = [r for r in plan.costs.values() if "measured_s" in r]
    assert len(timed) == 2
    for r in timed:
        assert r["measured_min_s"] <= r["measured_s"] <= r["measured_max_s"]


def test_cache_threads_corrupt_file_and_invalidate(tmp_path, monkeypatch):
    monkeypatch.setattr(pcache, "_RETRY_SLEEP", lambda s: None)
    path = tmp_path / "plans.json"

    def plan(i):
        return pt.Plan(config=pt.Candidate("PpermuteSlab", 1),
                       fingerprint=f"{i:032d}", coefficients={}, costs={})

    threads = [threading.Thread(target=pt.store_plan, args=(plan(i), path))
               for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(pcache.load_cache(path)) == 16
    assert pt.load_plan(f"{3:032d}", path).config.key() == \
        "PpermuteSlab[s=1]"
    assert pt.invalidate_plan(f"{3:032d}", path)
    assert not pt.invalidate_plan(f"{3:032d}", path)
    assert pt.load_plan(f"{3:032d}", path) is None
    assert len(pcache.load_cache(path)) == 15
    path.write_text("{ not json")
    assert pcache.load_cache(path) == {} and \
        pt.load_plan(f"{4:032d}", path) is None
    pt.store_plan(plan(4), path)
    assert list(pcache.load_cache(path)) == [f"{4:032d}"]
    path.write_text(json.dumps({"schema": 99, "plans": {}}))
    assert pcache.load_cache(path) == {}
    monkeypatch.setenv("STENCIL_TUNE_CACHE", str(tmp_path / "env.json"))
    assert pt.default_cache_path() == tmp_path / "env.json"


def test_jax_and_port_caches_read_each_other(jt, tmp_path):
    """One cache file, two writers: JAX's and the port's records keep
    one schema, so either package reads the other's."""
    from stencil_tpu.tuning.plan import Candidate as JCand, Plan as JPlan

    path = tmp_path / "plans.json"
    jt.store_plan(JPlan(config=JCand("AllGather", 1), fingerprint="a" * 32,
                        coefficients={}, costs={}), path)
    pt.store_plan(pt.Plan(config=pt.Candidate("PallasDMA", 1),
                          fingerprint="b" * 32, coefficients={}, costs={}),
                  path)
    assert pt.load_plan("a" * 32, path).config.method == "AllGather"
    assert jt.load_plan("b" * 32, path).config.method == "PallasDMA"


def test_tune_cli_fake_timer(tmp_path, capsys):
    from stencil_tpu_torch import tune

    out = tmp_path / "plan.json"
    argv = ["--x", "16", "--y", "16", "--z", "16", "--devices",
            ",".join(CPU4), "--fake-timer", "--cache",
            str(tmp_path / "c.json"), "--json", str(out), "--depths", "1,2"]
    assert tune.main(argv) == 0
    text = capsys.readouterr().out
    assert text.startswith("autotune: ") and "provenance=tuned" in text
    rec = json.loads(out.read_text())
    assert pt.Plan.from_record(rec).provenance == "tuned"
    assert tune.main(argv) == 0
    assert "provenance=cached measurements=0" in capsys.readouterr().out


def test_profiling_reports(tmp_path, monkeypatch):
    from stencil_tpu_torch.utils.profiling import (PhaseTimer,
                                                   autotune_report,
                                                   exchange_stats_report,
                                                   setup_stats_report)

    _fake_tuner(monkeypatch, tmp_path / "p.json")
    dd = _domain()
    dd.set_methods(Method.Auto)
    dd.realize()
    assert setup_stats_report(dd).startswith("setup: partition=")
    assert exchange_stats_report(dd).startswith("exchange: no samples")
    dd.enable_timing(True)
    for _ in range(3):
        dd.exchange()
    line = exchange_stats_report(dd)
    assert "expected=" in line and line.endswith("plan=tuned")
    rep = autotune_report(dd.plan)
    assert rep.splitlines()[0].startswith(
        f"autotune: {dd.plan.config.key()} provenance=tuned")
    pt_ = PhaseTimer()
    with pt_.phase("a"):
        pass
    assert set(pt_.reduced()) == {"a"}


def test_domain_adapters_equal_jax(jt):
    """``geometry_from_domain`` and ``inputs_from_domain`` of a port
    domain against JAX's of the same configuration: the same geometry,
    the same identity but for the platform and the library version."""
    import jax

    from stencil_tpu.distributed import DistributedDomain as JDomain
    from stencil_tpu.geometry import Dim3 as JDim3

    for size, mesh, dtypes in (((16, 16, 16), (2, 2, 2), ("float32",)),
                               ((17, 16, 15), (1, 2, 4),
                                ("float32", "float64"))):
        jd = JDomain(*size, devices=jax.devices()[:8])
        pd = DistributedDomain(*size, devices=["cpu"] * 8)
        for d in (jd, pd):
            d.set_mesh_shape(mesh)
            d.set_radius(2)
            for i, dt in enumerate(dtypes):
                d.add_data(f"q{i}", np.dtype(dt) if d is jd
                           else getattr(torch, dt))
        got = pt.geometry_from_domain(pd, Dim3(*mesh))
        want = jt.geometry_from_domain(jd, JDim3(*mesh))
        assert (got.shard_interior_zyx, got.min_interior_zyx,
                tuple(got.counts), got.elem_sizes, got.uneven,
                got.nonperiodic, got.dtype_strs) == \
            (want.shard_interior_zyx, want.min_interior_zyx,
             tuple(want.counts), want.elem_sizes, want.uneven,
             want.nonperiodic, want.dtype_strs)
        gi = pt.inputs_from_domain(pd, Dim3(*mesh))
        wi = jt.inputs_from_domain(jd, JDim3(*mesh))
        assert gi["platform"] == wi["platform"] == "cpu"
        assert gi.pop("library_version") != wi.pop("library_version")
        assert gi == wi


def test_tiling_record_is_the_port_planners_launch():
    """``Plan.tiling`` holds the launch the port's own planners choose
    (the ring kernel at N = 2, the B6 grouping verdict, B8's ring), not
    JAX's TPU VMEM blocks; float64 shards take no CUDA kernel."""
    from stencil_tpu_torch.ops.cuda_stencil import (jacobi_ring_plan,
                                                    laplace6_plan)
    from stencil_tpu_torch.ops.halo_plan import pair_halo_refusal

    g = GEOMS[3]
    rec = pt.tiling_record(g)
    ring = jacobi_ring_plan(256, 256, 512, 2, 132, 4)
    assert rec["jacobi_ring_kernel"] == {
        "steps": 2, "tile_y": ring.ty, "depth": ring.depth,
        "zrun": ring.zrun, "blocks_per_sm": ring.blocks_per_sm,
        "modeled_hbm_s_per_step": 4 * 256 * 256 * 512 / 3.35e12}
    assert rec["jacobi7_halon_grouping"]["grouped"] == (
        pair_halo_refusal(256, 256, 512, 4, 2) is None)
    assert rec["laplace6_ring_kernel"]["zrun"] == \
        laplace6_plan(256, 256, 512, 132).zrun
    f64 = pt.TuneGeometry((8, 8, 8), (8, 8, 8), Radius.constant(1),
                          Dim3(1, 1, 1), (8,))
    assert "infeasible" in pt.tiling_record(f64)["jacobi_ring_kernel"]


def test_reports_equal_jax(jt):
    """``autotune_report`` of a plan record and
    ``exchange_stats_report`` of the same samples and byte model print
    JAX's lines."""
    import jax

    from stencil_tpu.distributed import DistributedDomain as JDomain
    from stencil_tpu.tuning.plan import Plan as JPlan
    from stencil_tpu.utils import profiling as jprof
    from stencil_tpu_torch.utils import profiling as pprof

    rec = pt.run_autotune(GEOMS[0], dict(INPUTS), pt.FakeTimer(),
                          read_cache=False, write_cache=False,
                          runnable=_everything).to_record()
    assert pprof.autotune_report(pt.Plan.from_record(rec)) == \
        jprof.autotune_report(JPlan.from_record(rec))
    jd = JDomain(16, 16, 16, devices=jax.devices()[:4])
    pd = DistributedDomain(16, 16, 16, devices=CPU4)
    for d in (jd, pd):
        d.set_mesh_shape((2, 2, 1))
        d.set_radius(1)
        d.set_exchange_every(2)
        d.add_data("a", np.float32 if d is jd else torch.float32)
        d.realize()
        d.exchange_seconds = [3e-4, 1e-4, 2e-4, 5e-4]
    assert pprof.exchange_stats_report(pd) == \
        jprof.exchange_stats_report(jd)
    jd.plan = pd.plan = pt.Plan.from_record(rec)
    assert pprof.exchange_stats_report(pd) == \
        jprof.exchange_stats_report(jd)
    assert pprof.setup_stats_report(pd).split("=")[0] == \
        jprof.setup_stats_report(jd).split("=")[0]


@pytest.mark.parametrize("kernel", ["xla", "halo"])
def test_astaroth_auto_equals_named_winner(tmp_path, monkeypatch, kernel):
    """``Astaroth`` built with ``Method.Auto`` runs the winner, bitwise
    the same run with it named; only ``xla`` takes a tuned depth (the
    kernel paths keep their own substep grouping)."""
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth

    _fake_tuner(monkeypatch, tmp_path / "p.json",
                pt.FakeTimer(scale={"PpermutePacked": 0.1}))
    kw = dict(mesh_shape=(1, 2, 2), devices=CPU4, kernel=kernel,
              dtype=torch.float64)
    a = Astaroth(16, 16, 16, methods=Method.Auto, **kw)
    win = a.dd.plan.config
    assert win.method == "PpermutePacked"
    assert win.exchange_every == (2 if kernel == "xla" else 1)
    b = Astaroth(16, 16, 16, methods=Method[win.method],
                 exchange_every=win.exchange_every, **kw)
    for m in (a, b):
        m.init()
        m.run(2)
    for q in FIELDS:
        np.testing.assert_array_equal(a.field(q), b.field(q))
