"""The port's link observatory (``stencil_tpu_torch/observatory/
linkmap.py``) against the JAX package's
``stencil_tpu/observatory/linkmap.py``: the traffic matrices of every
method (uniform and per-axis depths, both wire layouts, the all-gather,
the migration ring and the PIC step), their link classes (with and
without a DCN tier), the placement-quality report on JAX's registered
meshes, the measured topology fingerprint under ``FakeTimer`` and a
realized domain's live attribution inputs — all equal to JAX's. The
placement module now reads ``mesh_distance_matrix`` from here, as JAX's
does.
"""

import json

import numpy as np
import pytest
import torch

from stencil_tpu_torch import Dim3, Radius
from stencil_tpu_torch.analysis.costmodel import LinkCoefficients
from stencil_tpu_torch.observatory import linkmap as lm
from torch_port_support import reference_modules


@pytest.fixture(scope="module")
def jlm():
    with reference_modules():
        from stencil_tpu.observatory import linkmap as jax_linkmap

        yield jax_linkmap


def _jr(fr, er, cr):
    from stencil_tpu.geometry import Radius as JRadius

    return JRadius.face_edge_corner(fr, er, cr)


def _jd(*v):
    from stencil_tpu.geometry import Dim3 as JDim3

    return JDim3(*v)


def _same_matrix(got, want):
    np.testing.assert_array_equal(got.matrix(), want.matrix())
    assert got.per_shard_bytes() == want.per_shard_bytes()
    assert got.axis_bytes() == want.axis_bytes()
    assert got.direction_class_bytes() == want.direction_class_bytes()
    assert [(e.src, e.dst, e.axis, e.side, e.nbytes, e.class_bytes)
            for e in got.edges] == \
        [(e.src, e.dst, e.axis, e.side, e.nbytes, e.class_bytes)
         for e in want.edges]


CASES = [((16, 16, 16), (2, 2, 2), (1, 1, 1)),
         ((32, 8, 24), (1, 2, 4), (2, 1, 0)),
         ((12, 20, 16), (4, 2, 1), (3, 2, 1)),
         ((16, 16, 32), (1, 1, 8), (2, 2, 2))]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("method", ["PpermuteSlab", "PallasDMA",
                                    "AllGather"])
def test_method_traffic_equals_jax(jlm, case, method):
    shard, counts, r = case
    for steps in (1, 2, (1, 1, 2), {"x": 2}):
        for layout in ("slab", "irredundant"):
            if method == "AllGather" and layout != "slab":
                continue
            got = lm.method_traffic(method, shard, Radius.face_edge_corner(
                *r), Dim3(*counts), (4, 8), steps=steps, wire_layout=layout)
            want = jlm.method_traffic(method, shard, _jr(*r),
                                      _jd(*counts), (4, 8), steps=steps,
                                      wire_layout=layout)
            _same_matrix(got, want)


@pytest.mark.parametrize("case", CASES)
def test_sweep_migration_and_pic_traffic(jlm, case):
    shard, counts, r = case
    pr, jr = Radius.face_edge_corner(*r), _jr(*r)
    padded = tuple(s + 2 * max(r) for s in shard)
    for reverse in (False, True):
        _same_matrix(lm.sweep_traffic(padded, pr, Dim3(*counts), (4,),
                                      reverse=reverse),
                     jlm.sweep_traffic(padded, jr, _jd(*counts), (4,),
                                       reverse=reverse))
    _same_matrix(lm.allgather_traffic(shard, pr, Dim3(*counts), (8,)),
                 jlm.allgather_traffic(shard, jr, _jd(*counts), (8,)))
    _same_matrix(lm.migration_traffic(Dim3(*counts), 7, 33, 4),
                 jlm.migration_traffic(_jd(*counts), 7, 33, 4))
    _same_matrix(lm.pic_traffic(shard, pr, Dim3(*counts), 4, 7, 33),
                 jlm.pic_traffic(shard, jr, _jd(*counts), 4, 7, 33))
    with pytest.raises(ValueError):
        lm.sweep_traffic(padded, pr, Dim3(*counts), (4,),
                         pads_included=False, layout="irredundant")


@pytest.mark.parametrize("case,dcn", [
    (c, d) for c in CASES for d in (None, ("z", 2), (0, 2))
    if d is None or c[1][lm._axis_index(d[0])] % d[1] == 0])
def test_classify_equals_jax(jlm, case, dcn):
    shard, counts, r = case
    dcn_axis, n_slices = dcn if dcn else (None, 1)
    got = lm.classify(lm.method_traffic("PpermuteSlab", shard,
                                        Radius.face_edge_corner(*r),
                                        Dim3(*counts), (4,)),
                      dcn_axis=dcn_axis, n_slices=n_slices,
                      rounds_per_step=0.5)
    want = jlm.classify(jlm.method_traffic("PpermuteSlab", shard, _jr(*r),
                                           _jd(*counts), (4,)),
                        dcn_axis=dcn_axis, n_slices=n_slices,
                        rounds_per_step=0.5)
    assert got.to_record() == want.to_record()
    assert got.link_bytes_per_step() == want.link_bytes_per_step()
    assert lm.render_summary(got) == jlm.render_summary(want)


def test_distance_matrix_and_render(jlm):
    for counts in ((2, 2, 2), (1, 2, 4), (3, 1, 2)):
        for dcn in (None, 2):
            np.testing.assert_array_equal(
                lm.mesh_distance_matrix(Dim3(*counts), dcn_axis=dcn,
                                        n_slices=2),
                jlm.mesh_distance_matrix(_jd(*counts), dcn_axis=dcn,
                                         n_slices=2))
    tm = lm.method_traffic("PpermuteSlab", (8, 8, 8), Radius.constant(1),
                           Dim3(2, 2, 1), (4,))
    jtm = jlm.method_traffic("PpermuteSlab", (8, 8, 8),
                             _jr(1, 1, 1), _jd(2, 2, 1), (4,))
    assert lm.render_heatmap(tm) == jlm.render_heatmap(jtm)
    from stencil_tpu_torch import placement

    assert placement.mesh_distance_matrix is lm.mesh_distance_matrix


def test_placement_report_equals_jax(jlm):
    """QAP and deployed placement against trivial on JAX's registered
    meshes, row for row (JAX scores coordless stand-in devices, the port
    CPU devices: both uniform fabrics)."""
    for radius, jradius, sizes in ((Radius.constant(1), _jr(1, 1, 1),
                                    (4,)),
                                   (Radius.face_edge_corner(2, 1, 1),
                                    _jr(2, 1, 1), (4, 8))):
        got = lm.placement_report(lm.REGISTERED_MESHES, radius, sizes)
        want = jlm.placement_report(jlm.REGISTERED_MESHES, jradius, sizes)
        assert got == want and got["ok"]


def test_topology_fingerprint_round_trip(jlm, tmp_path):
    from stencil_tpu.analysis.costmodel import LinkCoefficients as JLink
    from stencil_tpu.tuning import FakeTimer as JFake
    from stencil_tpu_torch.tuning import FakeTimer

    inputs = lm.topology_fingerprint_inputs("cpu", 8, [2, 1, 4], 2)
    assert inputs == jlm.topology_fingerprint_inputs("cpu", 8, [2, 1, 4],
                                                     2)
    axis = {"x": (2e-6, 1e11), "z": (9e-5, 2e9)}
    got = lm.measure_topology(
        FakeTimer(axis_coeffs={k: LinkCoefficients(*v)
                               for k, v in axis.items()}),
        [2, 1, 4], inputs, dcn_axis=2, created=5.0)
    want = jlm.measure_topology(
        JFake(axis_coeffs={k: JLink(*v) for k, v in axis.items()}),
        [2, 1, 4], inputs, dcn_axis=2, created=5.0)
    assert json.dumps(got, sort_keys=True) == \
        json.dumps(want, sort_keys=True)
    path = tmp_path / "topo.json"
    lm.save_topology(got, path)
    assert jlm.load_topology(got["fingerprint"], path) == want
    assert lm.load_topology(got["fingerprint"], path) == got
    assert lm.load_topology("0" * 32, path) is None
    coeffs = lm.topology_coefficients(got)
    assert set(coeffs) == {"x", "z", "dcn"}
    with pytest.raises(ValueError):
        lm.save_topology({"schema": 1}, path)
    path.write_text("garbage")
    assert lm.load_topology(got["fingerprint"], path) is None


def test_topology_feeds_the_tuner(tmp_path):
    """``autotune_domain`` with a topology path measures the per-axis
    fit once, saves it, and a second tune reads it (no ring shifts)."""
    from stencil_tpu_torch.distributed import DistributedDomain
    from stencil_tpu_torch.tuning import FakeTimer, autotune_domain

    def dom():
        dd = DistributedDomain(16, 16, 16, devices=["cpu"] * 4)
        dd.set_mesh_shape((2, 2, 1))
        dd.set_radius(1)
        dd.add_data("t", torch.float32)
        return dd

    topo = tmp_path / "topo.json"
    plan = autotune_domain(dom(), timer=FakeTimer(), use_cache=False,
                           topology_path=topo, depths=(1,))
    assert set(plan.coefficients) == {"x", "y"} and topo.exists()
    saved = topo.read_text()
    plan2 = autotune_domain(dom(), timer=FakeTimer(), use_cache=False,
                            topology_path=topo, depths=(1,))
    # the candidates are timed, no ring shift is counted (JAX's count),
    # and the second tune reads the stored fit
    assert plan.measurements == plan2.measurements == 4
    assert topo.read_text() == saved
    assert plan2.coefficients == plan.coefficients


def test_link_attribution_equals_jax(jlm):
    """A realized domain's per-(axis, link class) bytes a step and
    per-axis peaks, against JAX's domain of the same configuration with
    the same plan coefficients."""
    import jax

    from stencil_tpu.distributed import DistributedDomain as JDomain
    from stencil_tpu.tuning.plan import Candidate as JCand, Plan as JPlan
    from stencil_tpu_torch.distributed import DistributedDomain
    from stencil_tpu_torch.tuning import Plan

    jplan = JPlan(config=JCand("PpermuteSlab", 2), fingerprint="e" * 32,
                  coefficients={"ici": {"alpha_s": 1e-5,
                                        "beta_bytes_per_s": 3e10},
                                "y": {"alpha_s": 2e-5,
                                      "beta_bytes_per_s": 7e9}},
                  costs={})
    jd = JDomain(16, 16, 32, devices=jax.devices()[:8])
    pd = DistributedDomain(16, 16, 32, devices=["cpu"] * 8)
    for d in (jd, pd):
        d.set_mesh_shape((2, 2, 2))
        d.set_radius(1)
        d.add_data("a", np.float32 if d is jd else torch.float32)
    jd.apply_plan(jplan)
    pd.apply_plan(Plan.from_record(jplan.to_record()))
    jd.realize()
    pd.realize()
    got, want = lm.link_attribution_for(pd), jlm.link_attribution_for(jd)
    assert got == want and got["peak_bytes_per_s"]["y"] == 7e9
    one = DistributedDomain(8, 8, 8, devices=["cpu"])
    one.set_radius(1)
    one.add_data("a", torch.float32)
    one.realize()
    assert lm.link_attribution_for(one) is None


def test_linkmap_cli(tmp_path, capsys):
    from stencil_tpu_torch.observatory.__main__ import main

    out = tmp_path / "lm.json"
    assert main(["linkmap", "--mesh", "2,2,1", "--exchange-every",
                 "z=1,y=2,x=1", "--placement-report", "--json",
                 str(out)]) == 0
    text = capsys.readouterr().out
    assert "placement gate OK" in text and "link classes" in text
    payload = json.loads(out.read_text())
    assert payload["kind"] == "linkmap" and payload["placement_report"]["ok"]
    with pytest.raises(SystemExit):
        main(["linkmap", "--mesh", "2,2,2", "--grid", "15,16,16"])
