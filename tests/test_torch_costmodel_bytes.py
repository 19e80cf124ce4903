"""The byte and time model of the port's ``analysis/costmodel.py``
(the deep exchange's bytes and their amortization, the migration's wire
bill, the per-step seconds of a configuration and the depth crossover)
against the JAX package's ``stencil_tpu/analysis/costmodel.py``, over a
grid of geometries, to rel 1e-12.

The two packages' default link coefficients differ (the port's price an
H100 host, JAX's a TPU), so every priced case passes the same explicit
``LinkCoefficients`` to both. The JAX module is imported under
``torch_port_support.reference_modules`` (jax 0.9 moved the
``jax.core`` names its analysis package reads).
"""

import itertools

import pytest

from stencil_tpu_torch import Dim3, Radius
from stencil_tpu_torch.analysis import costmodel as cm
from torch_port_support import reference_modules

REL = 1e-12

#: (shard interior (z, y, x), mesh counts (x, y, z), (fr, er, cr))
GEOMETRIES = [
    ((16, 16, 16), (2, 2, 2), (1, 1, 1)),
    ((32, 16, 8), (1, 2, 4), (2, 1, 0)),
    ((24, 20, 28), (4, 1, 2), (3, 3, 3)),
    ((8, 40, 12), (2, 1, 1), (1, 0, 0)),
    ((64, 32, 32), (1, 1, 8), (2, 2, 2)),
]

#: (alpha, beta) pairs priced in both packages
LINKS = [(1e-5, 4e10), (1.1941886173898174e-04, 1.7329498110167914e+11)]


@pytest.fixture(scope="module")
def jcm():
    with reference_modules():
        from stencil_tpu.analysis import costmodel as jax_costmodel

        yield jax_costmodel


def _both(counts, radius):
    from stencil_tpu.geometry import Dim3 as JDim3, Radius as JRadius

    fr, er, cr = radius
    return ((Dim3(*counts), Radius.face_edge_corner(fr, er, cr)),
            (JDim3(*counts), JRadius.face_edge_corner(fr, er, cr)))


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0), (a, b)


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("layout", ["slab", "irredundant"])
def test_deep_and_amortized_bytes(jcm, geom, layout):
    shard, counts, r = geom
    (pc, pr), (jc, jr) = _both(counts, r)
    for es, s in itertools.product((2, 4, 8), (1, 2, 3)):
        if any(s * max(r) > d for d in shard):
            continue
        assert cm.deep_exchange_bytes_per_shard(
            shard, pr, pc, es, s, layout) == \
            jcm.deep_exchange_bytes_per_shard(shard, jr, jc, es, s, layout)
        _close(cm.amortized_step_wire_bytes(shard, pr, pc, es, s, layout),
               jcm.amortized_step_wire_bytes(shard, jr, jc, es, s, layout))


@pytest.mark.parametrize("counts", [(1, 1, 1), (2, 1, 1), (2, 2, 2),
                                    (1, 4, 2)])
@pytest.mark.parametrize("link", LINKS)
def test_migration_bill(jcm, counts, link):
    from stencil_tpu.geometry import Dim3 as JDim3

    pc, jc = Dim3(*counts), JDim3(*counts)
    for n_fields, budget, es in ((7, 64, 4), (7, 1000, 8), (3, 5, 2)):
        assert cm.migration_record_rows(n_fields) == \
            jcm.migration_record_rows(n_fields)
        assert cm.migration_wire_bytes_per_shard(
            n_fields, budget, pc, es) == \
            jcm.migration_wire_bytes_per_shard(n_fields, budget, jc, es)
        _close(cm.migration_step_seconds(
                   n_fields, budget, pc, es, cm.LinkCoefficients(*link)),
               jcm.migration_step_seconds(
                   n_fields, budget, jc, es, jcm.LinkCoefficients(*link)))


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("link", LINKS)
def test_temporal_step_and_crossover(jcm, geom, link):
    shard, counts, r = geom
    (pc, pr), (jc, jr) = _both(counts, r)
    alpha, beta = link
    for es in (4, 8):
        for s in (1, 2):
            _close(cm.temporal_step_exchange_seconds(
                       shard, pr, pc, es, s, 6 * alpha, beta),
                   jcm.temporal_step_exchange_seconds(
                       shard, jr, jc, es, s, 6 * alpha, beta))
        got = cm.predict_exchange_every(shard, pr, pc, es, 6 * alpha, beta)
        want = jcm.predict_exchange_every(shard, jr, jc, es, 6 * alpha,
                                          beta)
        assert got[0] == want[0] and got[1].keys() == want[1].keys()
        for k in want[1]:
            _close(got[1][k], want[1][k])


def test_predict_exchange_every_refuses_what_does_not_fit(jcm):
    (pc, pr), (jc, jr) = _both((2, 2, 2), (3, 3, 3))
    for mod, c, r in ((cm, pc, pr), (jcm, jc, jr)):
        with pytest.raises(ValueError, match="no candidate depth"):
            mod.predict_exchange_every((2, 2, 2), r, c, 4, 1e-5, 1e10)
        with pytest.raises(ValueError, match="no candidate depth"):
            mod.predict_exchange_depths((2, 2, 2), r, c, 4)


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("dcn_axis", [None, 0, 2])
def test_predict_exchange_depths_per_link(jcm, geom, dcn_axis):
    shard, counts, r = geom
    (pc, pr), (jc, jr) = _both(counts, r)
    pl = {"ici": cm.LinkCoefficients(2e-6, 1e11),
          "dcn": cm.LinkCoefficients(1e-4, 1e10),
          "y": cm.LinkCoefficients(3e-6, 5e10)}
    jl = {k: jcm.LinkCoefficients(v.alpha_s, v.beta_bytes_per_s)
          for k, v in pl.items()}
    cands = (1, 2, {"z": 4}, (1, 2, 2), {"x": 2, "y": 1, "z": 1})
    got = cm.predict_exchange_depths(shard, pr, pc, 4, pl, dcn_axis, cands)
    want = jcm.predict_exchange_depths(shard, jr, jc, 4, jl, dcn_axis,
                                       cands)
    assert tuple(got[0]) == tuple(want[0])
    assert list(got[1]) == list(want[1])
    for k in want[1]:
        _close(got[1][k], want[1][k])


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("method", ["PpermuteSlab", "PpermutePacked",
                                    "PallasDMA", "AllGather"])
def test_configured_step_seconds(jcm, geom, method):
    shard, counts, r = geom
    (pc, pr), (jc, jr) = _both(counts, r)
    alpha, beta = LINKS[0]
    pone = cm.LinkCoefficients(alpha, beta)
    jone = jcm.LinkCoefficients(alpha, beta)
    pl = {"ici": pone, "dcn": cm.LinkCoefficients(1e-4, 1e9)}
    jl = {"ici": jone, "dcn": jcm.LinkCoefficients(1e-4, 1e9)}
    for elem_sizes, groups in (((4,), None), ((4, 4, 8), 2),
                               ((2, 4), None)):
        for steps in (1, 2, (1, 1, 2), {"z": 2}):
            if any(max(r) * 2 > d for d in shard):
                continue
            for wf, wl in ((None, "slab"), ("bf16", "irredundant")):
                _close(cm.configured_step_seconds(
                           method, shard, pr, pc, elem_sizes, steps, pone,
                           groups, wire_format=wf, wire_layout=wl),
                       jcm.configured_step_seconds(
                           method, shard, jr, jc, elem_sizes, steps, jone,
                           groups, wire_format=wf, wire_layout=wl))
            _close(cm.configured_step_seconds(
                       method, shard, pr, pc, elem_sizes, steps, pl, groups,
                       dcn_axis=2),
                   jcm.configured_step_seconds(
                       method, shard, jr, jc, elem_sizes, steps, jl, groups,
                       dcn_axis=2))
