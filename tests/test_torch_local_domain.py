"""The port's ``LocalDomain`` class layer and region queries
(``stencil_tpu_torch/local_domain.py``, ``DistributedDomain.
domain_view / get_interior / get_exterior / get_compute_region``)
against the JAX package's, for the radii JAX's
``tests/test_local_domain.py`` uses (constant 1 and 2, face/edge/corner
(2,1,1) and (1,1,3), and the asymmetric +x 2 / -x 1 radius).

Geometry is compared exactly (every rect, every halo position, extent
and byte count); the padded tensors and accessors bitwise against
JAX's arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.distributed import DistributedDomain as JDomain
from stencil_tpu.geometry import Dim3 as JDim3, Radius as JRadius
from stencil_tpu.local_domain import (LocalDomain as JLocalDomain,
                                      get_exterior as j_exterior,
                                      get_interior as j_interior,
                                      interior_shrink as j_shrink)
from stencil_tpu_torch import Radius
from stencil_tpu_torch.distributed import DistributedDomain
from stencil_tpu_torch.geometry import all_directions
from stencil_tpu_torch.local_domain import (Accessor, LocalDomain,
                                            get_exterior, get_interior,
                                            interior_shrink)

jax.config.update("jax_platforms", "cpu")


def _asym(R):
    r = R.constant(0)
    r.set_dir((1, 0, 0), 2)
    r.set_dir((-1, 0, 0), 1)
    return r


RADII = {
    "c1": lambda R: R.constant(1),
    "c2": lambda R: R.constant(2),
    "fec211": lambda R: R.face_edge_corner(2, 1, 1),
    "fec113": lambda R: R.face_edge_corner(1, 1, 3),
    "asym": _asym,
}


def _rect(r):
    return (tuple(r.lo), tuple(r.hi))


@pytest.mark.parametrize("rname", list(RADII))
@pytest.mark.parametrize("sz,origin", [((10, 10, 10), (0, 0, 0)),
                                       ((4, 6, 5), (10, 20, 30))])
def test_local_domain_geometry_equals_jax(rname, sz, origin):
    jd = JLocalDomain(sz, origin, RADII[rname](JRadius))
    pd = LocalDomain(sz, origin, RADII[rname](Radius), device="cpu")
    assert tuple(pd.raw_size()) == tuple(jd.raw_size())
    assert tuple(pd.size()) == tuple(jd.size())
    for d in all_directions():
        jdir = JDim3(*d)
        for halo in (True, False):
            assert tuple(pd.halo_pos(d, halo)) == tuple(
                jd.halo_pos(jdir, halo))
            assert _rect(pd.halo_coords(d, halo)) == _rect(
                jd.halo_coords(jdir, halo))
        assert tuple(pd.halo_extent(d)) == tuple(jd.halo_extent(jdir))
    assert _rect(pd.get_compute_region()) == _rect(jd.get_compute_region())
    assert _rect(get_interior(pd)) == _rect(j_interior(jd))
    assert [_rect(r) for r in get_exterior(pd)] == \
        [_rect(r) for r in j_exterior(jd)]
    lo, hi = interior_shrink(pd.radius)
    jlo, jhi = j_shrink(jd.radius)
    assert (tuple(lo), tuple(hi)) == (tuple(jlo), tuple(jhi))
    assert pd.interior_slices() == jd.interior_slices()


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_realize_accessors_and_host_copies_equal_jax(dtype):
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    jd = JLocalDomain((4, 5, 6), (10, 20, 30), JRadius.constant(1))
    pd = LocalDomain((4, 5, 6), (10, 20, 30), Radius.constant(1),
                     device="cpu")
    for d, dt in ((jd, jdt), (pd, tdt)):
        d.add_data("a", dt)
        d.add_data("b", dt)
        d.realize()
    assert pd.names == jd.names and pd.num_data() == jd.num_data() == 2
    assert pd.elem_size("a") == jd.elem_size("a")
    for d in all_directions():
        assert pd.halo_bytes(d, "a") == jd.halo_bytes(JDim3(*d), "a")
    vals = np.arange(np.prod(pd.curr["a"].shape), dtype=np.float32
                     ).reshape(pd.curr["a"].shape) / 7
    jd.curr["a"] = jnp.asarray(vals, dtype=jdt)
    pd.curr["a"].copy_(torch.from_numpy(vals).to(tdt))
    assert pd.curr["a"].device == torch.device("cpu")
    np.testing.assert_array_equal(
        pd.interior_to_host("a"),
        np.asarray(jd.interior_to_host("a"), dtype=np.float32))
    np.testing.assert_array_equal(
        pd.quantity_to_host("a"),
        np.asarray(jd.quantity_to_host("a"), dtype=np.float32))
    ja, pa = jd.get_curr_accessor("a"), pd.get_curr_accessor("a")
    for p in [(9, 19, 29), (10, 20, 30), (13, 24, 35), (14, 25, 36)]:
        assert float(pa[p]) == float(ja[p])
    jd.curr["a"] = ja.set((11, 21, 31), 5.0)
    pa.set((11, 21, 31), 5.0)
    np.testing.assert_array_equal(
        pd.quantity_to_host("a"),
        np.asarray(jd.quantity_to_host("a"), dtype=np.float32))
    jd.swap()
    pd.swap()
    assert float(pd.get_next_accessor("a")[(11, 21, 31)]) == 5.0
    assert float(pd.get_curr_accessor("a")[(11, 21, 31)]) == 0.0
    assert isinstance(pa, Accessor)


@pytest.mark.parametrize("rname", ["c1", "c2", "fec211", "asym"])
@pytest.mark.parametrize("size,mesh", [((16, 16, 16), (1, 2, 2)),
                                       ((15, 17, 16), (2, 2, 2))])
def test_domain_region_queries_equal_jax(rname, size, mesh):
    n = int(np.prod(mesh))
    jd = JDomain(*size, devices=jax.devices()[:n])
    pd = DistributedDomain(*size, devices=["cpu"] * n)
    for d, R, dt in ((jd, JRadius, np.float32), (pd, Radius,
                                                  torch.float32)):
        d.set_radius(RADII[rname](R))
        d.set_mesh_shape(mesh)
        d.add_data("q", dt)
        d.realize()
    assert pd.num_subdomains() == jd.num_subdomains() == n
    assert [_rect(r) for r in pd.get_interior()] == \
        [_rect(r) for r in jd.get_interior()]
    assert [[_rect(r) for r in e] for e in pd.get_exterior()] == \
        [[_rect(r) for r in e] for e in jd.get_exterior()]
    assert _rect(pd.get_compute_region()) == _rect(jd.get_compute_region())
    for i in range(n):
        pv, jv = pd.domain_view(i), jd.domain_view(i)
        assert _rect(pv.get_compute_region()) == \
            _rect(jv.get_compute_region())
        assert pv.names == jv.names and pv.device == torch.device("cpu")


def test_realize_needs_an_explicit_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = LocalDomain((4, 4, 4), (0, 0, 0), Radius.constant(1))
    d.add_data("a")
    with pytest.raises(RuntimeError):
        d.realize()
