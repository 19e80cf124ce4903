"""The port's host (DCN) tier, in one process, against the JAX package's.

``parallel/multihost.py``'s device order and mesh, ``default_mesh_shape_
dcn``, the alpha-beta cost model of ``analysis/costmodel.py``,
``DistributedDomain.set_dcn_axis``'s planner, and the models' x-free
halo mesh under the tier, each against JAX's on the same inputs. JAX's
devices are the 8 fake CPU devices, grouped into fake slices; the port's
are eight ``GlobalDevice``s whose ranks are the JAX device ids, so that
a position's slice reads the same in both. The planner's comparisons
put JAX's (TPU) link constants into the port's cost model; every call
that reaches JAX's planner runs under ``reference_block_planner()``
(``stencil_tpu/analysis`` reads ``jax.core.Jaxpr``, gone in jax 0.9).
Tolerance: exact (integers, and floats computed in the same order).
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.geometry import Dim3 as JDim3, Radius as JRadius
from stencil_tpu.parallel.mesh import (
    default_mesh_shape_dcn as j_default_mesh_shape_dcn)
from stencil_tpu.parallel.multihost import (
    make_multihost_mesh as j_make_multihost_mesh,
    multihost_device_order as j_multihost_device_order)
from stencil_tpu_torch import Dim3, Radius
from stencil_tpu_torch.analysis import costmodel
from stencil_tpu_torch.distributed import DistributedDomain
from stencil_tpu_torch.parallel.mesh import GlobalDevice, default_mesh_shape_dcn
from stencil_tpu_torch.parallel.multihost import (make_multihost_mesh,
                                                  multihost_device_order,
                                                  slice_groups)
from torch_port_support import reference_block_planner

jax.config.update("jax_platforms", "cpu")

#: JAX's assumed TPU link constants (stencil_tpu/analysis/costmodel.py
#: DEFAULT_ICI_COEFFS, DEFAULT_DCN_COEFFS), lent to the port's model
JAX_ICI = costmodel.LinkCoefficients(alpha_s=20e-6, beta_bytes_per_s=4.5e10)
JAX_DCN = costmodel.LinkCoefficients(alpha_s=200e-6,
                                     beta_bytes_per_s=1.25e10)


@pytest.fixture
def jax_links(monkeypatch):
    monkeypatch.setattr(costmodel, "DEFAULT_ICI_COEFFS", JAX_ICI)
    monkeypatch.setattr(costmodel, "DEFAULT_DCN_COEFFS", JAX_DCN)


def fake_devices(n=8, per_host=4):
    """Rank k's CPU device, on host k // per_host."""
    return [GlobalDevice(k, f"host{k // per_host}", torch.device("cpu"))
            for k in range(n)]


def split(seq, sizes):
    out, k = [], 0
    for s in sizes:
        out.append(list(seq[k:k + s]))
        k += s
    return out


@pytest.mark.parametrize("shape,axis,per", [((2, 2, 2), 2, 4),
                                            ((4, 2, 1), 0, 2),
                                            ((1, 2, 4), 2, 2),
                                            ((2, 4, 1), 1, 4)])
def test_device_order_and_mesh_equal_jax(shape, axis, per):
    """Host blocking on fake groups (2 x 4 blocking z, 4 x 2 blocking x
    as JAX's tests, and two more): the same device at every position,
    and the port's Mesh owners are those devices' ranks."""
    jd = jax.devices()[:8]
    pd = fake_devices()
    jg = split(jd, [per] * (8 // per))
    pg = split(pd, [per] * (8 // per))
    want = [d.id for d in j_multihost_device_order(shape, axis, groups=jg)]
    got = [g.rank for g in multihost_device_order(shape, axis, groups=pg)]
    assert got == want
    jm = j_make_multihost_mesh(shape, axis, groups=jg)
    pm = make_multihost_mesh(shape, axis, groups=pg)
    assert pm.ranks == tuple(
        jm.devices[i % shape[0], (i // shape[0]) % shape[1],
                   i // (shape[0] * shape[1])].id for i in range(8))
    assert pm.spans_ranks and pm.local_positions == [want.index(0)]


def test_device_order_validates_as_jax():
    """JAX ``tests/test_multihost.py:45-52``: an axis the slice count
    does not divide, and uneven groups, raise ValueError in both."""
    jd, pd = jax.devices()[:8], fake_devices()
    for make, d in ((j_make_multihost_mesh, jd), (make_multihost_mesh, pd)):
        with pytest.raises(ValueError):
            make((1, 1, 8), dcn_axis=0, groups=[d[:4], d[4:]])
        with pytest.raises(ValueError):
            make((2, 2, 2), dcn_axis=2, groups=[d[:3], d[3:]])


def test_slice_groups_group_by_host():
    """One group per host, in rank order; one host is one group."""
    pd = fake_devices(8, per_host=2)
    assert [[g.rank for g in grp] for grp in slice_groups(pd[::-1])] == \
        [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert len(slice_groups(["cpu"] * 4)) == 1


def test_default_mesh_shape_dcn_equals_jax():
    """Every n <= 16, every slice count dividing it, every axis, both
    x-free and not; indivisible counts raise in both."""
    for n in range(1, 17):
        for s in range(1, n + 1):
            for axis, xfree in itertools.product(range(3), (False, True)):
                if n % s:
                    with pytest.raises(ValueError):
                        default_mesh_shape_dcn(n, s, axis, xfree)
                    continue
                assert tuple(default_mesh_shape_dcn(n, s, axis, xfree)) == \
                    tuple(j_default_mesh_shape_dcn(n, s, axis, xfree))


def _radii(r, asym):
    jr, pr = JRadius.constant(r), Radius.constant(r)
    if asym:
        for rad in (jr, pr):
            rad.set_dir((0, 0, 1), r + 1)
            rad.set_dir((0, -1, 0), 0)
    return jr, pr


COST_SHAPES = [(16, 8, 12), (7, 9, 5)]
COST_RADII = [(1, False), (3, False), (2, True)]
COST_CASES = list(itertools.product(
    ("PpermuteSlab", "PpermutePacked", "PallasDMA", "AllGather"),
    [(1, 1, 1), (2, 2, 2), (1, 2, 4), (4, 1, 1)]))


@pytest.mark.parametrize("method,counts", COST_CASES)
def test_alpha_beta_model_equals_jax(jax_links, method, counts):
    """``exchange_round_model``, ``per_axis_round_model``,
    ``asymmetric_group_bytes_per_shard`` and ``asymmetric_step_seconds``
    on two shard shapes, three radii (one asymmetric), depths 1, 2 and a
    per-axis one, every wire format and layout, with and without a
    host-blocked axis and explicit coefficients: equal to JAX's, floats
    included."""
    jc, pc = JDim3(*counts), Dim3(*counts)
    sizes = [4, 8] if method == "PpermutePacked" else [4]
    with reference_block_planner():
        from stencil_tpu.analysis import costmodel as jcm

        links = {
            None: (None, None),
            "dict": ({"ici": JAX_ICI, "dcn": JAX_DCN,
                      "x": costmodel.LinkCoefficients(1e-6, 1e9)},
                     {"ici": jcm.LinkCoefficients(20e-6, 4.5e10),
                      "dcn": jcm.LinkCoefficients(200e-6, 1.25e10),
                      "x": jcm.LinkCoefficients(1e-6, 1e9)}),
            "one": (JAX_ICI, jcm.LinkCoefficients(20e-6, 4.5e10))}
        for shape, rad, steps, wf, layout in itertools.product(
                COST_SHAPES, COST_RADII, (1, 2, {"z": 2}),
                (None, "bf16", {"y": "e4m3"}), ("slab", "irredundant")):
            if isinstance(steps, dict) and layout != "slab":
                continue
            jr, pr = _radii(*rad)
            if not isinstance(steps, dict):
                assert costmodel.exchange_round_model(
                    method, shape, pr, pc, sizes, steps, wire_format=wf,
                    wire_layout=layout) == jcm.exchange_round_model(
                    method, shape, jr, jc, sizes, steps, wire_format=wf,
                    wire_layout=layout)
            assert costmodel.per_axis_round_model(
                method, shape, pr, pc, sizes, steps, wire_format=wf,
                wire_layout=layout) == jcm.per_axis_round_model(
                method, shape, jr, jc, sizes, steps, wire_format=wf,
                wire_layout=layout)
            assert costmodel.asymmetric_group_bytes_per_shard(
                shape, pr, pc, 4, steps, wire_layout=layout) == \
                jcm.asymmetric_group_bytes_per_shard(
                    shape, jr, jc, 4, steps, wire_layout=layout)
            for dcn_axis, key in ((None, None), (2, None), (0, "dict"),
                                  (1, "one")):
                pk, jk = links[key]
                assert costmodel.asymmetric_step_seconds(
                    method, shape, pr, pc, sizes, steps, pk,
                    dcn_axis=dcn_axis, wire_format=wf,
                    wire_layout=layout) == jcm.asymmetric_step_seconds(
                    method, shape, jr, jc, sizes, steps, jk,
                    dcn_axis=dcn_axis, wire_format=wf, wire_layout=layout)


def test_port_link_defaults_are_its_own():
    """The port prices its own host, not a TPU: neither default is
    JAX's TPU constant."""
    assert costmodel.DEFAULT_ICI_COEFFS != JAX_ICI
    assert costmodel.DEFAULT_DCN_COEFFS != JAX_DCN


PLANNER_CASES = [((32, 16, 16), 2, None, None),
                 ((64, 32, 16), 4, None, None),
                 ((16, 16, 48), 2, None, None),
                 ((16, 16, 16), 2, "z", (2, 2, 2))]


@pytest.mark.parametrize("size,slices,axis,mesh", PLANNER_CASES)
def test_set_dcn_axis_equals_jax(jax_links, size, slices, axis, mesh):
    """``set_dcn_axis`` on 8 devices in ``slices`` fake slices: the
    planner's mesh (or the explicit one), the DCN axis, the slice count,
    every position's slice, and the whole-mesh DCN and intra-host bytes
    per exchange equal JAX's."""
    from stencil_tpu.distributed import DistributedDomain as JDomain

    jd, pd = jax.devices()[:8], fake_devices()
    per = 8 // slices
    with reference_block_planner():
        j = JDomain(*size, devices=jd)
        j.set_radius(1)
        j.set_dcn_axis(axis, groups=split(jd, [per] * slices))
        if mesh is not None:
            j.set_mesh_shape(mesh)
        j.add_data("q", np.float32)
        j.realize()
        jdim = j.placement.dim()
        jslice = [j.mesh.devices[i % jdim.x, (i // jdim.x) % jdim.y,
                                 i // (jdim.x * jdim.y)].id // per
                  for i in range(8)]
        want = (tuple(jdim), j.dcn_axis, j.n_slices, jslice,
                j.exchange_bytes_dcn(), j.exchange_bytes_ici())
    p = DistributedDomain(*size, devices=pd)
    p.set_radius(1)
    p.set_dcn_axis(axis, groups=split(pd, [per] * slices))
    if mesh is not None:
        p.set_mesh_shape(mesh)
    p.add_data("q", torch.float32)
    p.realize()
    got = (tuple(p.placement.dim()), p.dcn_axis, p.n_slices,
           [r // per for r in p.mesh.ranks], p.exchange_bytes_dcn(),
           p.exchange_bytes_ici())
    assert got == want
    assert got[4] > 0 and got[4] + got[5] == p.exchange_bytes_total()
    # this process is rank 0: it holds only rank 0's position
    assert [t is not None for t in p.curr["q"]] == \
        [r == 0 for r in p.mesh.ranks]


def test_dcn_tier_refuses_a_contradictory_placement():
    p = DistributedDomain(16, 16, 16, devices=fake_devices())
    p.set_radius(1)
    p.set_dcn_axis("z", groups=split(fake_devices(), [4, 4]))
    p.set_placement("trivial")
    p.add_data("q", torch.float32)
    with pytest.raises(ValueError, match="DCN tier"):
        p.realize()


def test_jacobi_and_astaroth_take_jax_x_free_halo_mesh():
    """JAX ``tests/test_multihost.py:158-200``: with the DCN tier and
    kernel='halo' and no mesh shape, both models derive JAX's x-free,
    host-compatible mesh and take the halo path."""
    from stencil_tpu.models.astaroth import Astaroth as JAstaroth
    from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
    from stencil_tpu_torch.models.astaroth import Astaroth
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    jd, pd = jax.devices()[:8], fake_devices()
    with reference_block_planner():
        jj = JJacobi3D(16, 16, 16, dtype=np.float32, devices=jd,
                       kernel="halo", dcn_axis="z",
                       dcn_groups=[jd[:4], jd[4:]])
        ja = JAstaroth(16, 16, 32, dtype=np.float64, devices=jd,
                       kernel="halo", dcn_axis="z",
                       dcn_groups=[jd[:4], jd[4:]])
        want = [(m.kernel_path, tuple(m.dd.placement.dim()), m.dd.n_slices,
                 m.dd.exchange_bytes_dcn()) for m in (jj, ja)]
    pj = Jacobi3D(16, 16, 16, devices=pd, kernel="halo", dcn_axis="z",
                  dcn_groups=[pd[:4], pd[4:]])
    pa = Astaroth(16, 16, 32, dtype=torch.float64, devices=pd,
                  kernel="halo", dcn_axis="z", dcn_groups=[pd[:4], pd[4:]])
    got = [(m.kernel_path, tuple(m.dd.placement.dim()), m.dd.n_slices,
            m.dd.exchange_bytes_dcn()) for m in (pj, pa)]
    assert got == want
    for _, dim, _, dcn in got:
        assert dim[0] == 1 and dim[2] % 2 == 0 and dcn > 0
