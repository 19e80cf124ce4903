"""The port's temporal blocking against the JAX package's.

``exchange_every=s``: one depth-``s*r`` exchange feeds ``s`` steps
(``parallel/temporal.py`` in both packages), or, on the ``wrap`` and
``halo`` paths, ``s`` is the step count N of the N-step kernels (K2, B6).
Both solvers start from the same seeded numpy field and run the same
path on the same mesh shape: JAX over that many of the 8 fake CPU
devices (the Pallas kernels interpreted inside ``reference_block_planner``),
the port with ``devices=["cpu"] * n``, where the CUDA wrappers route to
their plain twins. Tolerance: bitwise (``assert_array_equal``) — JAX's
temporal path is bitwise to step-by-step (``tests/test_temporal.py``),
Jacobi has no ``a*b+c`` for XLA to contract, and the port groups steps
exactly where JAX does.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from stencil_tpu.distributed import DistributedDomain as JDomain
from stencil_tpu.geometry import Dim3 as JDim3, Radius as JRadius
from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.parallel import temporal as jt
from stencil_tpu.parallel.methods import Method as JMethod
from stencil_tpu.topology import Boundary as JBoundary
from stencil_tpu_torch import Boundary, Dim3, Jacobi3D, Radius
from stencil_tpu_torch.distributed import DistributedDomain
from stencil_tpu_torch.ops import cuda_halo as ch
from stencil_tpu_torch.ops import cuda_stencil as cs
from stencil_tpu_torch.parallel import temporal as pt
from stencil_tpu_torch.parallel.methods import Method
from torch_port_support import reference_block_planner

jax.config.update("jax_platforms", "cpu")

BOUNDARIES = {"periodic": (None, None), "none": (JBoundary.NONE,
                                                 Boundary.NONE)}
METHODS = {"slab": (JMethod.Default, Method.Default),
           "packed": (JMethod.PpermutePacked, Method.PpermutePacked),
           "dma": (JMethod.PallasDMA, Method.PallasDMA)}


def _radii(R):
    asym = R.constant(0)
    asym.set_dir((1, 0, 0), 2)
    asym.set_dir((0, -1, 0), 1)
    asym.set_dir((0, 0, 1), 1)
    return {"r1": R.constant(1), "r2": R.constant(2), "asym": asym}


DEPTHS = [1, 2, 3, (1, 1, 3), {"z": 2, "y": 4}, JDim3(2, 1, 1)]


@pytest.mark.parametrize("radius", ["r1", "r2", "asym"])
@pytest.mark.parametrize("depths", DEPTHS, ids=str)
def test_window_schedule_matches_jax(radius, depths):
    """``sub_step_windows``, ``refresh_axes`` and ``validate_temporal``
    over a grid of capacities (uneven remainders included)."""
    jr, pr = _radii(JRadius)[radius], _radii(Radius)[radius]
    pdepths = Dim3(*depths) if isinstance(depths, JDim3) else depths
    for cap in ((8, 6, 4), (5, 5, 9), (3, 4, 2)):
        got = pt.sub_step_windows(pr, Dim3(*cap), pdepths)
        want = jt.sub_step_windows(jr, JDim3(*cap), depths)
        assert [(tuple(o), tuple(d)) for o, d in got] == \
            [(tuple(o), tuple(d)) for o, d in want]
        for rem in ((0, 0, 0), (1, 0, 1)):
            try:
                jt.validate_temporal(jr, JDim3(*cap), depths, JDim3(*rem))
            except ValueError as e:
                with pytest.raises(ValueError) as got_e:
                    pt.validate_temporal(pr, Dim3(*cap), pdepths,
                                         Dim3(*rem))
                assert str(got_e.value) == str(e)
            else:
                pt.validate_temporal(pr, Dim3(*cap), pdepths, Dim3(*rem))
    for k in range(6):
        assert pt.refresh_axes(pdepths, k) == jt.refresh_axes(depths, k)
    assert pr.deepened(pdepths) .to_dict() == {
        tuple(d): v for d, v in jr.deepened(depths).to_dict().items()}


def _pair(shape, mesh, kernel, s, boundary="periodic", overlap=False,
          method="slab"):
    x, y, z = shape
    n = mesh[0] * mesh[1] * mesh[2]
    jb, pb = BOUNDARIES[boundary]
    jm, pm = METHODS[method]
    jj = JJacobi3D(x, y, z, mesh_shape=mesh, dtype=np.float32,
                   devices=jax.devices()[:n], kernel=kernel, boundary=jb,
                   exchange_every=s, overlap=overlap, methods=jm)
    pj = Jacobi3D(x, y, z, dtype=torch.float32, kernel=kernel, boundary=pb,
                  mesh_shape=mesh, devices=["cpu"] * n, exchange_every=s,
                  overlap=overlap, methods=pm)
    return jj, pj


def _load_same_state(jj, pj, seed):
    x, y, z = pj.dd.size
    vals = np.random.default_rng(seed).random((z, y, x)).astype(np.float32)
    jj.dd.set_interior("temp", vals)
    pj.load_interior(jj.temperature())
    np.testing.assert_array_equal(pj.temperature(), vals)


def _models_agree(jj, pj):
    assert pj.kernel_path == jj.kernel_path
    assert pj.exchange_stats() == jj.exchange_stats()
    assert pj.dd.exchange_bytes_per_axis() == jj.dd.exchange_bytes_per_axis()
    assert pj.dd.exchange_bytes_total() == jj.dd.exchange_bytes_total()
    assert pj.dd.exchange_bytes_amortized_per_step() == \
        jj.dd.exchange_bytes_amortized_per_step()
    assert tuple(pj.dd.alloc_radius.pad_lo()) == \
        tuple(jj.dd.alloc_radius.pad_lo())


@pytest.mark.parametrize("shape,mesh,s,boundary,overlap,method,path", [
    ((16, 16, 16), (1, 1, 1), 2, "periodic", False, "slab",
     "xla-temporal[s=2]"),
    ((16, 16, 16), (1, 2, 2), 3, "periodic", False, "slab",
     "xla-temporal[s=3]"),
    ((16, 16, 16), (2, 2, 1), 2, "periodic", False, "slab",
     "xla-temporal[s=2]"),
    ((17, 16, 15), (2, 2, 1), 3, "periodic", False, "slab",
     "xla-temporal[s=3]"),
    ((17, 15, 14), (1, 2, 2), 3, "none", False, "slab",
     "xla-temporal[s=3]"),
    ((16, 16, 16), (1, 2, 2), {"z": 3}, "periodic", False, "slab",
     "xla-temporal[s=1.1.3]"),
    ((16, 15, 16), (2, 2, 1), (2, 4, 1), "none", False, "slab",
     "xla-temporal[s=2.4.1]"),
    ((16, 16, 16), (2, 2, 1), 2, "periodic", True, "slab",
     "xla-temporal[s=2]-overlap"),
    ((16, 16, 16), (1, 2, 2), 3, "none", True, "slab",
     "xla-temporal[s=3]-overlap"),
    ((17, 16, 15), (1, 2, 2), 3, "periodic", False, "packed",
     "xla-temporal[s=3]"),
])
def test_xla_temporal_matches_jax_bitwise(shape, mesh, s, boundary, overlap,
                                          method, path):
    """run(5) (whole groups and a depth-1 tail), then run(2) more."""
    jj, pj = _pair(shape, mesh, "xla", s, boundary, overlap, method)
    assert pj.kernel_path == path
    _models_agree(jj, pj)
    _load_same_state(jj, pj, 61)
    for n in (5, 2):
        jj.run(n)
        pj.run(n)
        np.testing.assert_array_equal(pj.temperature(), jj.temperature())


@pytest.mark.parametrize("overlap", [False, True])
def test_xla_temporal_equals_stepwise_xla(overlap):
    """The port's own check, as the JAX package's: blocked == stepwise
    bitwise on an even (2,2,1) mesh, tails included."""
    base = Jacobi3D(16, 16, 12, dtype=torch.float32, kernel="xla",
                    mesh_shape=(2, 2, 1), devices=["cpu"] * 4)
    base.init()
    base.run(7)
    for s in (2, 3):
        j = Jacobi3D(16, 16, 12, dtype=torch.float32, kernel="xla",
                     mesh_shape=(2, 2, 1), devices=["cpu"] * 4,
                     exchange_every=s, overlap=overlap)
        j.init()
        j.run(7)
        np.testing.assert_array_equal(j.temperature(), base.temperature())


@pytest.mark.parametrize("kernel,shape,mesh,iters", [
    ("wrap", (16, 16, 16), (1, 1, 1), 7),     # two K2 N=3 + one K1
    ("halo", (16, 16, 24), (1, 1, 2), 4),     # one B6 N=3 + one B5
    ("halo", (16, 16, 16), (1, 1, 1), 3),     # one B6 N=3
    ("halo", (16, 12, 16), (1, 2, 1), 3),     # y not tileable: B5 x3
])
def test_kernel_paths_at_depth_three_match_jax(kernel, shape, mesh, iters):
    """``exchange_every=3`` sets N of K2 and B6; the halo path keeps
    JAX's verdict on N-step groups (``pair_halo_refusal``)."""
    with reference_block_planner():
        jj, pj = _pair(shape, mesh, kernel, 3)
        _models_agree(jj, pj)
        n = {"wrap": pj._wrap_n if kernel == "wrap" else None,
             "halo": getattr(pj, "_halo_n", None)}[kernel]
        assert n == 3
        _load_same_state(jj, pj, 62)
        jj.run(iters)
        pj.run(iters)
        np.testing.assert_array_equal(pj.temperature(), jj.temperature())
    assert set(cs.LAUNCHES.values()) == {0}   # CPU: twins, no launches
    assert set(ch.LAUNCHES.values()) == {0}


def test_explicit_depth_one_forces_single_steps():
    """``exchange_every=1`` runs K1 alone on ``wrap``, as JAX's does, on
    an allocation that is not deepened."""
    with reference_block_planner():
        jj, pj = _pair((16, 16, 16), (1, 1, 1), "wrap", 1)
        assert not pj._pair_ok
        _models_agree(jj, pj)
        _load_same_state(jj, pj, 63)
        jj.run(3)
        pj.run(3)
        np.testing.assert_array_equal(pj.temperature(), jj.temperature())


@pytest.mark.parametrize("s", [1, 2, (1, 3, 1)], ids=str)
@pytest.mark.parametrize("mesh,size", [((2, 2, 2), (12, 12, 12)),
                                       ((1, 2, 2), (6, 13, 14))])
def test_deep_exchange_fills_every_shard_like_jax(mesh, size, s):
    """``DistributedDomain.exchange()`` with ``set_exchange_every``:
    random values everywhere, then one deep exchange; every cell of every
    shard equals JAX's, and the byte models agree."""
    n = mesh[0] * mesh[1] * mesh[2]
    jd = JDomain(*size, devices=jax.devices()[:n])
    pd = DistributedDomain(*size, devices=["cpu"] * n)
    jd.set_radius(JRadius.face_edge_corner(2, 1, 1))
    pd.set_radius(Radius.face_edge_corner(2, 1, 1))
    for d in (jd, pd):
        d.set_mesh_shape(mesh)
        d.set_exchange_every(s)
    for i in range(2):
        jd.add_data(f"q{i}", np.float32)
        pd.add_data(f"q{i}", torch.float32)
    jd.realize()
    pd.realize()
    shard_shape = tuple(pd.curr["q0"][0].shape)
    pz, py, px = shard_shape
    for i in range(2):
        gshape = tuple(jd.curr[f"q{i}"].shape)
        vals = np.random.default_rng(70 + i).standard_normal(gshape).astype(
            np.float32)
        jd.curr[f"q{i}"] = jax.device_put(
            vals, NamedSharding(jd.mesh, P("z", "y", "x")))
        for k, t in enumerate(pd.curr[f"q{i}"]):
            idx = pd.shard_index(k)
            t.copy_(torch.from_numpy(vals[idx.z * pz:(idx.z + 1) * pz,
                                          idx.y * py:(idx.y + 1) * py,
                                          idx.x * px:(idx.x + 1) * px]
                                     .copy()))
    jd.exchange()
    pd.exchange()
    for i in range(2):
        host = np.asarray(jd.curr[f"q{i}"])
        for k, t in enumerate(pd.curr[f"q{i}"]):
            idx = pd.shard_index(k)
            np.testing.assert_array_equal(
                t.numpy(), host[idx.z * pz:(idx.z + 1) * pz,
                                idx.y * py:(idx.y + 1) * py,
                                idx.x * px:(idx.x + 1) * px])
    assert pd.exchange_bytes_per_axis() == jd.exchange_bytes_per_axis()
    assert pd.exchange_bytes_total() == jd.exchange_bytes_total()
    assert pd.exchange_bytes_amortized_per_step() == \
        jd.exchange_bytes_amortized_per_step()
    assert pd.exchange_every == jd.exchange_every
    assert tuple(pd.exchange_depths) == tuple(jd.exchange_depths)


def _both_raise(exc, jax_fn, port_fn, match):
    with pytest.raises(exc, match=match):
        jax_fn()
    with pytest.raises(exc, match=match):
        port_fn()


def test_set_exchange_every_after_realize_raises_like_jax():
    jd = JDomain(8, 8, 8, devices=jax.devices()[:1])
    pd = DistributedDomain(8, 8, 8, device="cpu")
    for d, dt in ((jd, np.float32), (pd, torch.float32)):
        d.set_radius(1)
        d.add_data("q", dt)
        d.realize()
    _both_raise(RuntimeError, lambda: jd.set_exchange_every(2),
                lambda: pd.set_exchange_every(2), "before realize")
    _both_raise(ValueError, lambda: JDomain(8, 8, 8).set_exchange_every(0),
                lambda: DistributedDomain(8, 8, 8, device="cpu")
                .set_exchange_every(0), "exchange_every must be >= 1")


def test_refusals_match_jax():
    """PallasDMA with s > 1, per-axis depths on the kernel paths and with
    overlap, ``kernel='pallas'`` with s > 1, and shards thinner than the
    deep slab."""
    def both(exc, match, kernel="xla", s=2, mesh=(1, 2, 2), **kw):
        _both_raise(exc, lambda: _pair((16, 16, 16), mesh, kernel, s,
                                       **kw)[0],
                    lambda: _pair((16, 16, 16), mesh, kernel, s, **kw)[1],
                    match)

    with reference_block_planner():
        both(NotImplementedError, r"exchange_every > 1 is supported by the "
             r"PpermuteSlab and PpermutePacked methods", method="dma")
        for kernel, mesh in (("wrap", (1, 1, 1)), ("halo", (1, 2, 2)),
                             ("pallas", (1, 2, 2))):
            both(NotImplementedError, "asymmetric temporal depths",
                 kernel=kernel, s={"z": 2}, mesh=mesh)
        both(NotImplementedError, "asymmetric temporal depths",
             s={"z": 2}, overlap=True)
        both(ValueError, "not supported with kernel='pallas'",
             kernel="pallas")
        both(ValueError, r"smaller than \(deepened\) radius", s=9)
