"""The port's Jacobi3D overlap paths against the JAX package's models.

``Jacobi3D(overlap=True)`` — the ``overlap`` path (B7 on resident
shards), ``xla-overlap`` and ``pallas-overlap`` (the padded paths with
the deep interior computed while the exchange runs) — against JAX's
model on the same mesh shape over the fake CPU devices (its RDMA
kernels interpreted), from the same initial state, and the ``overlap``
path against the dense numpy oracle. Tolerance: bitwise, except the
oracle (``atol=2e-6``, JAX's own for this path) and ``overlap`` against
``halo`` (steps x 8 eps(f32): the two add in different orders).
"""

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu_torch import Jacobi3D, Method
from stencil_tpu_torch.models.jacobi import dense_reference_step
from torch_port_support import reference_block_planner

jax.config.update("jax_platforms", "cpu")


def _pair(size, mesh, kernel, overlap=True, methods=None):
    n = mesh[0] * mesh[1] * mesh[2]
    kw = {} if methods is None else {"methods": methods[0]}
    jj = JJacobi3D(*size, mesh_shape=mesh, dtype=np.float32,
                   devices=jax.devices()[:n], kernel=kernel, overlap=overlap,
                   **kw)
    kw = {} if methods is None else {"methods": methods[1]}
    pj = Jacobi3D(*size, dtype=torch.float32, kernel=kernel, overlap=overlap,
                  mesh_shape=mesh, devices=["cpu"] * n, **kw)
    return jj, pj


@pytest.mark.parametrize("mesh", [(1, 2, 2), (1, 4, 2)])
def test_overlap_path_matches_jax_bitwise(mesh):
    """32^3: step() x 3 and run(2), bitwise JAX's in-kernel RDMA overlap
    model on the same mesh, and within atol 2e-6 of the dense oracle."""
    n = 32
    with reference_block_planner():
        jj, pj = _pair((n, n, n), mesh, "halo")
        assert pj.kernel_path == jj.kernel_path == "overlap"
        assert pj.exchange_stats() == jj.exchange_stats()
        for m in (jj, pj):
            m.init()
        temp = pj.temperature()
        hot, cold = (n // 3, n // 2, n // 2), (2 * n // 3, n // 2, n // 2)
        for _ in range(3):
            jj.step()
            pj.step()
            temp = dense_reference_step(temp, hot, cold, n // 10)
            np.testing.assert_array_equal(pj.temperature(), jj.temperature())
        jj.run(2)
        pj.run(2)
        for _ in range(2):
            temp = dense_reference_step(temp, hot, cold, n // 10)
        np.testing.assert_array_equal(pj.temperature(), jj.temperature())
        np.testing.assert_allclose(pj.temperature(), temp, atol=2e-6)


@pytest.mark.parametrize("kernel,methods", [
    ("xla", None),
    ("xla", (Method.PallasDMA, Method.PallasDMA)),
])
def test_padded_overlap_path_matches_jax_bitwise(kernel, methods):
    """``xla-overlap`` on (2,2,2) at 16^3 from a seeded field, run(3),
    with the slab and the remote-write exchange (JAX interprets its
    RDMA kernel for the latter)."""
    from stencil_tpu.parallel.methods import Method as JMethod

    jm = None if methods is None else (JMethod.PallasDMA, methods[1])
    jj, pj = _pair((16, 16, 16), (2, 2, 2), kernel, methods=jm)
    assert pj.kernel_path == jj.kernel_path == f"{kernel}-overlap"
    assert pj.exchange_stats() == jj.exchange_stats()
    vals = np.random.default_rng(62).random((16, 16, 16)).astype(np.float32)
    jj.dd.set_interior("temp", vals)
    pj.load_interior(vals)
    jj.run(3)
    pj.run(3)
    np.testing.assert_array_equal(pj.temperature(), jj.temperature())


def test_pallas_overlap_path_matches_jax_bitwise():
    """``pallas-overlap`` on (1,2,2): K3's twin on every region block."""
    with reference_block_planner():
        jj, pj = _pair((12, 16, 16), (1, 2, 2), "pallas")
        assert pj.kernel_path == jj.kernel_path == "pallas-overlap"
        vals = np.random.default_rng(63).random((16, 16, 12)).astype(
            np.float32)
        jj.dd.set_interior("temp", vals)
        pj.load_interior(vals)
        jj.run(2)
        pj.run(2)
        np.testing.assert_array_equal(pj.temperature(), jj.temperature())


def test_overlap_equals_halo_within_bound_and_xla_overlap_equals_xla():
    """The overlap path adds in its own order, so it is not bitwise the
    halo path: within steps x 8 eps(f32). xla-overlap is the xla path's
    arithmetic region by region: bitwise."""
    runs = {}
    vals = np.random.default_rng(64).random((16, 16, 24)).astype(np.float32)
    for label, kernel, overlap in (("overlap", "halo", True),
                                   ("halo", "halo", False),
                                   ("xla-overlap", "xla", True),
                                   ("xla", "xla", False)):
        j = Jacobi3D(24, 16, 16, kernel=kernel, overlap=overlap,
                     mesh_shape=(1, 2, 2), devices=["cpu"] * 4)
        assert j.kernel_path == label
        j.load_interior(vals)
        j.run(5)
        runs[label] = j.temperature()
    eps = np.finfo(np.float32).eps
    assert np.abs(runs["overlap"] - runs["halo"]).max() <= 5 * 8 * eps
    np.testing.assert_array_equal(runs["xla-overlap"], runs["xla"])


def test_overlap_with_uneven_grid_raises_as_jax():
    with pytest.raises(NotImplementedError, match="evenly"):
        Jacobi3D(16, 17, 16, kernel="halo", overlap=True,
                 mesh_shape=(1, 2, 2), devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="evenly"):
        JJacobi3D(16, 17, 16, mesh_shape=(1, 2, 2), dtype=np.float32,
                  devices=jax.devices()[:4], kernel="halo", overlap=True)
