"""The port's Jacobi3D on a mesh of shards against the JAX package's.

Both solvers start from the same seeded numpy field (``set_interior`` in
JAX, ``load_interior`` in the port, which scatters it through
``DistributedDomain.set_interior``) and run the same path on the same
mesh shape: JAX over that many of the 8 fake CPU devices with the
Pallas kernels interpreted, the port with ``devices=["cpu"] * n``,
where the CUDA wrappers route to their plain twins. Tolerance: bitwise
(``assert_array_equal``) — the port groups steps exactly where JAX does
(``ops/halo_plan.py``), each twin keeps its kernel's order of
operations, and Jacobi has no ``a*b+c`` for XLA to contract.
"""

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.topology import Boundary as JBoundary
from stencil_tpu_torch import Boundary, Jacobi3D
from stencil_tpu_torch.ops import cuda_halo as ch
from torch_port_support import reference_block_planner

jax.config.update("jax_platforms", "cpu")


def _pair(shape, mesh, kernel, boundary=None):
    x, y, z = shape
    n = mesh[0] * mesh[1] * mesh[2]
    jb, pb = ((JBoundary.NONE, Boundary.NONE) if boundary == "none"
              else (None, None))
    jj = JJacobi3D(x, y, z, mesh_shape=mesh, dtype=np.float32,
                   devices=jax.devices()[:n], kernel=kernel, boundary=jb)
    pj = Jacobi3D(x, y, z, dtype=torch.float32, kernel=kernel, boundary=pb,
                  mesh_shape=mesh, devices=["cpu"] * n)
    return jj, pj


def _load_same_state(jj, pj, seed):
    x, y, z = pj.dd.size
    vals = np.random.default_rng(seed).random((z, y, x)).astype(np.float32)
    jj.dd.set_interior("temp", vals)
    pj.load_interior(jj.temperature())
    np.testing.assert_array_equal(pj.temperature(), vals)


@pytest.mark.parametrize("mesh", [(1, 1, 1), (1, 2, 1), (1, 1, 2),
                                  (1, 2, 2)])
@pytest.mark.parametrize("shape", [(30, 16, 16), (30, 17, 9)])
def test_halo_path_matches_jax_bitwise(shape, mesh):
    """run(3) (one N-step group and a tail, or three single steps on
    uneven or untileable shards), then run(4) more, both bitwise."""
    with reference_block_planner():
        jj, pj = _pair(shape, mesh, "halo")
        assert pj.kernel_path == jj.kernel_path == "halo"
        assert pj.exchange_stats() == jj.exchange_stats()
        assert pj.dd.rem == tuple(jj.dd.rem)
        _load_same_state(jj, pj, 31)
        ch.reset_launch_counts()
        for n in (3, 4):
            jj.run(n)
            pj.run(n)
            np.testing.assert_array_equal(pj.temperature(), jj.temperature())
    assert set(ch.LAUNCHES.values()) == {0}   # CPU: twins, no launches


@pytest.mark.parametrize("boundary", ["periodic", "none"])
def test_xla_path_on_uneven_mesh_matches_jax_bitwise(boundary):
    """(2,2,2) over 9 x 7 x 5: +-1 shards on every axis."""
    jj, pj = _pair((9, 7, 5), (2, 2, 2), "xla", boundary)
    assert pj.kernel_path == jj.kernel_path == "xla"
    assert pj.dd.rem == tuple(jj.dd.rem) == (1, 1, 1)
    assert pj.exchange_stats() == jj.exchange_stats()
    _load_same_state(jj, pj, 32)
    jj.run(3)
    pj.run(3)
    np.testing.assert_array_equal(pj.temperature(), jj.temperature())


def test_pallas_path_on_mesh_matches_jax_bitwise():
    with reference_block_planner():
        jj, pj = _pair((12, 9, 8), (1, 2, 2), "pallas")
        _load_same_state(jj, pj, 33)
        jj.run(2)
        pj.run(2)
        np.testing.assert_array_equal(pj.temperature(), jj.temperature())


@pytest.mark.parametrize("n", [3, 4, 5])
def test_halo_equals_wrap_on_one_shard(n):
    """On (1,1,1) the slabs are the shard's own wrapped edges, so B5 is
    K1's arithmetic and B6 K2's: the paths agree bitwise."""
    runs = {}
    for kernel in ("halo", "wrap"):
        j = Jacobi3D(24, 16, 16, kernel=kernel, device="cpu")
        j.load_interior(np.random.default_rng(34).random((16, 16, 24))
                        .astype(np.float32))
        j.run(n)
        runs[kernel] = j.temperature()
    np.testing.assert_array_equal(runs["halo"], runs["wrap"])


def test_halo_on_shards_equals_one_shard():
    """Four shards of one grid, N-step groups: bitwise the (1,1,1) run."""
    runs = []
    for mesh in ((1, 1, 1), (1, 2, 2)):
        n = mesh[1] * mesh[2]
        j = Jacobi3D(24, 16, 16, kernel="halo", mesh_shape=mesh,
                     devices=["cpu"] * n)
        j.load_interior(np.random.default_rng(35).random((16, 16, 24))
                        .astype(np.float32))
        j.run(5)
        runs.append(j.temperature())
    np.testing.assert_array_equal(runs[0], runs[1])


def test_auto_path_matches_jax_off_accelerator():
    """Off the accelerator both packages' 'auto' picks the plain path,
    with the same x-unsharded-or-not mesh."""
    jj, pj = _pair((16, 16, 16), (1, 2, 2), "auto")
    assert pj.kernel_path == jj.kernel_path == "xla"
    assert pj.exchange_stats() == jj.exchange_stats()


def test_halo_refuses_what_jax_refuses():
    with pytest.raises(ValueError):
        Jacobi3D(16, 16, 16, kernel="halo", mesh_shape=(2, 1, 1),
                 devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        Jacobi3D(16, 16, 16, kernel="halo", boundary=Boundary.NONE,
                 device="cpu")
    with pytest.raises(TypeError, match="float32"):
        Jacobi3D(16, 16, 16, kernel="halo", dtype=torch.float64,
                 device="cpu")


def test_app_runs_a_mesh_on_the_cpu(tmp_path):
    """The app with --mesh-shape and --device cpu: four shards of 8^3,
    weak-scaled to 8 x 16 x 16, with y and z bytes on the wire."""
    import subprocess
    import sys
    from pathlib import Path

    out = subprocess.run(
        [sys.executable, "-m", "stencil_tpu_torch.apps.jacobi3d",
         "--x", "8", "--y", "8", "--z", "8", "--iters", "4", "--batch",
         "2", "--kernel", "halo", "--mesh-shape", "1,2,2", "--device",
         "cpu"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env={"PYTHONPATH": str(Path(__file__).resolve().parent.parent),
             "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1].split(",")
    assert line[0] == "jacobi3d"
    assert line[2:6] == ["4", "8", "16", "16"]
    assert line[6] == "0" and int(line[7]) > 0 and int(line[8]) > 0
    assert line[11] == "halo"
