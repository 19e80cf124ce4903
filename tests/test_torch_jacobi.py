"""The port's Jacobi3D and exchange against the JAX package's.

Both solvers start from the same state — a seeded numpy field loaded
into the JAX domain with ``set_interior`` and into the port through
``convert.py`` — and run the same path on one device: the port on the
CPU (``device="cpu"``, where the CUDA wrappers route to their plain
twins), JAX on one CPU device with the Pallas kernels interpreted.
Tolerance: bitwise (``assert_array_equal``) — the port groups the steps
as the JAX model does and each twin keeps its kernel's order of
operations.
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from stencil_tpu.distributed import DistributedDomain as JDomain
from stencil_tpu.geometry import Radius as JRadius
from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.topology import Boundary as JBoundary
from stencil_tpu_torch import Boundary, Jacobi3D, Radius
from stencil_tpu_torch.convert import field_from_jax
from stencil_tpu_torch.distributed import DistributedDomain
from stencil_tpu_torch.ops import cuda_stencil as cs
from torch_port_support import reference_block_planner

jax.config.update("jax_platforms", "cpu")

BOUNDARIES = {"periodic": (JBoundary.PERIODIC, Boundary.PERIODIC),
              "none": (JBoundary.NONE, Boundary.NONE)}


def _pair(n, kernel, boundary, dtype=np.float32, shape=None):
    x, y, z = shape or (n, n, n)
    jb, pb = BOUNDARIES[boundary]
    jj = JJacobi3D(x, y, z, mesh_shape=(1, 1, 1), dtype=dtype,
                   devices=jax.devices()[:1], kernel=kernel, boundary=jb)
    pj = Jacobi3D(x, y, z, dtype=dtype, kernel=kernel, boundary=pb,
                  device="cpu")
    return jj, pj


def _load_same_state(jj, pj, seed, dtype):
    x, y, z = pj.dd.size
    vals = np.random.default_rng(seed).random((z, y, x)).astype(dtype)
    jj.dd.set_interior("temp", vals)
    pj.load_interior(jj.temperature())
    np.testing.assert_array_equal(pj.temperature(), vals)


@pytest.mark.parametrize("kernel,iters,boundary,shape", [
    ("wrap", 3, "periodic", None),          # one K2 pair + one K1 tail
    ("wrap", 4, "periodic", (32, 24, 16)),  # two pairs, non-cubic
    ("pallas", 2, "periodic", None),
    ("pallas", 2, "none", None),
    ("xla", 3, "periodic", None),
    ("xla", 3, "none", None),
])
def test_model_matches_jax_bitwise_f32(kernel, iters, boundary, shape):
    with reference_block_planner():
        jj, pj = _pair(16, kernel, boundary, shape=shape)
        assert pj.kernel_path == jj.kernel_path == kernel
        _load_same_state(jj, pj, 21, np.float32)
        cs.reset_launch_counts()
        jj.run(iters)
        pj.run(iters)
        np.testing.assert_array_equal(pj.temperature(), jj.temperature())
    assert set(cs.LAUNCHES.values()) == {0}   # CPU: twins, no launches


@pytest.mark.parametrize("boundary", ["periodic", "none"])
def test_xla_path_matches_jax_bitwise_f64(boundary):
    jj, pj = _pair(12, "xla", boundary, dtype=np.float64)
    _load_same_state(jj, pj, 22, np.float64)
    jj.run(3)
    pj.run(3)
    got = pj.temperature()
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jj.temperature())


def test_wrap_step_matches_jax_step(monkeypatch):
    """step() is one K1 launch in both packages."""
    with reference_block_planner():
        jj, pj = _pair(16, "wrap", "periodic")
        jj.init()
        pj.init()
        for _ in range(2):
            jj.step()
            pj.step()
        np.testing.assert_array_equal(pj.temperature(), jj.temperature())


def test_wrap_steps_env_groups_like_jax(monkeypatch):
    """STENCIL_WRAP_STEPS=3: run(4) is one triple + one tail in both."""
    monkeypatch.setenv("STENCIL_WRAP_STEPS", "3")
    with reference_block_planner():
        jj, pj = _pair(16, "wrap", "periodic")
        _load_same_state(jj, pj, 23, np.float32)
        jj.run(4)
        pj.run(4)
        np.testing.assert_array_equal(pj.temperature(), jj.temperature())


def test_wrap_refuses_nonperiodic_like_jax():
    with pytest.raises(ValueError):
        JJacobi3D(16, 16, 16, mesh_shape=(1, 1, 1),
                  devices=jax.devices()[:1], kernel="wrap",
                  boundary=JBoundary.NONE)
    with pytest.raises(ValueError):
        Jacobi3D(16, 16, 16, kernel="wrap", boundary=Boundary.NONE,
                 device="cpu")


@pytest.mark.parametrize("kernel", ["wrap", "pallas"])
def test_kernel_paths_refuse_f64_at_construction(kernel):
    """The CUDA kernels take float32 only: a float64 domain on a kernel
    path is refused when it is built, before any field is stepped."""
    with pytest.raises(TypeError, match="float32"):
        Jacobi3D(16, 16, 16, dtype=torch.float64, kernel=kernel,
                 device="cpu")
    assert Jacobi3D(16, 16, 16, dtype=torch.float64, kernel="auto",
                    device="cpu").kernel_path == "xla"


@pytest.mark.parametrize("boundary", ["periodic", "none"])
def test_auto_path_matches_jax_off_accelerator(boundary):
    """Off the accelerator both packages' 'auto' picks the plain path."""
    jj, pj = _pair(16, "auto", boundary)
    assert pj.kernel_path == jj.kernel_path == "xla"
    assert pj.exchange_stats() == jj.exchange_stats()


def test_wrap_exchange_stats_match_jax():
    with reference_block_planner():
        jj, pj = _pair(16, "wrap", "periodic")
        assert pj.exchange_stats() == jj.exchange_stats()


def _asym(cls):
    r = cls.constant(1)
    r.set_dir((1, 0, 0), 2)
    r.set_dir((0, 0, -1), 3)
    return r


@pytest.mark.parametrize("radius", ["constant1", "constant2", "asymmetric"])
@pytest.mark.parametrize("boundary", ["periodic", "none"])
def test_exchange_fills_halos_like_jax(radius, boundary):
    """A padded field with random halos and interior: after one
    exchange every cell, halos included, equals the JAX exchange's."""
    jr = {"constant1": JRadius.constant(1), "constant2": JRadius.constant(2),
          "asymmetric": _asym(JRadius)}[radius]
    pr = {"constant1": Radius.constant(1), "constant2": Radius.constant(2),
          "asymmetric": _asym(Radius)}[radius]
    jb, pb = BOUNDARIES[boundary]
    x, y, z = 7, 6, 5
    jd = JDomain(x, y, z, devices=jax.devices()[:1])
    jd.set_radius(jr)
    jd.set_boundary(jb)
    jd.add_data("q", np.float32)
    jd.realize()
    shape = tuple(jd.curr["q"].shape)
    vals = np.random.default_rng(24).standard_normal(shape).astype(np.float32)
    jd.curr["q"] = jax.device_put(vals, NamedSharding(jd.mesh,
                                                      P("z", "y", "x")))
    pd = DistributedDomain(x, y, z, device="cpu")
    pd.set_radius(pr)
    pd.set_boundary(pb)
    pd.add_data("q", torch.float32)
    pd.realize()
    assert tuple(pd.curr["q"][0].shape) == shape
    pd.curr["q"][0].copy_(field_from_jax(vals, pr, layout="padded",
                                         device="cpu"))
    jd.exchange()
    pd.exchange()
    np.testing.assert_array_equal(pd.curr["q"][0].numpy(),
                                  np.asarray(jd.curr["q"]))
    assert pd.exchange_bytes_per_axis() == jd.exchange_bytes_per_axis()


def test_field_from_jax_layouts():
    r = Radius.constant(1)
    inner = np.arange(4 * 3 * 2, dtype=np.float32).reshape(4, 3, 2)
    padded = field_from_jax(inner, r, layout="interior", device="cpu")
    assert tuple(padded.shape) == (6, 5, 4)
    np.testing.assert_array_equal(padded[1:-1, 1:-1, 1:-1].numpy(), inner)
    assert float(padded.sum()) == float(inner.sum())   # halos zero
    again = field_from_jax(padded.numpy(), r, layout="padded", device="cpu")
    np.testing.assert_array_equal(again.numpy(), padded.numpy())
    with pytest.raises(TypeError):
        field_from_jax(inner, r, layout="interior", device="cpu",
                       dtype=torch.float64)
    with pytest.raises(ValueError):
        field_from_jax(inner, r, layout="slab", device="cpu")


def test_entry_points_need_a_card_unless_told(monkeypatch):
    """No device argument and no card: raise, never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Jacobi3D(16, 16, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistributedDomain(8, 8, 8)
    with pytest.raises(RuntimeError):
        Jacobi3D(16, 16, 16, device="cuda")


def test_app_prints_the_reference_csv_line(tmp_path):
    """The app's timed loop on the CPU at a tiny size: one CSV line in
    apps/jacobi3d.py's schema."""
    out = subprocess.run(
        [sys.executable, "-m", "stencil_tpu_torch.apps.jacobi3d",
         "--x", "8", "--y", "8", "--z", "8", "--iters", "4", "--batch",
         "2", "--kernel", "wrap", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env={"PYTHONPATH": str(__import__("pathlib").Path(
            __file__).resolve().parent.parent), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1].split(",")
    assert line[0] == "jacobi3d"
    assert line[2:6] == ["1", "8", "8", "8"]
    assert line[11] == "wrap"
    assert float(line[9]) > 0 and float(line[10]) > 0
