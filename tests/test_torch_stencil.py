"""The port's stencil twins against the JAX package's kernels.

Each plain PyTorch twin in ``stencil_tpu_torch/ops/cuda_stencil.py``
is held against the Pallas kernel it stands beside, run in interpret
mode on the CPU as ``tests/test_pallas.py`` runs it, on the same
inputs from a seeded numpy generator. Tolerance: bitwise
(``assert_array_equal``) in float32 — each twin adds and multiplies in
its kernel's order. On the CPU the CUDA wrappers route to these twins,
so the wrappers are checked too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.geometry import Dim3 as JDim3
from stencil_tpu.geometry import Radius as JRadius
from stencil_tpu.local_domain import raw_size as j_raw_size
from stencil_tpu.local_domain import zyx_shape as j_zyx_shape
from stencil_tpu.models.jacobi import dense_reference_step
from stencil_tpu.ops import pallas_stencil as jps
from stencil_tpu.ops.stencil_kernels import jacobi7 as j_jacobi7
from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.ops import cuda_stencil as cs
from stencil_tpu_torch.ops.stencil_kernels import jacobi7
from torch_port_support import reference_block_planner, sphere_args

jax.config.update("jax_platforms", "cpu")

# (shape (Z, Y, X), explicit TPU blocks (block_z, block_y))
WRAP_CASES = [((16, 16, 16), (4, 8)), ((16, 16, 16), (8, 16)),
              ((16, 24, 32), (4, 8)), ((16, 24, 32), (8, 8))]


def _field(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.fixture
def planner():
    with reference_block_planner():
        yield


@pytest.mark.parametrize("shape,blocks", WRAP_CASES)
def test_wrap_twin_matches_pallas_bitwise(planner, shape, blocks):
    t = _field(shape, 11)
    hot, cold, r = sphere_args(shape)
    want = np.asarray(jps.jacobi7_wrap_pallas(
        jnp.asarray(t), hot, cold, r, block_z=blocks[0], block_y=blocks[1],
        interpret=True))
    got = cs.jacobi7_wrap_cuda(torch.from_numpy(t), hot, cold, r).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("shape,blocks", WRAP_CASES)
def test_wrapn_twin_matches_pallas_bitwise(planner, shape, blocks, steps):
    t = _field(shape, 12)
    hot, cold, r = sphere_args(shape)
    want = np.asarray(jps.jacobi7_wrapn_pallas(
        jnp.asarray(t), hot, cold, r, steps=steps, block_z=blocks[0],
        block_y=blocks[1], interpret=True))
    got = cs.jacobi7_wrapn_cuda(torch.from_numpy(t), hot, cold, r,
                                steps=steps).numpy()
    np.testing.assert_array_equal(got, want)


def _asym(cls):
    # the asymmetric radius of tests/test_pallas.py:33-44
    r = cls.constant(1)
    r.set_dir((1, 0, 0), 2)    # x hi face radius 2
    r.set_dir((0, 0, -1), 3)   # z lo face radius 3
    return r


@pytest.mark.parametrize("radius", ["constant1", "asymmetric"])
@pytest.mark.parametrize("interior", [(8, 8, 8), (6, 7, 8), (32, 24, 16)])
def test_padded_twin_matches_pallas_bitwise(radius, interior):
    jr = JRadius.constant(1) if radius == "constant1" else _asym(JRadius)
    pr = Radius.constant(1) if radius == "constant1" else _asym(Radius)
    jin, pin = JDim3(*interior), Dim3(*interior)
    p = np.random.default_rng(13).standard_normal(
        j_zyx_shape(j_raw_size(jin, jr))).astype(np.float32)
    want = np.asarray(jps.jacobi7_pallas(jnp.asarray(p), jr, jin,
                                         interpret=True))
    got = cs.jacobi7_padded_cuda(torch.from_numpy(p), pr, pin).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("radius", ["constant1", "asymmetric"])
def test_xla_jacobi7_matches_jax_bitwise(dtype, radius):
    """The ``xla`` path's plain math (x+1, x-1, y+1, y-1, z+1, z-1)."""
    jr = JRadius.constant(1) if radius == "constant1" else _asym(JRadius)
    pr = Radius.constant(1) if radius == "constant1" else _asym(Radius)
    interior = (12, 10, 6)
    p = np.random.default_rng(14).standard_normal(
        j_zyx_shape(j_raw_size(JDim3(*interior), jr))).astype(dtype)
    want = np.asarray(j_jacobi7(jnp.asarray(p), jr, JDim3(*interior)))
    got = jacobi7(torch.from_numpy(p), pr, Dim3(*interior)).numpy()
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_wrap_twins_match_dense_oracle(steps):
    """K1 and K2 against the JAX package's dense numpy oracle. The
    oracle divides by 6.0 and adds (z, y, x) pairs in its own order,
    the kernels multiply by float32(1/6): each step may differ by a few
    float32 ulps of values below 1, so the bound is
    ``steps * 4 * eps(float32)``."""
    shape = (16, 16, 16)
    t = _field(shape, 15)
    hot, cold, r = sphere_args(shape)
    want = t
    for _ in range(steps):
        want = dense_reference_step(want, hot, cold, r)
    atol = steps * 4 * np.finfo(np.float32).eps
    got_n = cs.jacobi7_wrapn_cuda(torch.from_numpy(t), hot, cold, r,
                                  steps=steps).numpy()
    np.testing.assert_allclose(got_n, want, rtol=0, atol=atol)
    got_1 = torch.from_numpy(t)
    for _ in range(steps):
        got_1 = cs.jacobi7_wrap_cuda(got_1, hot, cold, r)
    np.testing.assert_allclose(got_1.numpy(), want, rtol=0, atol=atol)


def test_cpu_wrappers_launch_nothing():
    cs.reset_launch_counts()
    t = torch.from_numpy(_field((8, 8, 8), 16))
    hot, cold, r = sphere_args((8, 8, 8))
    cs.jacobi7_wrap_cuda(t, hot, cold, r)
    cs.jacobi7_wrapn_cuda(t, hot, cold, r, steps=2)
    p = torch.zeros((10, 10, 10))
    cs.jacobi7_padded_cuda(p, Radius.constant(1), Dim3(8, 8, 8))
    cs.laplace6_cuda(torch.zeros((14, 14, 14)), Radius.constant(3),
                     Dim3(8, 8, 8))
    assert cs.LAUNCHES == {"jacobi7_wrap": 0, "jacobi7_wrapn": 0,
                           "jacobi7_padded": 0, "laplace6": 0}


@pytest.mark.parametrize("call", ["wrap", "wrapn", "padded"])
def test_wrappers_refuse_other_dtypes(call):
    t = torch.zeros((8, 8, 8), dtype=torch.float64)
    hot, cold, r = sphere_args((8, 8, 8))
    with pytest.raises(TypeError, match="float32"):
        if call == "wrap":
            cs.jacobi7_wrap_cuda(t, hot, cold, r)
        elif call == "wrapn":
            cs.jacobi7_wrapn_cuda(t, hot, cold, r)
        else:
            cs.jacobi7_padded_cuda(t, Radius.constant(1), Dim3(6, 6, 6))


@pytest.mark.parametrize("shape,steps", [((8, 8, 8), 0), ((8, 8, 8), 9),
                                         ((8, 12, 8), 2)])
def test_wrapn_keeps_the_jax_rules(planner, shape, steps):
    """1 <= steps <= 8 and Y % 8 == 0, as jacobi7_wrapn_pallas demands."""
    t = _field(shape, 17)
    hot, cold, r = sphere_args(shape)
    with pytest.raises(ValueError):
        jps.jacobi7_wrapn_pallas(jnp.asarray(t), hot, cold, r, steps=steps,
                                 interpret=True)
    with pytest.raises(ValueError):
        cs.jacobi7_wrapn_cuda(torch.from_numpy(t), hot, cold, r, steps=steps)


def test_padded_wrapper_needs_a_ring():
    with pytest.raises(ValueError, match="ring"):
        cs.jacobi7_padded_cuda(torch.zeros((8, 8, 8)), Radius.constant(0),
                               Dim3(8, 8, 8))


def test_reference_block_planner_leaves_no_trace():
    import sys

    import jax.core as jc

    had = {n: n in vars(jc) for n in ("Jaxpr", "ClosedJaxpr")}
    before = {m for m in sys.modules if m.startswith("stencil_tpu.analysis")}
    with reference_block_planner():
        t = _field((8, 8, 8), 19)
        hot, cold, r = sphere_args((8, 8, 8))
        jps.jacobi7_wrap_pallas(jnp.asarray(t), hot, cold, r, interpret=True)
    assert {n: n in vars(jc) for n in had} == had
    after = {m for m in sys.modules if m.startswith("stencil_tpu.analysis")}
    assert after == before or all(had.values())


def test_wrapper_refuses_aliased_out():
    t = torch.from_numpy(_field((8, 8, 8), 18))
    hot, cold, r = sphere_args((8, 8, 8))
    with pytest.raises(ValueError, match="alias"):
        cs.jacobi7_wrap_cuda(t, hot, cold, r, out=t)
