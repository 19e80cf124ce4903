"""The port's 6th-order operators and laplace6 against the JAX package.

``stencil_tpu_torch/ops/fd6.py`` forms every term in the order of
``stencil_tpu/ops/fd6.py``. Run op by op (eagerly), JAX rounds each
operation as PyTorch does, so the operators are compared bitwise
(``assert_array_equal``) in float32 and float64, on the same seeded
numpy inputs.

``laplace6_plain`` (B8's twin) is held against ``laplace6_pallas`` run
in interpret mode. There XLA compiles the kernel body into fused loops,
and jax 0.9's CPU compiler contracts ``acc + w * (hi + lo)`` into one
fused multiply-add, which rounds once where the twin (and the CUDA
kernel, built ``-fmad=false``) rounds twice; so that comparison is held
to ``64 * eps(dtype) * max |jax|``, and the twin's order of operations
is pinned bitwise against the same sums done op by op in numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.geometry import Dim3 as JDim3
from stencil_tpu.geometry import Radius as JRadius
from stencil_tpu.ops import fd6 as jfd6
from stencil_tpu.ops.pallas_stencil import laplace6_pallas
from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.ops import cuda_stencil as cs
from stencil_tpu_torch.ops import fd6

jax.config.update("jax_platforms", "cpu")

INV_DS = (1.0 / 0.049, 1.0 / 0.05, 1.0 / 0.047)
DTYPES = [np.float32, np.float64]


def _padded(shape, dtype, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _pair(a, b):
    """numpy views of a JAX array and a tensor."""
    return np.asarray(a), b.numpy()


@pytest.mark.parametrize("dtype", DTYPES)
def test_operators_match_jax_bitwise(dtype):
    p = _padded((14, 15, 16), dtype, 1)
    lo, n = (3, 3, 3), (10, 9, 8)   # (x, y, z)
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    jlo, jn, tlo, tn = JDim3(*lo), JDim3(*n), Dim3(*lo), Dim3(*n)
    for axis in range(3):
        for a, b in (
                (jfd6.der1(jp, axis, INV_DS[axis], jlo, jn),
                 fd6.der1(tp, axis, INV_DS[axis], tlo, tn)),
                (jfd6.der2(jp, axis, INV_DS[axis], jlo, jn),
                 fd6.der2(tp, axis, INV_DS[axis], tlo, tn))):
            a, b = _pair(a, b)
            assert b.dtype == a.dtype == dtype
            np.testing.assert_array_equal(b, a)
    for ax_a, ax_b in ((0, 1), (0, 2), (1, 2)):
        a, b = _pair(
            jfd6.der_cross(jp, ax_a, ax_b, INV_DS[ax_a], INV_DS[ax_b], jlo, jn),
            fd6.der_cross(tp, ax_a, ax_b, INV_DS[ax_a], INV_DS[ax_b], tlo, tn))
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(*_pair(jfd6.value(jp, jlo, jn),
                                         fd6.value(tp, tlo, tn)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_field_data_matches_jax_bitwise(dtype):
    p = _padded((12, 13, 11), dtype, 2)
    lo, n = (3, 3, 3), (5, 7, 6)
    jf = jfd6.FieldData(jnp.asarray(p), INV_DS, JDim3(*lo), JDim3(*n))
    tf = fd6.FieldData(torch.from_numpy(p), INV_DS, Dim3(*lo), Dim3(*n))
    np.testing.assert_array_equal(*_pair(jf.value, tf.value))
    for a in range(3):
        np.testing.assert_array_equal(*_pair(jf.grad(a), tf.grad(a)))
        for b in range(3):
            np.testing.assert_array_equal(*_pair(jf.hess(a, b), tf.hess(a, b)))
    np.testing.assert_array_equal(*_pair(jf.laplace, tf.laplace))
    for g_j, g_t in zip(jf.gradient, tf.gradient):
        np.testing.assert_array_equal(*_pair(g_j, g_t))
    # the lazy cache hands back the same tensor, and hess is symmetric
    assert tf.grad(1) is tf.grad(1)
    assert tf.hess(2, 0) is tf.hess(0, 2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_x_wrap_equals_periodic_x_padding(dtype):
    """``x_wrap=True`` (x unpadded, shifts by torch.roll) gives what the
    padded form gives on a field padded periodically in x — the JAX
    module's pltpu.roll mode, which only runs inside a Pallas kernel."""
    core = _padded((12, 13, 9), dtype, 3)       # z, y padded by 3; x whole
    xpad = np.concatenate([core[:, :, -3:], core, core[:, :, :3]], axis=2)
    n = Dim3(9, 7, 6)
    tw = fd6.FieldData(torch.from_numpy(core), INV_DS, Dim3(0, 3, 3), n,
                       x_wrap=True)
    tp = fd6.FieldData(torch.from_numpy(xpad), INV_DS, Dim3(3, 3, 3), n)
    np.testing.assert_array_equal(tw.value.numpy(), tp.value.numpy())
    for a in range(3):
        np.testing.assert_array_equal(tw.grad(a).numpy(), tp.grad(a).numpy())
        for b in range(a, 3):
            np.testing.assert_array_equal(tw.hess(a, b).numpy(),
                                          tp.hess(a, b).numpy())


def test_coefficients_and_radius_match_jax():
    assert (fd6._D1, fd6._D2_C, fd6._D2, fd6._DC, fd6.RADIUS) == \
        (jfd6._D1, jfd6._D2_C, jfd6._D2, jfd6._DC, jfd6.RADIUS)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("interior", [(8, 8, 8), (12, 7, 5)])   # (x, y, z)
def test_laplace6_twin_matches_pallas(dtype, interior):
    x, y, z = interior
    p = _padded((z + 6, y + 6, x + 6), dtype, 4)
    want = np.asarray(laplace6_pallas(jnp.asarray(p), JRadius.constant(3),
                                      JDim3(*interior), inv_ds=INV_DS,
                                      interpret=True))
    got = cs.laplace6_plain(torch.from_numpy(p), Radius.constant(3),
                            Dim3(*interior), INV_DS).numpy()
    assert got.dtype == want.dtype == dtype
    tol = 64 * np.finfo(dtype).eps * np.abs(want).max()
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("dtype", DTYPES)
def test_laplace6_twin_order_is_pinned_bitwise(dtype):
    """accx, accy, accz from D2_C * centre plus w_i * (hi + lo), then
    accx * ix2 + accy * iy2 + accz * iz2 — each operation rounded, as
    numpy rounds it (and as the CUDA kernel must)."""
    Z, Y, X = 6, 7, 9
    p = _padded((Z + 6, Y + 6, X + 6), dtype, 5)

    def at(dz, dy, dx):
        return p[3 + dz:3 + dz + Z, 3 + dy:3 + dy + Y, 3 + dx:3 + dx + X]

    c = dtype(fd6._D2_C) * at(0, 0, 0)
    ax, ay, az = c, c, c
    for i, w in enumerate(fd6._D2, start=1):
        w = dtype(w)
        ax = ax + w * (at(0, 0, i) + at(0, 0, -i))
        ay = ay + w * (at(0, i, 0) + at(0, -i, 0))
        az = az + w * (at(i, 0, 0) + at(-i, 0, 0))
    ix2, iy2, iz2 = (dtype(v * v) for v in INV_DS)
    want = ax * ix2 + ay * iy2 + az * iz2
    got = cs.laplace6_plain(torch.from_numpy(p), Radius.constant(3),
                            Dim3(X, Y, Z), INV_DS).numpy()
    np.testing.assert_array_equal(got, want)


def test_laplace6_wrapper_on_the_cpu():
    cs.reset_launch_counts()
    p = torch.from_numpy(_padded((14, 14, 14), np.float64, 6))
    r3 = Radius.constant(3)
    got = cs.laplace6_cuda(p, r3, Dim3(8, 8, 8), INV_DS)
    assert torch.equal(got, cs.laplace6_plain(p, r3, Dim3(8, 8, 8), INV_DS))
    assert cs.LAUNCHES["laplace6"] == 0
    with pytest.raises(ValueError, match="radius-3 ring"):
        cs.laplace6_cuda(p, Radius.constant(2), Dim3(10, 10, 10))
    with pytest.raises(ValueError, match="radius-3 ring"):
        cs.laplace6_cuda(p, r3, Dim3(9, 8, 8))


def _radius(cls, lo_xyz):
    """A radius-3 Radius of ``cls`` (the JAX package's or the port's)
    with the low pads ``lo_xyz``."""
    r = cls.constant(3)
    for axis, v in enumerate(lo_xyz):
        d = [0, 0, 0]
        d[axis] = -1
        r.set_dir(tuple(d), v)
    return r


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("interior,lo,hi", [
    ((9, 7, 5), (4, 5, 6), (4, 4, 3)),     # Xp = 17
    ((12, 8, 6), (5, 3, 4), (4, 3, 3)),    # Xp = 21, odd low x pad
    ((10, 6, 7), (6, 4, 3), (3, 5, 4)),    # Xp = 19
])   # (x, y, z)
def test_laplace6_wrapper_on_the_cpu_matches_pallas(dtype, interior, lo, hi):
    """``laplace6_cuda`` on a CPU tensor with low pads above 3 and rows
    that are not a multiple of 4 floats against ``laplace6_pallas``
    (interpret mode) with the same pads: the twin, no launch."""
    shape = tuple(n + a + b for n, a, b in zip(interior, lo, hi))[::-1]
    p = _padded(shape, dtype, 7)
    assert shape[2] % 4 != 0
    want = np.asarray(laplace6_pallas(
        jnp.asarray(p), _radius(JRadius, lo), JDim3(*interior),
        inv_ds=INV_DS, interpret=True))
    cs.reset_launch_counts()
    got = cs.laplace6_cuda(torch.from_numpy(p), _radius(Radius, lo),
                           Dim3(*interior), INV_DS).numpy()
    assert cs.LAUNCHES["laplace6"] == 0
    assert got.dtype == want.dtype == dtype
    assert got.shape == want.shape == interior[::-1]
    tol = 64 * np.finfo(dtype).eps * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
