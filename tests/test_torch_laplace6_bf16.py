"""B8 in bfloat16: ``laplace6_plain`` on bfloat16 cells against
``laplace6_pallas`` run in interpret mode on the same bfloat16 inputs.

JAX computes a bfloat16 field in bfloat16 (``dt.type(...)`` constants,
stencil_tpu/ops/pallas_stencil.py:446-465), and XLA's CPU compiler
rounds after each bfloat16 operation, as the twin's PyTorch ops do (and
as the CUDA kernel's bfloat16x2 instructions do, which the card tests
hold bitwise against the twin): the comparison is bitwise, as uint16
bits. Inputs are seeded numpy float32 values rounded once to bfloat16.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from stencil_tpu.geometry import Dim3 as JDim3
from stencil_tpu.geometry import Radius as JRadius
from stencil_tpu.ops.pallas_stencil import laplace6_pallas
from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.ops import cuda_stencil as cs

jax.config.update("jax_platforms", "cpu")

INV_DS = (1.0 / 0.049, 1.0 / 0.05, 1.0 / 0.047)


def _radius(cls, lo_xyz):
    r = cls.constant(3)
    for axis, v in enumerate(lo_xyz):
        d = [0, 0, 0]
        d[axis] = -1
        r.set_dir(tuple(d), v)
    return r


def _bf16(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return a.astype(ml_dtypes.bfloat16)


def _torch(a):
    return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
        torch.bfloat16)


@pytest.mark.parametrize("interior,lo,hi", [
    ((8, 8, 8), (3, 3, 3), (3, 3, 3)),
    ((12, 7, 5), (3, 3, 3), (3, 3, 3)),
    ((9, 7, 5), (4, 5, 6), (4, 4, 3)),
])   # (x, y, z)
def test_laplace6_bf16_twin_equals_pallas_bitwise(interior, lo, hi):
    shape = tuple(n + a + b for n, a, b in zip(interior, lo, hi))[::-1]
    p = _bf16(shape, 11)
    want = np.asarray(laplace6_pallas(
        jnp.asarray(p), _radius(JRadius, lo), JDim3(*interior),
        inv_ds=INV_DS, interpret=True))
    cs.reset_launch_counts()
    got = cs.laplace6_cuda(_torch(p), _radius(Radius, lo), Dim3(*interior),
                           INV_DS)
    assert cs.LAUNCHES["laplace6"] == 0     # a CPU tensor: the twin
    assert want.dtype == ml_dtypes.bfloat16 and got.dtype == torch.bfloat16
    assert got.shape == want.shape == interior[::-1]
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_bf16_constants_are_rounded_once_as_jax_rounds_them():
    """D2_C and the w_i as the kernel holds them (csrc/laplace6.cu
    ``kC2``, ``weight2``): each rounded once to bfloat16, the bits
    ``dt.type(...)`` gives."""
    from stencil_tpu_torch.ops.fd6 import _D2, _D2_C

    bits = [int(np.float32(ml_dtypes.bfloat16(v)).view(np.uint32) >> 16)
            for v in (_D2_C,) + tuple(_D2)]
    assert bits == [0xC02E, 0x3FC0, 0xBE1A, 0x3C36]
    src = (cs.__file__.rsplit("/", 2)[0] + "/csrc/laplace6.cu")
    text = open(src).read()
    assert "0xC02EC02Eu" in text
    for b in bits[1:]:
        assert f"0x{b:04X}{b:04X}u" in text
