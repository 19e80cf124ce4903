"""B10's plain twin against the JAX package's fused substep-0+1 kernel.

``mhd_substep01_wrap_plain`` (``stencil_tpu_torch/ops/cuda_mhd.py``) is
held against ``mhd_substep01_wrap_pallas`` run in interpret mode on the
CPU (inside ``reference_block_planner``), on the same seeded numpy
fields of sigma 0.1, in float32 and float64, at the default dt = 1e-8
and at dt = 1e-4. Tolerances as in tests/test_torch_mhd.py: float32 per
field ``max |port - jax| <= 64 * eps(f32) * max |jax|``, float64
``rtol=1e-11, atol=1e-13``.

On the CPU the port's pair equals two single-substep twins bitwise (the
ring is recomputed, not approximated), and ``mhd_pair_update`` on one
block's radius-2R window equals the whole field's result on that block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.models.astaroth import MhdParams as JParams
from stencil_tpu.ops import pallas_mhd as jpm
from stencil_tpu_torch.models.astaroth import FIELDS, MhdParams
from stencil_tpu_torch.ops import cuda_mhd as cm
from torch_port_support import (assert_mhd_fields_match as
                                assert_fields_match, reference_block_planner)

jax.config.update("jax_platforms", "cpu")

SHAPE = (16, 8, 16)          # (Z, Y, X)
CASES = [(np.float32, 1e-8), (np.float32, 1e-4),
         (np.float64, 1e-8), (np.float64, 1e-4)]


def _fields(dtype, seed=11, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return {q: rng.normal(0.0, 0.1, shape).astype(dtype) for q in FIELDS}


def _t(d):
    return {q: torch.from_numpy(np.array(v)) for q, v in d.items()}


@pytest.mark.parametrize("dtype,dt", CASES,
                         ids=[f"{np.dtype(d).name}-dt{dt:g}" for d, dt in CASES])
def test_pair_twin_matches_jax(dtype, dt):
    f = _fields(dtype)
    with reference_block_planner():
        want_f, want_w = jpm.mhd_substep01_wrap_pallas(
            {q: jnp.asarray(v) for q, v in f.items()}, JParams(dt=dt), dt,
            interpret=True)
    got_f, got_w = cm.mhd_substep01_wrap_plain(_t(f), MhdParams(dt=dt), dt)
    assert_fields_match(got_f, want_f, dtype)
    assert_fields_match(got_w, want_w, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pair_twin_equals_two_substep_twins_bitwise(dtype):
    f = _t(_fields(dtype, seed=12))
    prm = MhdParams(dt=1e-4)
    pf, pw = cm.mhd_substep01_wrap_plain(f, prm, 1e-4)
    f1, w1 = cm.mhd_substep_wrap_plain(f, None, 0, prm, 1e-4)
    f2, w2 = cm.mhd_substep_wrap_plain(f1, w1, 1, prm, 1e-4)
    for q in FIELDS:
        assert torch.equal(pf[q], f2[q]), q
        assert torch.equal(pw[q], w2[q]), q


def test_pair_update_on_one_block_equals_the_whole_field():
    """The pair math on one (bz, by) block's radius-6 window — the
    per-block form the TPU kernel runs — gives the whole-field twin's
    values on that block."""
    f = _t(_fields(np.float32, seed=13, shape=(16, 16, 8)))
    prm = MhdParams(dt=1e-4)
    whole_f, whole_w = cm.mhd_substep01_wrap_plain(f, prm, 1e-4)
    bz, by, z0, y0 = 8, 8, 8, 0
    R2 = 2 * cm.R
    wins = {}
    for q, t in f.items():
        ext = cm._periodic_window(t, R2)      # index i <-> field row i - R2
        wins[q] = ext[z0:z0 + bz + 2 * R2, y0:y0 + by + 2 * R2]
    bf, bw = cm.mhd_pair_update(wins, prm, torch.float32, 1e-4, bz, by)
    for q in FIELDS:
        assert torch.equal(bf[q], whole_f[q][z0:z0 + bz, y0:y0 + by]), q
        assert torch.equal(bw[q], whole_w[q][z0:z0 + bz, y0:y0 + by]), q
