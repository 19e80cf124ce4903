"""B12's plain twin against the JAX package's fused substep-0+1 halo
kernel.

``mhd_substep01_halo_plain`` (``stencil_tpu_torch/ops/cuda_mhd.py``) is
held against ``mhd_substep01_halo_pallas`` run in interpret mode on the
CPU (inside ``reference_block_planner``), on the (16, 8, 16) shard of
tests/test_torch_mhd_halo.py with the same kind of slabs, made by JAX's
``exchange_interior_slabs`` with 2R = 6 valid rows (JAX's layout: rz =
block_z = 8, ry = 8), in float32 and float64, at dt = 1e-8 and 1e-4.
Tolerances as for B11. The exact-row slabs (rz = ry = 6) give the twin
the same result bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.models.astaroth import MhdParams as JParams
from stencil_tpu_torch.models.astaroth import FIELDS, MhdParams
from stencil_tpu_torch.ops import cuda_mhd as cm
from test_torch_mhd_halo import _fields, _j, _t, exact_rows, jax_slabs
from torch_port_support import (MHD_CASE_IDS, MHD_CASES,
                                assert_mhd_fields_match as assert_fields_match,
                                reference_block_planner)

jax.config.update("jax_platforms", "cpu")


@pytest.mark.parametrize("dtype,dt", MHD_CASES, ids=MHD_CASE_IDS)
def test_pair_twin_matches_jax(dtype, dt):
    f = _fields(dtype, 51)
    sl = jax_slabs(dtype, 52, 6)
    with reference_block_planner():
        from stencil_tpu.ops.pallas_halo import mhd_substep01_halo_pallas

        want_f, want_w = mhd_substep01_halo_pallas(_j(f), _j(sl),
                                                   JParams(dt=dt), dt,
                                                   interpret=True)
    prm = MhdParams(dt=dt)
    got_f, got_w = cm.mhd_substep01_halo_plain(_t(f), _t(sl), prm, dt)
    assert_fields_match(got_f, want_f, dtype)
    assert_fields_match(got_w, want_w, dtype)
    own_f, own_w = cm.mhd_substep01_halo_plain(_t(f), _t(exact_rows(sl, 6)),
                                               prm, dt)
    for q in FIELDS:
        assert torch.equal(own_f[q], got_f[q]) and torch.equal(own_w[q],
                                                               got_w[q]), q
