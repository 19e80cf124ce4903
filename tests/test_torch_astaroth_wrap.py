"""The port's Astaroth ``wrap`` path against the JAX model's.

The port's wrap path runs on the CPU, where the CUDA wrappers hand
their tensors to the plain twins (``cuda_mhd.LAUNCHES`` stays 0); the
JAX model's wrap path runs its Pallas substep kernel in interpret mode
(inside ``reference_block_planner``). Both start from ``init()`` and
take 2 ``step()``s: 3 substep launches each, substep 0 with ``w=None``
and substep 2 with ``write_w=False``; the carried w is substep 1's in
both. Float32 and float64, dt = 1e-8 and 1e-4; tolerances as in
tests/test_torch_astaroth.py. The pair path (``STENCIL_MHD_PAIR=1``) is
in tests/test_torch_astaroth_pair.py.
"""

import jax
import numpy as np
import pytest

from stencil_tpu_torch.ops import cuda_mhd as cm
from torch_port_support import (MHD_CASE_IDS, MHD_CASES, assert_mhd_fields_match,
                                jax_astaroth, port_astaroth,
                                reference_block_planner, run_astaroth_pair)

jax.config.update("jax_platforms", "cpu")


@pytest.mark.parametrize("dtype,dt", MHD_CASES, ids=MHD_CASE_IDS)
def test_wrap_path_matches_jax_after_two_steps(monkeypatch, dtype, dt):
    monkeypatch.setenv("STENCIL_MHD_PAIR", "0")
    cm.reset_launch_counts()
    (jf, jw), (pf, pw) = run_astaroth_pair("wrap", dt, dtype)
    assert_mhd_fields_match(pf, jf, dtype)
    assert_mhd_fields_match(pw, jw, dtype)
    assert set(cm.LAUNCHES.values()) == {0}      # CPU: twins, no launches


def test_wrap_exchange_stats_match_jax():
    p = port_astaroth("wrap", 1e-8, np.float32)
    with reference_block_planner():
        j = jax_astaroth("wrap", 1e-8, np.float32)
        assert p.exchange_stats() == j.exchange_stats()
