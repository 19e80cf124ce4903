"""The port's Astaroth ``wrap`` path with the substep pair against the
JAX model's (``STENCIL_MHD_PAIR=1`` in both).

One iteration is the fused substep-0+1 pair (B10) and substep 2 (B9
with ``write_w=False``); the carried w is the pair's. The port runs its
plain twins on the CPU, JAX its Pallas kernels in interpret mode. Both
start from ``init()`` and take 2 ``step()``s; float32 and float64, dt
= 1e-8 and 1e-4; tolerances as in tests/test_torch_astaroth.py.
"""

import jax
import pytest

from stencil_tpu_torch.ops import cuda_mhd as cm
from torch_port_support import (MHD_CASE_IDS, MHD_CASES, assert_mhd_fields_match,
                                run_astaroth_pair)

jax.config.update("jax_platforms", "cpu")


@pytest.mark.parametrize("dtype,dt", MHD_CASES, ids=MHD_CASE_IDS)
def test_pair_path_matches_jax_after_two_steps(monkeypatch, dtype, dt):
    monkeypatch.setenv("STENCIL_MHD_PAIR", "1")
    cm.reset_launch_counts()
    (jf, jw), (pf, pw) = run_astaroth_pair("wrap", dt, dtype)
    assert_mhd_fields_match(pf, jf, dtype)
    assert_mhd_fields_match(pw, jw, dtype)
    assert set(cm.LAUNCHES.values()) == {0}
