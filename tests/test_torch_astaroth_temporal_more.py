"""The port's MHD temporal path against the JAX package's: the cases of
``tests/test_torch_astaroth_temporal.py`` that file leaves to this one
(its ``HERE`` names its own), with its fixture body and its four tests,
so that ``--dist loadfile`` compiles the JAX models of the two halves on
two workers. Tolerances as there (``assert_mhd_fields_match``: float32
per field 64 eps(f32) x max |jax|, float64 rtol 1e-11, atol 1e-13).
"""

import pytest

from test_torch_astaroth_temporal import (  # noqa: F401  (collected here)
    CASES, HERE, run_case,
    test_state_carried_from_jax_mid_run_with_its_padded_w,
    test_temporal_exchange_stats_match_jax,
    test_temporal_path_matches_jax_after_the_first_run,
    test_temporal_path_matches_jax_after_the_second_run)


@pytest.fixture(scope="module", params=[c for c in CASES if c not in HERE])
def runs(request):
    return run_case(request.param)
