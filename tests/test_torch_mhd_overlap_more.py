"""B13's and B14's plain twins against the JAX package's MHD overlap
kernels: the cases of ``tests/test_torch_mhd_overlap.py`` that file
leaves to this one (its ``HERE`` names its own), with its fixture body
and its two per-case tests, so that ``--dist loadfile`` interprets the
JAX kernels of the two halves on two workers. Tolerance as there
(``assert_mhd_fields_match``, the B11 rule: float32 per field 64
eps(f32) x max |jax|, float64 rtol 1e-11, atol 1e-13; the landed slabs
and the port's composed substep against its B11/B12 twin bitwise).
"""

import pytest

from test_torch_mhd_overlap import (  # noqa: F401  (collected here)
    _cases, run_case,
    test_b13_twin_matches_jax_interior_and_slabs,
    test_composed_substep_matches_jax_and_the_halo_twin)


@pytest.fixture(scope="module", **_cases(False))
def case(request):
    return run_case(request.param)
