"""The port's QAP solvers (``stencil_tpu_torch/qap.py``, its own copy of
``csrc/qap.cpp``) against the JAX package's ``stencil_tpu/qap.py``.

Seeded weight and distance matrices (n = 4, 8, 12, some with zero and
infinite entries, the ``0 * inf == 0`` rule) go through both packages'
``cost``, ``solve`` and ``solve_catch``, on the native library and on
the pure-Python path (each package's ``_get_lib`` patched to None).
Tolerance: the same permutation, and the same cost as a float.
"""

import numpy as np
import pytest

from stencil_tpu import qap as jqap
from stencil_tpu_torch import qap


def _matrices(n, seed, holes=False):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 10, (n, n))
    np.fill_diagonal(w, 0)
    d = rng.uniform(0.1, 1, (n, n))
    np.fill_diagonal(d, 0)
    if holes:
        w[rng.uniform(size=(n, n)) < 0.3] = 0
        with np.errstate(divide="ignore"):
            d = qap.make_reciprocal(np.where(
                rng.uniform(size=(n, n)) < 0.2, 0, 1 / d))
        np.fill_diagonal(d, 0)
    return w, d


@pytest.fixture(params=["native", "python"])
def path(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(qap, "_get_lib", lambda: None)
        monkeypatch.setattr(jqap, "_get_lib", lambda: None)
    else:
        assert qap.native_available() and jqap.native_available()
    return request.param


@pytest.mark.parametrize("n", [4, 8, 12])
@pytest.mark.parametrize("holes", [False, True])
def test_cost_and_hill_climb_equal_jax(path, n, holes):
    w, d = _matrices(n, 100 + n, holes)
    f = list(np.random.default_rng(n).permutation(n))
    assert qap.cost(w, d, f) == jqap.cost(w, d, f)
    got, want = qap.solve_catch(w, d), jqap.solve_catch(w, d)
    assert got == want
    assert got[1] <= qap.cost(w, d, list(range(n)))


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("holes", [False, True])
def test_exact_solve_equals_jax(path, n, holes):
    w, d = _matrices(n, 7 * n, holes)
    got, want = qap.solve(w, d, timeout_s=60), jqap.solve(w, d,
                                                           timeout_s=60)
    assert got == want
    # the exact optimum is never worse than the hill climb
    assert got[1] <= qap.solve_catch(w, d)[1]


def test_reciprocal_and_native_flag():
    m = np.array([[0.0, 2.0], [4.0, 0.0]])
    np.testing.assert_array_equal(qap.make_reciprocal(m),
                                  jqap.make_reciprocal(m))
    assert qap.native_available() is True
    assert qap._lib_path().parent.name == "_build"
