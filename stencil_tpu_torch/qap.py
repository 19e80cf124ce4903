"""Quadratic-assignment solvers for topology-aware placement.

PyTorch-port counterpart of ``stencil_tpu/qap.py``: a Python front end
over the host C++ solvers in ``csrc/qap.cpp`` (reference:
include/stencil/qap.hpp:51-180), with the same pure-Python path when the
library cannot be built. Matrices are numpy float64 ``(n, n)`` arrays:
``w`` = communication weight between subdomain pairs, ``d`` = distance
(1/bandwidth) between device pairs. Solvers return a bijection ``f``
(list of device slots) minimizing ``sum_{a,b} w[a,b] * d[f[a],f[b]]``
with ``0 * inf == 0``.

The library is host code, built with ``g++`` at first use into the
port's build directory (``stencil_tpu_torch/_build/``, named by a hash
of the source); ``native_available()`` says which path runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "csrc" / "qap.cpp"
_BUILD_DIR = _HERE / "_build"
_CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_native_failed = False


def _lib_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_CXX_FLAGS).encode())
    return _BUILD_DIR / f"libstencil_qap-{h.hexdigest()[:16]}.so"


def _build_native() -> Optional[ctypes.CDLL]:
    """Compile csrc/qap.cpp to a shared library (cached by the source's
    hash); None when it cannot be built."""
    global _native_failed
    if _native_failed:
        return None
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = _lib_path()
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *_CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                           check=True, capture_output=True)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int64)
        lib.qap_solve_exact.restype = ctypes.c_double
        lib.qap_solve_exact.argtypes = [ctypes.c_int64, dp, dp, ip,
                                        ctypes.c_double]
        lib.qap_solve_catch.restype = ctypes.c_double
        lib.qap_solve_catch.argtypes = [ctypes.c_int64, dp, dp, ip]
        lib.qap_cost.restype = ctypes.c_double
        lib.qap_cost.argtypes = [ctypes.c_int64, dp, dp, ip]
        return lib
    except Exception:  # noqa: BLE001 - no compiler: the Python path
        _native_failed = True
        return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None and not _native_failed:
        _lib = _build_native()
    return _lib


def _cost_product(we: float, de: float) -> float:
    # 0 * inf == 0 by convention (reference: qap.hpp:16-21)
    if we == 0 or de == 0:
        return 0.0
    return we * de


def cost(w: np.ndarray, d: np.ndarray, f: List[int]) -> float:
    """Assignment cost (reference: qap.hpp detail::cost)."""
    w = np.asarray(w, dtype=np.float64)
    d = np.asarray(d, dtype=np.float64)
    n = w.shape[0]
    ret = 0.0
    for a in range(n):
        for b in range(n):
            ret += _cost_product(w[a, b], d[f[a], f[b]])
    return ret


def _as_c(arr: np.ndarray):
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _native_call(fn, w, d, *extra) -> Tuple[List[int], float]:
    n = w.shape[0]
    wk, wp = _as_c(w)
    dk, dp = _as_c(d)
    out = np.zeros(n, dtype=np.int64)
    c = fn(n, wp, dp, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
           *extra)
    return out.tolist(), float(c)


def solve(w: np.ndarray, d: np.ndarray, timeout_s: float = 10.0
          ) -> Tuple[List[int], float]:
    """Exact brute-force QAP with timeout (reference: qap.hpp:51-85)."""
    w = np.asarray(w, dtype=np.float64)
    d = np.asarray(d, dtype=np.float64)
    n = w.shape[0]
    assert w.shape == d.shape == (n, n)
    lib = _get_lib()
    if lib is not None:
        return _native_call(lib.qap_solve_exact, w, d, float(timeout_s))
    stop = time.monotonic() + timeout_s
    best_f = list(range(n))
    best_c = cost(w, d, best_f)
    for i, perm in enumerate(itertools.permutations(range(n))):
        if (i & 0x3FF) == 0 and time.monotonic() > stop:
            break
        c = cost(w, d, list(perm))
        if c < best_c:
            best_c, best_f = c, list(perm)
    return best_f, best_c


def solve_catch(w: np.ndarray, d: np.ndarray) -> Tuple[List[int], float]:
    """Greedy pairwise-swap hill climb (reference: qap.hpp:87-180)."""
    w = np.asarray(w, dtype=np.float64)
    d = np.asarray(d, dtype=np.float64)
    n = w.shape[0]
    assert w.shape == d.shape == (n, n)
    lib = _get_lib()
    if lib is not None:
        return _native_call(lib.qap_solve_catch, w, d)
    best_f = list(range(n))
    best_c = cost(w, d, best_f)
    improved = True
    while improved:
        improved = False
        impr_f, impr_c = best_f, best_c
        for i in range(n):
            for j in range(i + 1, n):
                f = list(best_f)
                f[i], f[j] = f[j], f[i]
                c = cost(w, d, f)
                if c < impr_c:
                    impr_f, impr_c = f, c
                    improved = True
        if improved:
            best_f, best_c = impr_f, impr_c
    return best_f, best_c


def native_available() -> bool:
    """True when the C++ solvers were built and loaded (else the Python
    path runs)."""
    return _get_lib() is not None


def make_reciprocal(m: np.ndarray) -> np.ndarray:
    """Elementwise 1/m with 0 -> inf (reference: mat2d.hpp:188-204)."""
    m = np.asarray(m, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return np.where(m == 0, np.inf, 1.0 / np.where(m == 0, 1.0, m))
