"""QAP placement-solver timing against matrix size.

PyTorch-port counterpart of the JAX package's top-level
``apps/bench_qap.py`` (reference: bin/bench_qap.cu:1-13): seeded weight
and distance matrices of each ``--sizes`` n go through the exact solver
(``qap.solve``, n <= 10, ``--timeout`` seconds at most) and the hill
climb (``qap.solve_catch``), and each size prints JAX's CSV line

    bench_qap,n,native,exact_s,exact_cost,catch_s,catch_cost

``native`` says whether the C++ solvers (``csrc/qap.cpp``, built with
g++ at first use) ran, else the pure-Python path. The solvers run on
the host: this app touches no device.

    python -m stencil_tpu_torch.apps.bench_qap --sizes 4 6 8 10 16 32
"""

from __future__ import annotations

import argparse
import time

from ._common import csv_line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[4, 6, 8, 10, 16, 32])
    ap.add_argument("--timeout", type=float, default=2.0)
    args = ap.parse_args(argv)

    import numpy as np

    from .. import qap

    rng = np.random.default_rng(0)
    print(csv_line("bench_qap", "n", "native", "exact_s", "exact_cost",
                   "catch_s", "catch_cost"))
    for n in args.sizes:
        w = rng.uniform(0, 10, (n, n))
        np.fill_diagonal(w, 0)
        d = rng.uniform(0.1, 1, (n, n))
        np.fill_diagonal(d, 0)
        if n <= 10:
            t0 = time.perf_counter()
            _, c_exact = qap.solve(w, d, timeout_s=args.timeout)
            t_exact = time.perf_counter() - t0
        else:
            t_exact, c_exact = float("nan"), float("nan")
        t0 = time.perf_counter()
        _, c_catch = qap.solve_catch(w, d)
        t_catch = time.perf_counter() - t0
        print(csv_line("bench_qap", n, qap.native_available(),
                       f"{t_exact:.4f}", f"{c_exact:.3f}",
                       f"{t_catch:.4f}", f"{c_catch:.3f}"))


if __name__ == "__main__":
    main()
