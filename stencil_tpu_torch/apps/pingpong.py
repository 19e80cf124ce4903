"""Neighbour point-to-point bandwidth sweep over the mesh's devices.

PyTorch-port counterpart of ``apps/pingpong.py`` (reference:
bin/pingpong.cu:19-28 — message sizes 2^min..2^max bytes bounced between
a device pair). JAX shifts one buffer per device around a ring with
``lax.ppermute``; here each mesh position holds one buffer on its
device, and a shift copies every buffer into the next position's
(``copy_``): over NVLink between distinct cards, inside the card where a
device repeats. Each sample is one shift, ending in a synchronize of
every device. Lines:

    pingpong,bytes_per_dev,trimean_s,GBps_per_dev

and last the alpha-beta fit of the sweep, ``t = alpha + bytes / beta``
by least squares on the relative error (every size weighs alike), which
``analysis/costmodel.py`` takes as its intra-host link:

    pingpong fit: alpha_s=<s> beta_Bps=<bytes/s> over <n> sizes

Run it as

    python -m stencil_tpu_torch.apps.pingpong --devices cuda:0,cuda:1
"""

from __future__ import annotations

import argparse
import time

from ._common import add_device_flags, csv_line, devices_from_args


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--min", type=int, default=10, help="log2 min bytes")
    ap.add_argument("--max", type=int, default=24, help="log2 max bytes")
    ap.add_argument("--iters", "-n", type=int, default=20)
    add_device_flags(ap, mesh=False)
    args = ap.parse_args(argv)

    import torch

    from ..numerics import Statistics
    from ..utils.timers import device_sync

    devs = [torch.device(d) for d in devices_from_args(args)]
    n = len(devs)
    if n < 2:
        print("pingpong: need >= 2 devices; have", n)
        return

    def shift(src, dst):
        for i in range(n):
            dst[(i + 1) % n].copy_(src[i])

    print(csv_line("pingpong", "bytes_per_dev", "trimean_s", "GBps_per_dev"))
    sizes, times = [], []
    for p in range(args.min, args.max + 1):
        nbytes = 1 << p
        elems = max(nbytes // 4, 1)
        a = [torch.zeros(elems, dtype=torch.float32, device=d) for d in devs]
        b = [torch.empty_like(t) for t in a]
        shift(a, b)
        device_sync(b)
        stats = Statistics()
        for _ in range(args.iters):
            t0 = time.perf_counter()
            shift(b, a)
            device_sync(a)
            stats.insert(time.perf_counter() - t0)
            a, b = b, a
        tm = stats.trimean()
        sizes.append(nbytes)
        times.append(tm)
        print(csv_line("pingpong", nbytes, f"{tm:.6e}",
                       f"{nbytes / tm / 1e9:.3f}"))
    alpha, beta = fit_alpha_beta(sizes, times)
    print(f"pingpong fit: alpha_s={alpha!r} beta_Bps={beta!r} over "
          f"{len(sizes)} sizes")


def fit_alpha_beta(sizes, times):
    """(alpha seconds, beta bytes/s) of ``t = alpha + n / beta`` fitted
    to the (bytes, seconds) samples by least squares on the relative
    error."""
    import numpy as np

    t = np.asarray(times, dtype=np.float64)
    a = np.stack([1.0 / t, np.asarray(sizes, dtype=np.float64) / t], axis=1)
    (alpha, inv_beta), *_ = np.linalg.lstsq(a, np.ones_like(t), rcond=None)
    return float(alpha), float(1.0 / inv_beta)


if __name__ == "__main__":
    main()
