"""Astaroth-style MHD mini-app on one GPU.

PyTorch-port counterpart of ``apps/astaroth.py`` (reference:
astaroth/astaroth.cu main): conf-file loading, the iteration loop, and
the reference's CSV result line

    devices,nx,ny,nz,iter trimean,exch trimean,path,bytes/iter

with per-iteration seconds (reference: astaroth/astaroth.cu:668-676).
Each of ``--iters`` samples is one iteration ending in a device
synchronize, after two warm-up iterations. Run it as

    python -m stencil_tpu_torch.apps.astaroth --nx 256 --ny 256 --nz 256

It runs on the current CUDA device unless ``--device`` names another
(``--device cpu`` runs the plain PyTorch twins).
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--conf", default="", help="astaroth.conf-style file")
    ap.add_argument("--nx", type=int, default=64, help="grid x size")
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--iters", "-n", type=int, default=10)
    ap.add_argument("--kernel", default="auto",
                    choices=("auto", "wrap", "xla"),
                    help="compute path: wrap (fused CUDA substep kernels, "
                         "periodic wrap in the kernel), xla (plain "
                         "PyTorch on the halo-padded fields), or auto")
    ap.add_argument("--dtype", default="f32", choices=("f32", "f64"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    import torch

    from ..models.astaroth import Astaroth, MhdParams
    from ..numerics import Statistics

    prm = MhdParams.from_conf(args.conf) if args.conf else MhdParams()
    dtype = {"f32": torch.float32, "f64": torch.float64}[args.dtype]
    m = Astaroth(args.nx, args.ny, args.nz, params=prm, dtype=dtype,
                 kernel=args.kernel, device=args.device)
    m.init()
    stats = Statistics()
    for i in range(2 + max(args.iters, 1)):
        t0 = time.perf_counter()
        m.step()
        m.block()
        if i >= 2:
            stats.insert(time.perf_counter() - t0)
    exch = m.measure_exchange_seconds()
    xstats = m.exchange_stats()
    print(",".join(str(f) for f in (
        m.dd.num_subdomains(), args.nx, args.ny, args.nz,
        f"{stats.trimean():.6e}", f"{exch:.6e}", xstats["path"],
        int(xstats["bytes_per_iteration"]))))


if __name__ == "__main__":
    main()
