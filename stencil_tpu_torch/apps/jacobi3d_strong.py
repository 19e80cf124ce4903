"""Strong-scaling Jacobi-3D: a fixed global grid over the mesh.

PyTorch-port counterpart of ``apps/jacobi3d_strong.py`` (reference:
bin/jacobi3d_strong.cu): ``--x/--y/--z`` is the global grid, ``--iters``
iterations timed in samples of ``--batch``, and the line

    jacobi3d_strong,methods,devices,x,y,z,bytes_x,bytes_y,bytes_z,min (s),trimean (s),path,bytes/iter,exchange (s)

with per-iteration seconds, as ``jacobi3d`` prints it. ``--trivial`` and
``--random`` choose the placement (``PlacementStrategy``; the default is
node-aware). Run it as

    python -m stencil_tpu_torch.apps.jacobi3d_strong \\
        --devices cuda:0,cuda:0,cuda:0,cuda:0 --kernel halo
"""

from __future__ import annotations

import argparse

from ._common import (KERNEL_CHOICES, add_device_flags, add_dtype_flags,
                      add_method_flags, add_placement_flags, csv_line,
                      devices_from_args, dtype_from_args,
                      methods_from_args, placement_from_args,
                      timed_samples)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--x", type=int, default=512, help="global x size")
    ap.add_argument("--y", type=int, default=512)
    ap.add_argument("--z", type=int, default=512)
    ap.add_argument("--iters", "-n", type=int, default=30)
    ap.add_argument("--batch", type=int, default=10)
    add_dtype_flags(ap)
    ap.add_argument("--kernel", default="auto", choices=KERNEL_CHOICES)
    add_method_flags(ap)
    add_placement_flags(ap)
    add_device_flags(ap)
    args = ap.parse_args(argv)

    from ..models.jacobi import Jacobi3D

    methods = methods_from_args(args)
    j = Jacobi3D(args.x, args.y, args.z, dtype=dtype_from_args(args),
                 kernel=args.kernel, methods=methods,
                 placement=placement_from_args(args),
                 mesh_shape=args.mesh_shape, devices=devices_from_args(args))
    j.init()
    samples = max(args.iters // args.batch, 1)
    stats = timed_samples(lambda: j.run(args.batch), j.block, samples)
    b = j.dd.exchange_bytes_per_axis()
    # the exchange of the built path (the fast paths do not call
    # dd.exchange(); see Jacobi3D.exchange_stats)
    xstats = j.exchange_stats()
    ex_s = j.measure_exchange_seconds()
    print(csv_line("jacobi3d_strong", methods, j.dd.num_subdomains(),
                   args.x, args.y, args.z, b["x"], b["y"], b["z"],
                   f"{stats.min() / args.batch:.6e}",
                   f"{stats.trimean() / args.batch:.6e}",
                   xstats["path"], int(xstats["bytes_per_iteration"]),
                   f"{ex_s:.6e}"))


if __name__ == "__main__":
    main()
