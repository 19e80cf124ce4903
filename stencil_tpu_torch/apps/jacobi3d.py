"""Jacobi-3D heat demo over a mesh of shards.

PyTorch-port counterpart of ``apps/jacobi3d.py`` (reference:
bin/jacobi3d.cu): build the solver, time ``--iters`` iterations in
samples of ``--batch`` (two warm-up samples first; each sample ends in a
device synchronize), and print the reference's CSV result line

    bin,methods,devices,x,y,z,bytes_x,bytes_y,bytes_z,min (s),trimean (s),path,bytes/iter,exchange (s)

with per-iteration seconds. ``--x/--y/--z`` are the size of one shard:
the global grid is that times the mesh (weak scaling, as the reference
and the JAX app do), and the line prints the global size. Run it as

    python -m stencil_tpu_torch.apps.jacobi3d --x 512 --y 512 --z 512
    python -m stencil_tpu_torch.apps.jacobi3d --x 512 --y 256 --z 256 \\
        --kernel halo --mesh-shape 1,2,2 --devices cuda:0,cuda:0,cuda:0,cuda:0

The mesh runs on every visible CUDA device unless ``--devices`` lists
one device per mesh position (repeats allowed: shards sharing a card)
or ``--device`` names one (``--device cpu`` runs the plain PyTorch
twins). With no ``--mesh-shape``, the ``halo`` and ``auto`` kernels take
an x-unsharded mesh and the others a near-cubic one. The method flags
(``--slab``, ``--packed``, ``--allgather``, ``--pallas-dma``; JAX's
``apps/_common.py``) choose the exchange of the padded paths
(``--pallas-dma``: the remote-write kernel B4); the ``methods`` column
prints the one that ran.
"""

from __future__ import annotations

import argparse
import os
import time

from ._common import add_method_flags, mesh_shape, methods_from_args


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--x", type=int, default=128, help="shard x size")
    ap.add_argument("--y", type=int, default=128)
    ap.add_argument("--z", type=int, default=128)
    ap.add_argument("--iters", "-n", type=int, default=30)
    ap.add_argument("--batch", type=int, default=10,
                    help="iterations per timing sample")
    ap.add_argument("--kernel", default="auto",
                    choices=("auto", "wrap", "halo", "xla", "pallas"),
                    help="compute path: wrap (CUDA, periodic wrap in the "
                         "kernel, one shard), halo (CUDA on resident "
                         "shards with slab exchange), pallas (CUDA on the "
                         "halo-padded shards), xla (plain PyTorch), or "
                         "auto")
    ap.add_argument("--wrap-steps", type=int, default=0, metavar="N",
                    help="steps per launch of the N-step wrap and halo "
                         "kernels (default 2; sets STENCIL_WRAP_STEPS)")
    ap.add_argument("--mesh-shape", type=mesh_shape, default=None,
                    metavar="X,Y,Z", help="shards along x, y and z")
    ap.add_argument("--devices", default=None,
                    help="comma list of torch devices, one per mesh "
                         "position (x fastest; repeats allowed)")
    ap.add_argument("--device", default=None,
                    help="one torch device for the whole mesh")
    add_method_flags(ap)
    args = ap.parse_args(argv)
    if args.wrap_steps:
        os.environ["STENCIL_WRAP_STEPS"] = str(args.wrap_steps)

    from ..models.jacobi import Jacobi3D
    from ..numerics import Statistics
    from ..parallel.mesh import (default_mesh_shape, default_mesh_shape_xfree,
                                 resolve_devices)
    from ..parallel.methods import pick_method

    shape = args.mesh_shape
    if args.devices is not None:
        devices = args.devices.split(",")
    else:
        devices = resolve_devices(None, args.device)
        if shape is not None and len(devices) == 1:
            # every shard of the mesh on the one device
            devices = devices * (shape[0] * shape[1] * shape[2])
    if shape is None:
        xfree = args.kernel in ("halo", "auto")
        shape = tuple((default_mesh_shape_xfree if xfree
                       else default_mesh_shape)(len(devices)))
    gx, gy, gz = args.x * shape[0], args.y * shape[1], args.z * shape[2]
    j = Jacobi3D(gx, gy, gz, kernel=args.kernel, mesh_shape=shape,
                 devices=devices, methods=methods_from_args(args))
    j.init()
    stats = Statistics()
    for i in range(2 + max(args.iters // args.batch, 1)):
        t0 = time.perf_counter()
        j.run(args.batch)
        j.block()
        if i >= 2:
            stats.insert(time.perf_counter() - t0)
    b = j.dd.exchange_bytes_per_axis()
    xstats = j.exchange_stats()
    ex_s = j.measure_exchange_seconds()
    print(",".join(str(f) for f in (
        "jacobi3d", pick_method(j.dd.methods), j.dd.num_subdomains(),
        gx, gy, gz, b["x"], b["y"], b["z"],
        f"{stats.min() / args.batch:.6e}",
        f"{stats.trimean() / args.batch:.6e}",
        xstats["path"], int(xstats["bytes_per_iteration"]),
        f"{ex_s:.6e}")))


if __name__ == "__main__":
    main()
