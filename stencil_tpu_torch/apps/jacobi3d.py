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
prints the one that ran. ``--exchange-every S`` is the temporal depth
(``Jacobi3D(exchange_every=S)``): N of the N-step kernels on ``wrap``
and ``halo``, one deep exchange per S steps on the padded paths
(``xla-temporal[s=S]``); ``--wrap-steps N`` sets STENCIL_WRAP_STEPS,
which an explicit ``--exchange-every`` overrides. ``--bf16`` runs a
bfloat16 field on the kernels' bfloat16 instances (up to 16 steps a
group, bfloat16's sublane tile), ``--f64`` a float64 one on the plain
paths, as JAX's ``--bf16`` / ``--f64`` do.
"""

from __future__ import annotations

import argparse
import os

from ._common import (KERNEL_CHOICES, add_device_flags, add_dtype_flags,
                      add_method_flags, dtype_from_args, mesh_from_args,
                      methods_from_args, sampled_steps_per_s)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--x", type=int, default=128, help="shard x size")
    ap.add_argument("--y", type=int, default=128)
    ap.add_argument("--z", type=int, default=128)
    ap.add_argument("--iters", "-n", type=int, default=30)
    ap.add_argument("--batch", type=int, default=10,
                    help="iterations per timing sample")
    ap.add_argument("--kernel", default="auto", choices=KERNEL_CHOICES,
                    help="compute path: wrap (CUDA, periodic wrap in the "
                         "kernel, one shard), halo (CUDA on resident "
                         "shards with slab exchange), pallas (CUDA on the "
                         "halo-padded shards), xla (plain PyTorch), or "
                         "auto")
    ap.add_argument("--wrap-steps", type=int, default=0, metavar="N",
                    help="steps per launch of the N-step wrap and halo "
                         "kernels (default 2; sets STENCIL_WRAP_STEPS)")
    ap.add_argument("--exchange-every", type=int, default=0, metavar="S",
                    help="temporal blocking depth: one depth-S exchange "
                         "per S steps (xla), S steps a launch (wrap, "
                         "halo); 0 leaves the default")
    add_device_flags(ap)
    add_method_flags(ap)
    add_dtype_flags(ap)
    args = ap.parse_args(argv)
    if args.wrap_steps:
        os.environ["STENCIL_WRAP_STEPS"] = str(args.wrap_steps)

    from ..models.jacobi import Jacobi3D
    from ..parallel.methods import pick_method

    devices, shape = mesh_from_args(args,
                                    xfree=args.kernel in ("halo", "auto"))
    gx, gy, gz = args.x * shape[0], args.y * shape[1], args.z * shape[2]
    j = Jacobi3D(gx, gy, gz, dtype=dtype_from_args(args),
                 kernel=args.kernel, mesh_shape=shape,
                 devices=devices, methods=methods_from_args(args),
                 exchange_every=args.exchange_every or None)
    j.init()
    stats, _ = sampled_steps_per_s(lambda: j.run(args.batch), j.block,
                                   max(args.iters // args.batch, 1),
                                   args.batch)
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
