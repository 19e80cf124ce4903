"""Exchange-strategy comparison sweep.

PyTorch-port counterpart of ``apps/bench_methods.py`` (reference:
bin/bench_alltoallv.cu, bin/bench_mpi_pack.cu): every exchange
``Method`` on one configuration — ``PpermuteSlab`` (the slab copy),
``PpermutePacked`` (one buffer a direction for every quantity),
``AllGather`` (each mesh line's boundary slabs gathered onto every
device) and ``PallasDMA`` (the remote-write kernel B4) — with trimean
seconds and B/s, one line per method:

    bench_methods,method,devices,x,y,z,radius,fields,bytes,trimean (s),B/s

``--x/--y/--z`` are the size of one shard. Run it as

    python -m stencil_tpu_torch.apps.bench_methods \\
        --devices cuda:0,cuda:0,cuda:0,cuda:0
"""

from __future__ import annotations

import argparse

from ._common import add_device_flags, csv_line, mesh_from_args, timed_samples


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--x", type=int, default=64, help="per-shard x size")
    ap.add_argument("--y", type=int, default=64)
    ap.add_argument("--z", type=int, default=64)
    ap.add_argument("--radius", "-r", type=int, default=2)
    ap.add_argument("--fields", type=int, default=4)
    ap.add_argument("--iters", "-n", type=int, default=20)
    add_device_flags(ap)
    args = ap.parse_args(argv)

    import torch

    from ..distributed import DistributedDomain
    from ..parallel.methods import Method
    from ..utils.timers import device_sync

    devices, shape = mesh_from_args(args)
    ndev = len(devices)
    for method in (Method.PpermuteSlab, Method.PpermutePacked,
                   Method.AllGather, Method.PallasDMA):
        dd = DistributedDomain(args.x * shape[0], args.y * shape[1],
                               args.z * shape[2], devices=devices)
        dd.set_mesh_shape(shape)
        dd.set_radius(args.radius)
        dd.set_methods(method)
        for i in range(args.fields):
            dd.add_data(f"q{i}", torch.float32)
        dd.realize()
        stats = timed_samples(
            dd.exchange,
            lambda: device_sync([t for v in dd.curr.values() for t in v]),
            args.iters)
        total = dd.exchange_bytes_total()
        tm = stats.trimean()
        print(csv_line("bench_methods", method, ndev, args.x, args.y,
                       args.z, args.radius, args.fields, total, f"{tm:.6e}",
                       f"{total / tm:.6e}"))
        del dd


if __name__ == "__main__":
    main()
