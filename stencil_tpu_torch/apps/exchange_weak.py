"""Pure ``exchange()`` time, weak scaling (the shard size is fixed).

PyTorch-port counterpart of ``apps/exchange_weak.py`` (reference:
bin/exchange_weak.cu, "measure purely total exchange time"): one
``DistributedDomain`` of ``--fields`` float32 quantities at ``--radius``
over the mesh, ``dd.exchange()`` timed ``--iters`` times, and the line

    exchange_weak,methods,devices,x,y,z,radius,fields,bytes,min (s),trimean (s),B/s

with the global size. ``--interior-slabs`` times the fused halo paths'
transfer instead: ``exchange_interior_slabs`` rounds on interior-resident
zero shards of an x-unsharded mesh (``measure_slab_exchange_seconds``),
with the models' byte count (``interior_slab_bytes``), as
``exchange_weak_slabs,InteriorSlabs,...``. The slabs are the port's
halo-path layout: exactly the rows that cross (``rz = ry = radius``),
where JAX's pad them to its 8-row tile. Run it as

    python -m stencil_tpu_torch.apps.exchange_weak \\
        --devices cuda:0,cuda:0,cuda:0,cuda:0 --x 256 --y 256 --z 256
"""

from __future__ import annotations

import argparse

from ._common import (add_device_flags, add_method_flags, csv_line,
                      mesh_from_args, methods_from_args, timed_samples)


def run_exchange_bench(name: str, gx: int, gy: int, gz: int, mesh_shape,
                       radius: int, fields: int, iters: int, methods,
                       devices, interior_slabs: bool = False) -> None:
    import torch

    from ..distributed import DistributedDomain
    from ..utils.timers import device_sync

    if interior_slabs:
        from ..geometry import Dim3
        from ..parallel.exchange import (interior_slab_bytes,
                                         measure_slab_exchange_seconds)
        from ..parallel.mesh import Mesh, default_mesh_shape_xfree

        counts = Dim3(*(mesh_shape or
                        default_mesh_shape_xfree(len(devices))))
        mesh = Mesh(counts, devices)
        ndev = counts.flatten()
        if counts.x != 1:
            raise SystemExit("--interior-slabs needs an x-unsharded mesh "
                             "(the fused halo-path contract)")
        if gx % counts.x or gy % counts.y or gz % counts.z:
            raise SystemExit("--interior-slabs needs an evenly divisible "
                             "grid")
        local = Dim3(gx // counts.x, gy // counts.y, gz // counts.z)
        if radius > min(local.z, local.y):
            raise SystemExit(f"--radius {radius} exceeds the local shard "
                             f"{local}")
        sec = measure_slab_exchange_seconds(
            mesh, local, torch.float32, rz=radius, ry=radius,
            radius_rows=radius, y_z_extended=True, nfields=fields,
            reps=iters)
        total = interior_slab_bytes(
            (local.z, local.y, local.x), counts, radius, 4,
            y_z_extended=True) * ndev * fields
        print(csv_line(name + "_slabs", "InteriorSlabs", ndev, gx, gy, gz,
                       radius, fields, total, f"{sec:.6e}", f"{sec:.6e}",
                       f"{(total / sec if sec else 0):.6e}"))
        return
    dd = DistributedDomain(gx, gy, gz, devices=devices)
    if mesh_shape is not None:
        dd.set_mesh_shape(mesh_shape)
    dd.set_radius(radius)
    dd.set_methods(methods)
    for i in range(fields):
        dd.add_data(f"q{i}", torch.float32)
    dd.realize()
    ndev = dd.num_subdomains()
    stats = timed_samples(
        dd.exchange,
        lambda: device_sync([t for v in dd.curr.values() for t in v]), iters)
    total = dd.exchange_bytes_total()
    tm = stats.trimean()
    print(csv_line(name, dd.methods, ndev, gx, gy, gz, radius, fields,
                   total, f"{stats.min():.6e}", f"{tm:.6e}",
                   f"{(total / tm if tm else 0):.6e}"))


def add_exchange_flags(ap: argparse.ArgumentParser, size: int,
                       what: str) -> None:
    ap.add_argument("--x", type=int, default=size, help=f"{what} x size")
    ap.add_argument("--y", type=int, default=size)
    ap.add_argument("--z", type=int, default=size)
    ap.add_argument("--radius", type=int, default=3)
    ap.add_argument("--fields", type=int, default=1)
    ap.add_argument("--iters", "-n", type=int, default=30)
    ap.add_argument("--interior-slabs", action="store_true",
                    help="time the fused halo paths' interior-resident "
                         "slab exchange instead of the padded exchange "
                         "(x-unsharded mesh)")
    add_method_flags(ap)
    add_device_flags(ap)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_exchange_flags(ap, 256, "per-shard")
    args = ap.parse_args(argv)
    devices, shape = mesh_from_args(args, xfree=args.interior_slabs)
    run_exchange_bench("exchange_weak", args.x * shape[0], args.y * shape[1],
                       args.z * shape[2], shape, args.radius, args.fields,
                       args.iters, methods_from_args(args), devices,
                       interior_slabs=args.interior_slabs)


if __name__ == "__main__":
    main()
