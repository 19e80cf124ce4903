"""Pack/unpack throughput by shard size.

PyTorch-port counterpart of ``apps/bench_pack.py`` (reference:
bin/bench_pack.cu — DevicePacker/Unpacker throughput by direction and
size). On a halo-padded shard of ``--fields`` float32 quantities (``n^3``
interior, radius ``--radius``; ``local_domain.raw_size``/``zyx_shape``),
the pack copies, for each of the 26 directions, every field's interior
region next to that side (the region a neighbour receives) into one flat
buffer; the unpack scatters the buffer back into the halo region on that
side. JAX's version packs the +x side alone with ``jax.lax``; this one
packs every direction's halo region, as the reference's packer does.
One line a size:

    bench_pack,n,radius,fields,bytes,trimean (s),B/s

``bytes`` counts the packed bytes twice (pack and unpack). Run it as

    python -m stencil_tpu_torch.apps.bench_pack --device cuda
"""

from __future__ import annotations

import argparse
import time

from ._common import add_device_flags, csv_line, devices_from_args


def halo_regions(sz, radius):
    """(send, recv) slices of each of the 26 directions of a padded
    shard: the interior region next to that side, and that side's halo
    region (reference: src/local_domain.cu:86-129 halo_pos)."""
    from ..geometry import all_directions
    from ..local_domain import halo_extent, halo_pos

    out = []
    for d in all_directions():
        ext = halo_extent(d, sz, radius)
        if ext.flatten() == 0:
            continue
        regions = []
        for halo in (False, True):
            pos = halo_pos(d, sz, radius, halo)
            regions.append(tuple(slice(pos[a], pos[a] + ext[a])
                                 for a in (2, 1, 0)))
        out.append((regions[0], regions[1], ext.flatten()))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[32, 64, 128, 256])
    ap.add_argument("--radius", type=int, default=2)
    ap.add_argument("--fields", type=int, default=4)
    ap.add_argument("--iters", "-n", type=int, default=20)
    add_device_flags(ap, mesh=False)
    args = ap.parse_args(argv)

    import torch

    from ..geometry import Dim3, Radius
    from ..local_domain import raw_size, zyx_shape
    from ..numerics import Statistics
    from ..utils.timers import device_sync

    dev = torch.device(devices_from_args(args)[0])
    r = args.radius
    radius = Radius.constant(r)
    for n in args.sizes:
        sz = Dim3(n, n, n)
        shape = zyx_shape(raw_size(sz, radius))
        arrs = [torch.full(shape, float(i), device=dev)
                for i in range(args.fields)]
        regions = halo_regions(sz, radius)
        count = sum(c for _, _, c in regions) * args.fields
        buf = torch.empty(count, device=dev)

        def roundtrip():
            off = 0
            for a in arrs:                       # pack
                for send, _, c in regions:
                    buf[off:off + c].view(a[send].shape).copy_(a[send])
                    off += c
            off = 0
            for a in arrs:                       # unpack
                for _, recv, c in regions:
                    a[recv].copy_(buf[off:off + c].view(a[recv].shape))
                    off += c

        roundtrip()
        device_sync(arrs)
        stats = Statistics()
        for _ in range(args.iters):
            t0 = time.perf_counter()
            roundtrip()
            device_sync(arrs)
            stats.insert(time.perf_counter() - t0)
        nbytes = count * 4 * 2                   # pack + unpack
        tm = stats.trimean()
        print(csv_line("bench_pack", n, r, args.fields, nbytes, f"{tm:.6e}",
                       f"{nbytes / tm:.6e}"))


if __name__ == "__main__":
    main()
