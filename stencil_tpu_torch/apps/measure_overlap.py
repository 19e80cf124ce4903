"""Comm/compute overlap study on the Jacobi-3D step and the MHD substeps.

PyTorch-port counterpart of ``apps/measure_overlap.py`` (reference:
bin/measure_buf_exchange.cu). It times three programs at the same size
— the slab exchange alone (``exchange_only``), the step with its
exchange in program order (``fused``: the ``halo`` path on a mesh,
``auto`` on one shard) and the overlapped step (``overlap``: B7, the
faces sent while the interior is computed) — and reports how much of the
exchange the overlapped step hides:

    overlap_efficiency = (t_fused - t_overlap) / t_exchange

as one CSV line ``measure_overlap,shards,x,y,z,exchange_only (s),fused
(s),overlap (s),overlap_efficiency`` (trimeans of ``--iters`` samples,
each ending in a device synchronize). ``--x/--y/--z`` are the size of one
shard (weak scaling, as the JAX app); the mesh runs on every visible
CUDA device, or ``--devices`` lists one device per mesh position
(repeats allowed: shards sharing a card), e.g.

    python -m stencil_tpu_torch.apps.measure_overlap --x 512 --y 256 \\
        --z 256 --mesh-shape 1,2,2 --devices cuda:0,cuda:0,cuda:0,cuda:0

``--model mhd`` (JAX's ``measure_mhd``) runs the same study on the
Astaroth integrator, float32: fused is the ``halo`` path (slab round
THEN B11, three times an iteration; the halo family on any shard count,
so that all three programs share one kernel family), exchange only its
slab rounds timed alone (``Astaroth.measure_exchange_seconds``), and
overlap ``halo-overlap`` (B13/B14, the rows sent inside the kernels);
times are per iteration.
"""

from __future__ import annotations

import argparse
import time

from ._common import mesh_shape


def timed_samples(fn, sync, iters: int, warmup: int = 2):
    """Time ``fn()`` ``iters`` times after ``warmup`` calls, each sample
    fenced by ``sync()``; returns the ``Statistics`` accumulator."""
    from ..numerics import Statistics

    for _ in range(warmup):
        fn()
    sync()
    stats = Statistics()
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        stats.insert(time.perf_counter() - t0)
    return stats


def _mesh(x: int, y: int, z: int, mesh_shape, devices):
    """(mesh shape, one device per shard, result dict with the shard
    count and the global size) for shards of ``x`` x ``y`` x ``z`` over
    ``mesh_shape`` (default: x-unsharded over ``devices``, every visible
    CUDA device when None; one device repeats for every shard)."""
    from ..parallel.mesh import (default_mesh_shape, default_mesh_shape_xfree,
                                 resolve_devices)

    devs = resolve_devices(devices)
    shape = mesh_shape
    if shape is None:
        shape = tuple((default_mesh_shape_xfree if len(devs) > 1
                       else default_mesh_shape)(len(devs)))
    n = shape[0] * shape[1] * shape[2]
    if len(devs) == 1 and n > 1:
        devs = devs * n
    size = (x * shape[0], y * shape[1], z * shape[2])
    return shape, devs, {"shards": n, "size": size}


def _efficiency(res: dict) -> dict:
    hidden = res["fused"] - res["overlap"]
    res["overlap_efficiency"] = (hidden / res["exchange_only"]
                                 if res["exchange_only"] else 0.0)
    return res


def measure(x: int, y: int, z: int, iters: int = 20, mesh_shape=None,
            devices=None) -> dict:
    """The three trimeans (seconds) and the efficiency, for shards of
    ``x`` x ``y`` x ``z`` over ``mesh_shape`` (default: x-unsharded over
    ``devices``, every visible CUDA device when None)."""
    import torch

    from ..geometry import Dim3
    from ..models.jacobi import Jacobi3D
    from ..parallel.exchange import exchange_interior_slabs
    from ..utils.timers import device_sync

    shape, devs, res = _mesh(x, y, z, mesh_shape, devices)
    gx, gy, gz = res["size"]
    # fused and overlap share the kernel family: on a mesh the halo path
    # (slab exchange THEN kernels) against B7; on one shard auto
    kern = "halo" if res["shards"] > 1 else "auto"
    fused = Jacobi3D(gx, gy, gz, kernel=kern, mesh_shape=shape, devices=devs)
    fused.init()
    res["fused"] = timed_samples(fused.step, fused.block, iters).trimean()
    res["fused_path"] = fused.kernel_path
    # the single-row face slabs the overlap kernel sends, as a slab round
    # over zero shards of the same mesh
    dd = fused.dd
    c = dd.local_size
    zeros = [torch.zeros((c.z, c.y, c.x), device=d) for d in dd.mesh.devices]
    out = []

    def ex_only():
        out[:] = exchange_interior_slabs(zeros, Dim3(*shape), rz=1, ry=1)

    res["exchange_only"] = timed_samples(
        ex_only, lambda: device_sync([s["yhi"] for s in out]),
        iters).trimean()
    del fused, zeros, out
    over = Jacobi3D(gx, gy, gz, kernel=kern, overlap=True, mesh_shape=shape,
                    devices=devs)
    over.init()
    res["overlap"] = timed_samples(over.step, over.block, iters).trimean()
    res["overlap_path"] = over.kernel_path
    return _efficiency(res)


def measure_mhd(x: int, y: int, z: int, iters: int = 20, mesh_shape=None,
                devices=None) -> dict:
    """As ``measure``, on the Astaroth integrator (float32; JAX's
    ``measure_mhd``): fused = ``kernel="halo"``, exchange only =
    its ``measure_exchange_seconds()``, overlap = ``kernel="halo",
    overlap=True``; seconds per iteration."""
    import torch

    from ..models.astaroth import Astaroth

    shape, devs, res = _mesh(x, y, z, mesh_shape, devices)
    gx, gy, gz = res["size"]
    fused = Astaroth(gx, gy, gz, dtype=torch.float32, kernel="halo",
                     mesh_shape=shape, devices=devs)
    fused.init()
    res["fused"] = timed_samples(fused.step, fused.block, iters).trimean()
    res["fused_path"] = fused.kernel_path
    res["exchange_only"] = fused.measure_exchange_seconds()
    del fused
    over = Astaroth(gx, gy, gz, dtype=torch.float32, kernel="halo",
                    overlap=True, mesh_shape=shape, devices=devs)
    over.init()
    res["overlap"] = timed_samples(over.step, over.block, iters).trimean()
    res["overlap_path"] = over.kernel_path
    return _efficiency(res)


def csv_line(res: dict, label: str = "measure_overlap") -> str:
    gx, gy, gz = res["size"]
    return ",".join(str(f) for f in (
        label, res["shards"], gx, gy, gz,
        f"{res['exchange_only']:.6e}", f"{res['fused']:.6e}",
        f"{res['overlap']:.6e}", f"{res['overlap_efficiency']:.3f}"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--x", type=int, default=64, help="shard x size")
    ap.add_argument("--y", type=int, default=64)
    ap.add_argument("--z", type=int, default=64)
    ap.add_argument("--iters", "-n", type=int, default=20)
    ap.add_argument("--model", default="jacobi", choices=("jacobi", "mhd"))
    ap.add_argument("--mesh-shape", type=mesh_shape, default=None,
                    metavar="X,Y,Z", help="shards along x, y and z")
    ap.add_argument("--devices", default=None,
                    help="comma list of torch devices, one per mesh "
                         "position (x fastest; repeats allowed)")
    ap.add_argument("--device", default=None,
                    help="one torch device for every shard (cpu runs the "
                         "plain PyTorch twins)")
    args = ap.parse_args(argv)
    devices = (args.devices.split(",") if args.devices
               else [args.device] if args.device else None)
    if args.model == "mhd":
        print(csv_line(measure_mhd(args.x, args.y, args.z, args.iters,
                                   args.mesh_shape, devices),
                       "measure_overlap_mhd"))
        return
    print(csv_line(measure(args.x, args.y, args.z, args.iters,
                           args.mesh_shape, devices)))


if __name__ == "__main__":
    main()
