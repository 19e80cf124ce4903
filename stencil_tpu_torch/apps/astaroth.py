"""Astaroth-style MHD mini-app over a mesh of shards.

PyTorch-port counterpart of ``apps/astaroth.py`` (reference:
astaroth/astaroth.cu main): conf-file loading, the iteration loop, and
the reference's CSV result line

    devices,nx,ny,nz,iter trimean,exch trimean,path,bytes/iter

with per-iteration seconds (reference: astaroth/astaroth.cu:668-676).
Each of ``--iters`` samples is one iteration ending in a device
synchronize, after two warm-up iterations. ``--nx/--ny/--nz`` are the
size of one shard: the global grid is that times the mesh (weak
scaling, as the JAX app does), and the line prints the global size. Run
it as

    python -m stencil_tpu_torch.apps.astaroth --nx 256 --ny 256 --nz 256
    python -m stencil_tpu_torch.apps.astaroth --nx 256 --ny 256 --nz 256 \\
        --kernel halo --mesh-shape 1,2,2 --devices cuda:0,cuda:0,cuda:0,cuda:0

    python -m stencil_tpu_torch.apps.astaroth --nx 256 --ny 256 --nz 256 \\
        --overlap --mesh-shape 1,2,2 --devices cuda:0,cuda:0,cuda:0,cuda:0

The mesh runs on every visible CUDA device unless ``--devices`` lists
one device per mesh position (repeats allowed: shards sharing a card)
or ``--device`` names one (``--device cpu`` runs the plain PyTorch
twins). With no ``--mesh-shape``, the ``halo`` and ``auto`` kernels take
an x-unsharded mesh and ``xla`` a near-cubic one. ``--overlap`` hides
each substep's exchange behind the interior compute (``halo-overlap``:
B13/B14 with ``--kernel halo``, or ``auto`` on the card; else
``xla-overlap``); the method flags (``--slab``, ``--packed``,
``--allgather``, ``--pallas-dma``) choose the exchange of the ``xla``
paths. ``--exchange-every S`` is the JAX app's temporal blocking: one
depth-3S exchange per S RK substeps (``xla-temporal[s=S]``; S=2 is the
substep pair on the halo paths). ``--f64`` and ``--bf16`` choose the
field dtype (float32 by default; bfloat16 is stored half-width and
computed in float32, on the CUDA kernels too).

Under ``python -m torch.distributed.run --nproc_per_node P`` each rank
runs its own shards (``--devices`` are its own; ``--backend gloo`` puts
several ranks on one card) and rank 0 prints the line; ``--dcn-axis`` /
``--fake-slices`` block one grid axis across hosts, as in
``apps/jacobi3d.py``.
"""

from __future__ import annotations

import argparse
import time

from ..parallel.multihost import initialize_distributed
from ._common import (add_dcn_flags, add_device_flags, add_dtype_flags,
                      add_method_flags, dcn_from_args, dtype_from_args,
                      mesh_from_args, methods_from_args)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--conf", default="", help="astaroth.conf-style file")
    ap.add_argument("--nx", type=int, default=64, help="shard x size")
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--iters", "-n", type=int, default=10)
    ap.add_argument("--kernel", default="auto",
                    choices=("auto", "wrap", "halo", "xla"),
                    help="compute path: wrap (fused CUDA substep kernels, "
                         "periodic wrap in the kernel, one shard), halo "
                         "(fused CUDA substep kernels on resident shards "
                         "with slab exchange; with --overlap the slabs "
                         "are sent inside the kernels), xla (plain "
                         "PyTorch on the halo-padded shards), or auto")
    add_dtype_flags(ap)
    ap.add_argument("--exchange-every", type=int, default=0, metavar="S",
                    help="communication-avoiding temporal blocking: one "
                         "depth-(S*R) exchange per S RK substeps "
                         "(multiples of 3 keep the w accumulator off the "
                         "wire; S=2 maps to the substep pair on the halo "
                         "paths)")
    ap.add_argument("--overlap", action="store_true",
                    help="interior/exterior comm-compute overlap per "
                         "substep")
    add_device_flags(ap)
    add_method_flags(ap)
    add_dcn_flags(ap)
    args = ap.parse_args(argv)
    rank = initialize_distributed(backend=args.backend)

    from ..models.astaroth import Astaroth, MhdParams
    from ..numerics import Statistics

    prm = MhdParams.from_conf(args.conf) if args.conf else MhdParams()
    dtype = dtype_from_args(args)
    devices, shape = mesh_from_args(args,
                                    xfree=args.kernel in ("halo", "auto"))
    gx, gy, gz = args.nx * shape[0], args.ny * shape[1], args.nz * shape[2]
    m = Astaroth(gx, gy, gz, params=prm, dtype=dtype, kernel=args.kernel,
                 mesh_shape=shape, devices=devices, overlap=args.overlap,
                 methods=methods_from_args(args),
                 exchange_every=args.exchange_every or None,
                 **dcn_from_args(args, devices))
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
    if rank != 0:
        return
    print(",".join(str(f) for f in (
        m.dd.num_subdomains(), gx, gy, gz,
        f"{stats.trimean():.6e}", f"{exch:.6e}", xstats["path"],
        int(xstats["bytes_per_iteration"]))))


if __name__ == "__main__":
    main()
