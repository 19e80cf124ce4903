"""Pure ``exchange()`` time, strong scaling (the global size is fixed).

PyTorch-port counterpart of ``apps/exchange_strong.py`` (reference:
bin/exchange_strong.cu): ``exchange_weak``'s measurement and CSV line,
named ``exchange_strong``, with ``--x/--y/--z`` the global grid, split
over the mesh (``--mesh-shape``, or the domain's own choice over the
devices; x-unsharded with ``--interior-slabs``). Run it as

    python -m stencil_tpu_torch.apps.exchange_strong \\
        --devices cuda:0,cuda:0,cuda:0,cuda:0 --x 512 --y 512 --z 512
"""

from __future__ import annotations

import argparse

from ._common import devices_from_args, methods_from_args
from .exchange_weak import add_exchange_flags, run_exchange_bench


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_exchange_flags(ap, 512, "global")
    args = ap.parse_args(argv)
    run_exchange_bench("exchange_strong", args.x, args.y, args.z,
                       args.mesh_shape, args.radius, args.fields,
                       args.iters, methods_from_args(args),
                       devices_from_args(args),
                       interior_slabs=args.interior_slabs)


if __name__ == "__main__":
    main()
