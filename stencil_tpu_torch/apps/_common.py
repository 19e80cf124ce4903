"""Command-line pieces the port's apps share.

PyTorch-port counterpart of the parts of ``apps/_common.py`` the ported
apps use: the ``--mesh-shape`` parser and the per-method exchange flags
(reference: bin/jacobi3d.cu:107-122).
"""

from __future__ import annotations

import argparse


def mesh_shape(text: str):
    """``X,Y,Z`` as a tuple of three positive ints (``--mesh-shape``)."""
    parts = [int(v) for v in text.split(",")]
    if len(parts) != 3 or min(parts) < 1:
        raise argparse.ArgumentTypeError("--mesh-shape wants X,Y,Z")
    return tuple(parts)


def add_method_flags(ap: argparse.ArgumentParser) -> None:
    """The analog of the reference's per-method CLI flags (reference:
    bin/jacobi3d.cu:107-122)."""
    ap.add_argument("--slab", action="store_true",
                    help="per-axis slab copy (default)")
    ap.add_argument("--packed", action="store_true",
                    help="packed exchange (runs the slab copy in the port)")
    ap.add_argument("--allgather", action="store_true",
                    help="all-gather exchange (runs the slab copy in the "
                         "port)")
    ap.add_argument("--pallas-dma", action="store_true",
                    help="remote-write exchange: each shard's kernel stores "
                         "its slabs into its neighbours' halos")


def methods_from_args(args):
    """The ``Method`` flags the method flags ask for; ``Method.Default``
    when none is given."""
    from ..parallel.methods import Method

    m = Method.NONE
    for flag, method in (("slab", Method.PpermuteSlab),
                         ("packed", Method.PpermutePacked),
                         ("allgather", Method.AllGather),
                         ("pallas_dma", Method.PallasDMA)):
        if getattr(args, flag, False):
            m |= method
    return m if m != Method.NONE else Method.Default
