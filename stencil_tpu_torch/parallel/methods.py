"""Exchange-strategy flags.

PyTorch-port counterpart of ``stencil_tpu/parallel/methods.py`` (the
analog of the reference's Method bitflags,
include/stencil/method.hpp:5-16). The flag names are kept so that a
configuration reads the same in both packages. ``parallel/exchange.py``
``dispatch_exchange`` routes them: ``PallasDMA`` to the hand-written
remote-write kernel (``parallel/cuda_exchange.py``, B4: each shard
stores its boundary slabs straight into its neighbours' halos), every
other transport to the slab copy of ``exchange_shard``.
"""

from __future__ import annotations

import enum
from typing import Tuple


class Method(enum.Flag):
    """Bitmask of allowed exchange strategies
    (reference: include/stencil/method.hpp:5-16 to_string at :31-74)."""

    NONE = 0
    PpermuteSlab = 1
    PpermutePacked = 2
    PallasDMA = 4
    AllGather = 8
    Auto = 16
    Default = PpermuteSlab

    def __str__(self) -> str:  # reference: method.hpp to_string
        names = ["PpermuteSlab", "PpermutePacked", "PallasDMA",
                 "AllGather", "Auto"]
        parts = [n for n in names if Method[n] in self]
        return "|".join(parts) if parts else "none"


#: transport flags in routing-priority order (Auto is not a transport)
METHOD_PRIORITY: Tuple["Method", ...] = (
    Method.PallasDMA, Method.PpermutePacked, Method.PpermuteSlab,
    Method.AllGather)


def pick_method(methods: "Method") -> "Method":
    """Choose the single strategy the exchange will use: the requested
    transport of highest priority (the analog of the reference's
    per-pair transport routing, src/stencil.cu:371-458). Every transport
    runs in the port — ``PallasDMA`` as its CUDA kernel on the card and
    as the kernel's plain twin on the CPU —, so nothing requested is
    ever replaced by another. ``Method.Auto`` alone raises: the port has
    no exchange autotuner yet."""
    requested = [m for m in METHOD_PRIORITY if m in methods]
    if requested:
        return requested[0]
    if Method.Auto in methods:
        raise ValueError("Method.Auto carries no transport, and the port "
                         "has no exchange autotuner yet: name a method")
    raise ValueError(f"no usable method in {methods}")
