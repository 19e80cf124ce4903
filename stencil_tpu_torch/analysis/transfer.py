"""The hot-loop transfer guard.

PyTorch-port counterpart of the runtime half of
``stencil_tpu/analysis/transfer.py`` (``hot_loop_transfer_guard``,
``:51``). JAX wraps each fused-segment dispatch in
``jax.transfer_guard("disallow")``; the port's twin is
``torch.cuda.set_sync_debug_mode("error")`` around the dispatch on a
card: any operation inside it that would block the host on the device
(an implicit device-to-host copy, a ``.item()``, a blocking
``torch.tensor(..., device="cuda")``) raises instead of stalling the
pipeline. On the CPU there is nothing to guard (a null context).
``STENCIL_ALLOW_TRANSFERS=1`` opts out, as in JAX. The static checker
of JAX's module stays ROADMAP A14.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Sequence

import torch

#: the env var that disables the runtime transfer guard
ALLOW_TRANSFERS_ENV = "STENCIL_ALLOW_TRANSFERS"


@contextlib.contextmanager
def _sync_errors() -> Iterator[None]:
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def hot_loop_transfer_guard(devices: Sequence = ()):
    """The guard a segment dispatch runs under: synchronizing CUDA calls
    raise while it is active, when any of ``devices`` (the dispatch's
    shards' devices) is a card; a null context otherwise or under
    ``STENCIL_ALLOW_TRANSFERS=1``."""
    if os.environ.get(ALLOW_TRANSFERS_ENV, "") == "1" or not any(
            torch.device(d).type == "cuda" for d in devices):
        return contextlib.nullcontext()
    return _sync_errors()
