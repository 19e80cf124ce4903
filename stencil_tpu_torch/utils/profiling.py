"""Profiling scopes.

PyTorch-port counterpart of ``stencil_tpu/utils/profiling.py``'s
``scope`` (the analog of the reference's NVTX ranges,
src/stencil.cu:311,1003-1080): a named range that shows on a
``torch.profiler`` trace (``record_function``) and, while CUDA is in
use, as an NVTX range. The telemetry spans (``telemetry/spans.py``) wrap
it. JAX's exchange report (``exchange_stats_report``) stays ROADMAP A12.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def scope(name: str) -> Iterator[None]:
    """Label the host range ``name`` on the profiler timeline (and as
    an NVTX range once CUDA is initialized)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield
