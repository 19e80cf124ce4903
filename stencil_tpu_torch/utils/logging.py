"""Leveled stderr logging.

PyTorch-port counterpart of ``stencil_tpu/utils/logging.py`` (the
analog of the reference's leveled macros, include/stencil/logging.hpp:
12-53): level from ``STENCIL_TPU_LOG`` (spew|debug|info|warn|error|
fatal, default info), read when a message is emitted. Messages carry
the ``torch.distributed`` rank when a process group is up, else 0.
"""

from __future__ import annotations

import os
import sys

_LEVELS = {"spew": 0, "debug": 1, "info": 2, "warn": 3, "error": 4, "fatal": 5}


def _level() -> int:
    return _LEVELS.get(os.environ.get("STENCIL_TPU_LOG", "info").lower(), 2)


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _emit(tag: str, lvl: int, msg: str) -> None:
    if lvl >= _level():
        print(f"[{_rank()}] {tag}: {msg}", file=sys.stderr)


def LOG_DEBUG(msg: str) -> None:
    _emit("DEBUG", 1, msg)


def LOG_INFO(msg: str) -> None:
    _emit("INFO", 2, msg)


def LOG_WARN(msg: str) -> None:
    _emit("WARN", 3, msg)
