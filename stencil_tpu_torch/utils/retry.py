"""Bounded retry with exponential backoff for transient I/O.

PyTorch-port copy of ``stencil_tpu/utils/retry.py``. Long campaigns die
to transient filesystem hiccups (an NFS blip during a checkpoint save)
far more often than to real corruption. Checkpoint saves and restores
(``utils/checkpoint.py``) run through :func:`retry` so a transient
``OSError`` costs a short backoff instead of the job; persistent
failures still raise the last error after the attempt budget is spent.

The clock is injectable (``sleep=``) so recovery timing is unit-tested
with a fake clock, and ``on_retry`` lets callers (the resilience
driver's event log) record every retried failure.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type, TypeVar

T = TypeVar("T")


def retry(fn: Callable[[], T], attempts: int = 3,
          base_delay: float = 0.1,
          retriable: Tuple[Type[BaseException], ...] = (OSError,),
          sleep: Optional[Callable[[float], None]] = None,
          on_retry: Optional[Callable[[int, BaseException, float],
                                      None]] = None) -> T:
    """Call ``fn`` up to ``attempts`` times, sleeping
    ``base_delay * 2**k`` after the k-th failure (exponential backoff).

    Only exceptions matching ``retriable`` are retried — anything else
    propagates immediately (a dtype mismatch is not transient). The
    final failure re-raises the last error. ``on_retry(attempt, exc,
    delay)`` is invoked before each backoff sleep.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    if sleep is None:
        sleep = time.sleep
    for k in range(attempts):
        try:
            return fn()
        except retriable as e:  # noqa: PERF203 - retry loop by design
            if k == attempts - 1:
                raise
            delay = base_delay * (2 ** k)
            if on_retry is not None:
                on_retry(k + 1, e, delay)
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
