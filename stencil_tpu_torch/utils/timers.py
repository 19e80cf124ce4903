"""Device fences for host-clock timing, and the kernels a call launches.

PyTorch-port counterpart of ``device_sync`` in
``stencil_tpu/utils/timers.py``. CUDA work is launched asynchronously,
so a host clock measures device time only after ``device_sync``.
``kernel_profile`` reads ``torch.profiler``'s per-kernel device times
and launch counts (``chip_smoke.py``, the card tests).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, Tuple, Union

import torch


def device_sync(tensors: Union[torch.Tensor, Iterable[torch.Tensor]]) -> None:
    """Wait for all queued work on the device(s) holding ``tensors``:
    ``torch.cuda.synchronize`` for a CUDA tensor; CPU tensors are
    already complete."""
    if isinstance(tensors, torch.Tensor):
        tensors = (tensors,)
    for t in tensors:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)


def kernel_profile(fn: Callable[[], object], reps: int = 1
                   ) -> Tuple[Dict[str, Dict[str, float]], int]:
    """The CUDA kernels one ``fn()`` launches, from ``torch.profiler``
    over ``reps`` calls after one unprofiled call: ({kernel name,
    template arguments dropped: {"us": device microseconds a call,
    "launches": launches a call}}, the calls of ``fn`` made). A profile
    in which the profiler saw no kernel at all is taken again, up to
    three times: it sometimes returns none (seen once in a full run of
    the card tests) while ``fn`` launched kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    calls, out = 1, {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        calls += reps
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            m = re.search(r"(\w+)(?:<[^<>()]*>)?\(", e.key)
            got = out.setdefault(m.group(1) if m else e.key[:80],
                                 {"us": 0.0, "launches": 0.0})
            got["us"] += us / reps
            got["launches"] += e.count / reps
        if out:
            break
    return out, calls
