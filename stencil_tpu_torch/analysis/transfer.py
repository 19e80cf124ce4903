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
``STENCIL_ALLOW_TRANSFERS=1`` opts out, as in JAX.

The checker (``TransferTarget``, ``check_transfer``; checker 8): no host
sync in a hot path. A dispatch (``entries.DispatchSpec``; one dispatch
first, outside the check) runs under ``probes.OpLog``, which records
every ``aten._local_scalar_dense`` (``.item()``, ``bool(t)``,
``float(t)``) and every op whose output shape depends on the data
(``nonzero``, ``masked_select``, ...): each waits for the device on a
card. On a card the dispatch also runs under the guard above, so that
what the op log cannot see (a blocking copy) raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Iterator, Sequence

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


@dataclasses.dataclass
class TransferTarget:
    name: str
    build: Callable[[], object]

    checker = "transfer"


def check_transfer(target: TransferTarget):
    from .probes import OpLog
    from .report import Finding

    try:
        spec = target.build()
        with torch.no_grad():
            spec.dispatch()
    except Exception as e:  # noqa: BLE001
        return [Finding("transfer", target.name,
                        f"target build failed: {type(e).__name__}: {e}")]
    findings = []
    before = spec.launches() if spec.launches else None
    try:
        with torch.no_grad(), OpLog() as log, \
                hot_loop_transfer_guard(spec.devices):
            spec.dispatch()
    except RuntimeError as e:
        return [Finding("transfer", target.name,
                        f"a synchronizing CUDA call in the hot path: {e}")]
    for name in sorted(set(log.syncs)):
        findings.append(Finding(
            "transfer", target.name,
            f"{log.syncs.count(name)} host sync(s) by aten.{name} in the "
            f"hot path"))
    if not log.ops:
        findings.append(Finding("transfer", target.name,
                                "no op seen: nothing checked"))
    if before is not None and spec.launches() == before:
        findings.append(Finding("transfer", target.name,
                                "the dispatch launched no kernel: nothing "
                                "checked on the card"))
    return findings, {"ops": len(log.ops), "syncs": len(log.syncs),
                      "guarded": any(torch.device(d).type == "cuda"
                                     for d in spec.devices)}
