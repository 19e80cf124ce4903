"""Checker 7: an entry JAX donates updates its carry in place.

PyTorch-port counterpart of ``stencil_tpu/analysis/donation.py`` (every
donated buffer aliases an output in the compiled program). The port
runs eagerly, so donation is what its code does with the carry: after a
dispatch (``entries.DispatchSpec``; one dispatch first, outside the
check, so first-use allocations do not count) the carry's tensors are
the ones passed in (their ``data_ptr``s, as a set: a declared curr/next
swap permutes them), and no op inside the dispatch allocated a tensor
of the carry's size (``probes.OpLog`` sees every aten op: an output
whose storage no input holds is an allocation; on the card the same).
A known break recorded in the ROADMAP (``spec.known``) is a warning
that cites it; any other is an error.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .entries import DispatchSpec
from .probes import OpLog
from .report import ERROR, WARNING, Finding


@dataclasses.dataclass
class DonationTarget:
    name: str
    build: Callable[[], DispatchSpec]

    checker = "donation"


def _finding(name: str, known, message: str) -> Finding:
    if known:
        return Finding("donation", name, f"{message} ({known})", WARNING)
    return Finding("donation", name, message, ERROR)


def check_donation(target: DonationTarget):
    try:
        spec = target.build()
        with torch.no_grad():
            spec.dispatch()
    except Exception as e:  # noqa: BLE001
        return [Finding("donation", target.name,
                        f"target build failed: {type(e).__name__}: {e}")]
    carry = spec.carry()
    before = {t.data_ptr() for t in carry}
    size = max(t.untyped_storage().nbytes() for t in carry)
    before_launches = spec.launches() if spec.launches else None
    with torch.no_grad(), OpLog() as log:
        spec.dispatch()
    after = {t.data_ptr() for t in spec.carry()}
    big = [n for n in log.allocations if n >= size]
    findings = []
    if after != before:
        findings.append(_finding(
            target.name, spec.known,
            f"{len(after - before)} of {len(after)} carry tensors are new "
            f"after a dispatch: the carry is copied, not updated in "
            f"place"))
    if big:
        findings.append(_finding(
            target.name, spec.known or spec.known_allocations,
            f"{len(big)} carry-sized allocation(s) (>= {size} B, the "
            f"largest carry tensor) inside the dispatch"))
    if before_launches is not None and spec.launches() == before_launches:
        findings.append(Finding("donation", target.name,
                                "the dispatch launched no kernel: nothing "
                                "checked on the card"))
    return findings, {"carry_tensors": len(carry), "carry_bytes": size,
                      "allocations": len(log.allocations),
                      "carry_sized_allocations": len(big)}
