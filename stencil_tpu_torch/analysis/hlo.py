"""Checker 4: every exchange moves point-to-point messages only.

PyTorch-port counterpart of ``stencil_tpu/analysis/hlo.py`` (every
exchange method lowers to ``collective-permute`` alone, with its bytes
counted). The port compiles no program; what it could call instead of
point-to-point messages is a ``torch.distributed`` collective. Each
rank's view of a run (every mesh position a rank of its own) goes
through ``probes.DistShim``, which records every call: only the calls
the target declares may appear (``isend``/``irecv`` in one
``batch_isend_irecv`` for the exchanges; the all-gather engine's
messages are point-to-point too, n - 1 copies of a slab on each line).
A run of a whole model step in one process (``StepSpec``) must call no
``torch.distributed`` function at all but those declared. The bytes
each call carried, and ``multihost.MESSAGES``, land in the metrics.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, Tuple, Union

import torch

from .entries import ExchangeSpec, rank_calls
from .probes import DistShim
from .report import Finding


@dataclasses.dataclass
class StepSpec:
    """A whole step (a model's ``run``, a segment, a probe) run once in
    one process under ``DistShim(0, 1)``: ``allow`` the calls it may
    make."""
    run: Callable[[], object]
    allow: Tuple[str, ...] = ()


@dataclasses.dataclass
class HloTarget:
    name: str
    build: Callable[[], Union[ExchangeSpec, StepSpec]]

    checker = "hlo"


def check_hlo(target: HloTarget):
    from ..parallel import multihost

    try:
        spec = target.build()
    except Exception as e:  # noqa: BLE001
        return [Finding("hlo", target.name,
                        f"target build failed: {type(e).__name__}: {e}")]
    before = dict(multihost.MESSAGES)
    if isinstance(spec, StepSpec):
        with torch.no_grad(), DistShim(0, 1) as shim:
            spec.run()
        calls = shim.calls
    else:
        calls = rank_calls(spec)
    names = Counter(c.name for c in calls)
    findings = [Finding("hlo", target.name,
                        f"{n} call(s) of torch.distributed.{name}, which "
                        f"the target does not declare (allowed: "
                        f"{list(spec.allow) or 'none'})")
                for name, n in sorted(names.items())
                if name not in spec.allow]
    if isinstance(spec, ExchangeSpec) and not names.get("isend"):
        findings.append(Finding("hlo", target.name,
                                "no point-to-point message: nothing "
                                "checked"))
    sent = {k: multihost.MESSAGES[k] - before[k] for k in before}
    return findings, {"calls": dict(names),
                      "bytes": {name: sum(c.nbytes for c in calls
                                          if c.name == name)
                                for name in names},
                      "multihost_messages": sent}
