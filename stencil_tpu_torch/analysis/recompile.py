"""The single-compile watchdog.

PyTorch-port counterpart of the runtime half of
``stencil_tpu/analysis/recompile.py`` (``SingleCompileGuard``,
``:243``): with ``STENCIL_ASSERT_SINGLE_COMPILE=1`` the resilience
driver raises if its hot loop compiled anything after the first
dispatch. JAX watches a jitted function's trace cache; the port runs no
tracing compiler, and its only run-time compilation is ``nvcc`` building
a kernel library at first use (``ops/_build.py``), so the guard watches
the count of libraries built in this process. The first dispatch of a
segment factory may build (first use); any build after it raises.

The checker (``RecompileTarget``, ``check_recompile``; checker 9) holds
an entry's dispatches stable, as JAX's fingerprints do: after a first
dispatch, a second builds no kernel library (``ops/_build.BUILDS``
unchanged), the carry keeps its shapes, dtypes and devices, and paired
curr/next buffers (``DistributedDomain.swap``) agree in all three.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

#: arm the runtime build-count guard in the resilience driver
ASSERT_SINGLE_COMPILE_ENV = "STENCIL_ASSERT_SINGLE_COMPILE"


class RecompileGuardError(RuntimeError):
    """A guarded hot loop built a kernel library after its first
    dispatch."""


def builds() -> int:
    """Kernel libraries ``nvcc`` built in this process so far."""
    from ..ops import _build

    return _build.BUILDS


class SingleCompileGuard:
    """Cross-dispatch build watchdog: observe each dispatch of a segment
    factory; any build after the first observation of that factory
    means the hot loop is compiling."""

    def __init__(self) -> None:
        # keyed by id(factory) but HOLDING it: a freed factory's id can
        # be recycled by a new one, which must start from a new baseline
        self._seen: Dict[int, Tuple[object, int]] = {}

    def observe(self, factory, label: str = "") -> None:
        now = builds()
        prev = self._seen.get(id(factory))
        if prev is not None and prev[0] is factory and now > prev[1]:
            raise RecompileGuardError(
                f"{label or factory}: {now - prev[1]} kernel "
                f"librar{'y' if now - prev[1] == 1 else 'ies'} built "
                f"between dispatches — the hot loop is compiling")
        self._seen[id(factory)] = (factory, now)


@dataclasses.dataclass
class RecompileTarget:
    name: str
    build: Callable[[], object]

    checker = "recompile"


def _signature(tensors) -> list:
    return [(tuple(t.shape), t.dtype, str(t.device)) for t in tensors]


def check_recompile(target: RecompileTarget):
    import torch

    from .report import Finding

    try:
        spec = target.build()
        with torch.no_grad():
            spec.dispatch()
    except Exception as e:  # noqa: BLE001
        return [Finding("recompile", target.name,
                        f"target build failed: {type(e).__name__}: {e}")]
    guard = SingleCompileGuard()
    guard.observe(spec.dispatch, target.name)
    sig = _signature(spec.carry())
    findings = []
    with torch.no_grad():
        spec.dispatch()
    try:
        guard.observe(spec.dispatch, target.name)
    except RecompileGuardError as e:
        findings.append(Finding("recompile", target.name, str(e)))
    now = _signature(spec.carry())
    if now != sig:
        findings.append(Finding(
            "recompile", target.name,
            "the carry's shapes, dtypes or devices changed across a "
            "dispatch: the next one would run another specialization"))
    for a, b in (spec.pairs() if spec.pairs else ()):
        if _signature([a]) != _signature([b]):
            findings.append(Finding(
                "recompile", target.name,
                f"paired buffers differ: {_signature([a])} vs "
                f"{_signature([b])}"))
    if not sig:
        findings.append(Finding("recompile", target.name,
                                "no carry: nothing checked"))
    return findings, {"carry_tensors": len(sig), "builds": builds()}
