"""Finding and report types of the port's analysis checkers.

PyTorch-port counterpart of ``stencil_tpu/analysis/report.py``, with the
same JSON schema: a checker emits :class:`Finding`s; a :class:`Report`
aggregates them across targets and serializes to the ``--json``
artifact. Severity ``error`` fails the run (nonzero exit); ``warning``
marks what a checker cannot prove without claiming a bug. The artifact
names ``torch_version`` and the ``device`` the checkers ran on where
JAX's names ``jax_version``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Sequence

# v2 as in JAX: tool_version, per-checker wall time (checker_seconds) and
# per-target metrics
SCHEMA_VERSION = 2

TOOL_VERSION = "0.2.0"

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated (or unprovable) invariant: ``checker`` (one of
    ``analysis.CHECKERS``), ``target`` (the registry name, or
    "name:kernel"), ``message``, ``severity`` (ERROR fails the run,
    WARNING is reported only)."""

    checker: str
    target: str
    message: str
    severity: str = ERROR

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"[{self.checker}] {self.target}: {self.message}"


def device_name() -> str:
    """The card the checkers ran on (``torch.cuda.get_device_name(0)``),
    or "cpu"."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


@dataclasses.dataclass
class Report:
    """All findings of one run plus run metadata."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    targets_checked: List[str] = dataclasses.field(default_factory=list)
    #: per-checker wall time (seconds), e.g. {"footprint": 1.2}
    checker_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    #: per-target metrics keyed "<checker>:<target>"
    metrics: Dict[str, Dict] = dataclasses.field(default_factory=dict)

    def extend(self, findings: Sequence[Finding]) -> None:
        self.findings.extend(findings)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    @property
    def ok(self) -> bool:
        """True when no error-severity finding exists."""
        return not self.errors

    def to_dict(self) -> Dict:
        import torch

        by_checker: Dict[str, int] = {}
        for f in self.errors:
            by_checker[f.checker] = by_checker.get(f.checker, 0) + 1
        return {
            "schema_version": SCHEMA_VERSION,
            "tool": "stencil-lint",
            "tool_version": TOOL_VERSION,
            "torch_version": torch.__version__,
            "device": device_name(),
            "targets_checked": list(self.targets_checked),
            "counts": {
                "targets": len(self.targets_checked),
                "errors": len(self.errors),
                "warnings": len(self.warnings),
                "errors_by_checker": by_checker,
            },
            "checker_seconds": {k: round(v, 3)
                                for k, v in self.checker_seconds.items()},
            "metrics": self.metrics,
            "findings": [f.to_dict() for f in self.findings],
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=str)
