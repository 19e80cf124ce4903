"""The precision certificate: the wire-format gate and checker 13.

PyTorch-port counterpart of ``stencil_tpu/analysis/precision.py``
(``certify_wire_format``, ``PrecisionCertificate``, ``check_precision``).
JAX proves its conditions on the traced program (a jaxpr walk); the port
has no program to trace, so ``make_exchange`` runs one probe exchange on
shards of the "meta" device (shapes and dtypes, no storage and no
kernel, so the probe costs no device memory), the engine records every
message it moves between mesh positions (``parallel/exchange.WireProbe``),
and ``probes.OpLog`` sees every aten op it runs. The certificate checks
JAX's three conditions:

* (a) every additive reduction (``probes.REDUCTIONS``: sums,
  scatter-adds, matrix products) accumulates at least at the declared
  compute dtype (its output dtype is the accumulator's:
  ``narrowest_accum``), and every narrowing conversion (``_to_copy``, a
  ``copy_`` across dtypes) is declared, by the wire format or the
  storage dtype, or else it is a silent convert (``silent_converts``),
  an error;
* (b) every message crossed at exactly its axis's declared wire dtype;
* (c) every message was widened back to its storage dtype before it
  was written, so the wire format never reaches the carried state.

The same walk runs over a whole step or segment (``PrecisionSpec``,
``check_precision``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class PrecisionGateError(RuntimeError):
    """A narrowing wire format failed certification at realize time."""


def dtype_name(dt: torch.dtype) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16", ...)."""
    return str(dt).replace("torch.", "")


def rel_error_bound(wire: torch.dtype) -> float:
    """Per-hop relative rounding bound of narrowing to ``wire``: round to
    nearest on a (nmant+1)-bit significand perturbs each element by at
    most ``2**-(nmant+1)``, half the dtype's epsilon (bf16 2**-8, e4m3
    2**-4, e5m2 2**-3)."""
    return float(torch.finfo(wire).eps) / 2.0


@dataclasses.dataclass
class PrecisionCertificate:
    """The wire verdict of one exchange, with JAX's fields: ``safe`` iff
    no condition is violated; ``reasons`` name every violation;
    ``max_rel_error_bound`` is the per-element, per-hop relative
    rounding bound of the narrowest wire dtype crossed (0.0 for an
    identity wire); ``wire_dtypes`` per axis: the dtypes that crossed,
    the link class and the declared format."""

    target: str
    wire_dtypes: Dict[str, Dict[str, Any]]
    silent_converts: List[Dict[str, Any]]
    narrowest_accum: Optional[str]
    max_rel_error_bound: float
    safe: bool
    reasons: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {"target": self.target,
                "wire_dtypes": {k: dict(v) for k, v in
                                sorted(self.wire_dtypes.items())},
                "silent_converts": list(self.silent_converts),
                "narrowest_accum": self.narrowest_accum,
                "max_rel_error_bound": self.max_rel_error_bound,
                "safe": self.safe, "reasons": list(self.reasons)}


def _mant(dt: torch.dtype) -> int:
    """Mantissa bits of a float dtype (the precision order)."""
    return {torch.float64: 52, torch.float32: 23, torch.float16: 10,
            torch.bfloat16: 7, torch.float8_e4m3fn: 3,
            torch.float8_e5m2: 2}.get(dt, 64)


def dtype_flow(ops, compute_min: torch.dtype = torch.float32,
               declared=()) -> Dict[str, Any]:
    """Condition (a) over ``probes.OpLog`` records: the narrowest
    accumulator of an additive reduction, the silent (undeclared)
    narrowing conversions, and the reasons they give. ``declared``:
    (from, to) dtype pairs a declaration names."""
    from .probes import REDUCTIONS

    narrowest = None
    silent: Dict[Tuple[str, str], int] = {}
    reasons: List[str] = []
    for r in ops:
        name = r.name.lstrip("_")
        if name in REDUCTIONS:
            for dt in r.out_dtypes:
                if dt.is_floating_point and (
                        narrowest is None or _mant(dt) < _mant(narrowest)):
                    narrowest = dt
        pair = None
        if r.name == "_to_copy" and r.in_dtypes and r.out_dtypes:
            pair = (r.in_dtypes[0], r.out_dtypes[0])
        elif r.name == "copy" and len(r.in_dtypes) >= 2:
            pair = (r.in_dtypes[1], r.in_dtypes[0])
        if pair and pair[0].is_floating_point and pair[1].is_floating_point \
                and _mant(pair[1]) < _mant(pair[0]) \
                and pair not in declared:
            key = (dtype_name(pair[0]), dtype_name(pair[1]))
            silent[key] = silent.get(key, 0) + 1
    if narrowest is not None and _mant(narrowest) < _mant(compute_min):
        reasons.append(
            f"(a) an additive reduction accumulates in "
            f"{dtype_name(narrowest)}, below the declared compute dtype "
            f"{dtype_name(compute_min)}")
    for (a, b), n in sorted(silent.items()):
        reasons.append(f"silent convert: {a} -> {b} ({n}x) is a lossy "
                       f"narrowing named by no wire or compute declaration")
    return {"narrowest_accum": None if narrowest is None
            else dtype_name(narrowest),
            "silent_converts": [{"from": a, "to": b, "count": n}
                                for (a, b), n in sorted(silent.items())],
            "reasons": reasons}


def declared_pairs(wire_formats: Optional[Dict[str, str]],
                   storage: Sequence[torch.dtype] = (torch.float32,),
                   extra=()) -> set:
    """The narrowings a declaration names: each storage dtype to its
    axes' wire dtypes, and ``extra`` pairs (a compute -> storage
    narrowing)."""
    from ..parallel.exchange import wire_dtype

    out = set(extra)
    for fmt in (wire_formats or {}).values():
        for st in storage:
            out.add((st, wire_dtype(st, fmt)))
    return out


def certificate_of(records, mesh, wire_formats: Dict[str, str],
                   ops=(), compute_min: torch.dtype = torch.float32,
                   declared=()) -> PrecisionCertificate:
    """The certificate of a probe's ``records`` (``WireProbe.records``)
    against the declared per-axis ``wire_formats`` on ``mesh`` (a
    ``parallel/mesh.Mesh``). ``link_class`` is "same-device" or
    "cross-device" by where the axis's messages go between ``mesh``'s
    devices ("mixed" for both)."""
    from ..parallel.exchange import wire_dtype
    from ..parallel.mesh import mesh_neighbor

    counts = mesh.shape
    wire_dtypes: Dict[str, Dict[str, Any]] = {}
    flow = dtype_flow(ops, compute_min, declared)
    reasons: List[str] = list(flow["reasons"])
    for axis, wire, storage, written in records:
        declared = wire_formats.get(axis, "f32")
        rec = wire_dtypes.setdefault(
            axis, {"dtypes": [], "link_class": "", "declared": declared})
        if dtype_name(wire) not in rec["dtypes"]:
            rec["dtypes"].append(dtype_name(wire))
        expected = wire_dtype(storage, declared)
        if wire != expected:
            reasons.append(
                f"(b) wire dtype mismatch on axis {axis}: a message "
                f"crossed as {dtype_name(wire)} but the declared wire "
                f"format {declared!r} for {dtype_name(storage)} storage "
                f"expects {dtype_name(expected)}")
        if written != storage:
            reasons.append(
                f"(c) wire dtype leaked into the carried state on axis "
                f"{axis}: a {dtype_name(written)} message was written "
                f"into {dtype_name(storage)} storage (the wire format "
                f"must stay on the wire)")
    for axis, rec in wire_dtypes.items():
        a = "xyz".index(axis)
        kinds = {"same-device" if mesh.devices[i] == mesh.devices[
                     mesh_neighbor(i, counts, a, 1)] else "cross-device"
                 for i in range(counts.flatten())}
        rec["link_class"] = kinds.pop() if len(kinds) == 1 else "mixed"
    bound = 0.0
    for a, axis in enumerate(("x", "y", "z")):
        fmt = wire_formats.get(axis, "f32")
        if fmt != "f32" and counts[a] > 1:
            bound = max(bound, rel_error_bound(
                wire_dtype(torch.float32, fmt)))
    return PrecisionCertificate(
        target="<wire-format-gate>", wire_dtypes=wire_dtypes,
        silent_converts=flow["silent_converts"],
        narrowest_accum=flow["narrowest_accum"],
        max_rel_error_bound=bound, safe=not reasons,
        reasons=sorted(set(reasons)))


def certify_wire_probe(exchange: Callable, fields_spec, mesh,
                       wire_formats: Dict[str, str]) -> PrecisionCertificate:
    """Run ``exchange(fields, probe=...)`` once on shards of
    ``fields_spec`` (``{name: (padded shard shape (z, y, x), dtype)}``)
    on the "meta" device, one a mesh position of ``mesh``, and certify
    what it moved. Raises nothing for an exchange that refuses the
    configuration: the certificate is then unsafe and says why, so the
    caller refuses instead of crashing."""
    from ..distributed import torch_dtype
    from ..parallel.exchange import WireProbe
    from .probes import OpLog

    n = mesh.shape.flatten()
    fields = {q: [torch.empty(tuple(shape), dtype=torch_dtype(dt),
                              device="meta") for _ in range(n)]
              for q, (shape, dt) in dict(fields_spec).items()}
    probe = WireProbe()
    try:
        with OpLog() as log:
            exchange(fields, probe=probe)
    except (NotImplementedError, ValueError) as e:
        return PrecisionCertificate(
            target="<wire-format-gate>", wire_dtypes={}, silent_converts=[],
            narrowest_accum=None, max_rel_error_bound=0.0, safe=False,
            reasons=[f"probe exchange failed: {type(e).__name__}: {e}"])
    storage = sorted({t.dtype for v in fields.values() for t in v},
                     key=str)
    return certificate_of(probe.records, mesh, wire_formats, log.ops,
                          declared=declared_pairs(wire_formats, storage))


def wire_edge_values(n: int = 4096, seed: int = 61) -> np.ndarray:
    """float32 values that probe a wire format's edges: zeros of both
    signs, subnormals, float8_e4m3fn's rounding edge ((448, 464], just
    above 464, 464 itself), float8_e5m2's (57344, 61440), +-inf, NaN of
    both signs, and ``n`` seeded values of random sign over magnitudes
    from 1e-45 to 1e7 (the inputs on which the tests hold the port's
    narrowing against JAX's and ``chip_smoke.py`` the card's against
    the CPU's)."""
    special = np.array([0.0, 1e-45, 1e-40, 2.0 ** -126, 2.0 ** -149,
                        2.0 ** -10, 2.0 ** -17, 3e-3, 1.0, 448.0, 449.0,
                        456.0, 463.99997, 464.0, 464.00003, 465.0, 480.0,
                        1000.0, 57344.0, 57345.0, 61439.0, 61440.0,
                        61441.0, 1e6, np.inf, np.nan], np.float32)
    rng = np.random.default_rng(seed)
    mags = (10.0 ** rng.uniform(-45, 7, n)).astype(np.float32)
    signs = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    return np.concatenate([special, -special, mags * signs])


# ---------------------------------------------------------------------------
# checker 13: the dtype flow of a whole run
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PrecisionSpec:
    """A run to certify: ``run()`` once in one process on CPU shards of
    ``mesh``; ``wire`` the declared per-axis wire formats; ``compute_min``
    the accumulation floor; ``storage`` the storage dtypes; ``extra``
    further declared narrowings (a compute -> storage split)."""
    run: Callable[[], Any]
    mesh: Any
    wire: Optional[Dict[str, str]] = None
    compute_min: torch.dtype = torch.float32
    storage: Tuple[torch.dtype, ...] = (torch.float32,)
    extra: Tuple = ()


@dataclasses.dataclass
class PrecisionTarget:
    name: str
    build: Callable[[], PrecisionSpec]

    checker = "precision"


def check_precision(target: PrecisionTarget):
    """Certify the target's run; findings are the violated conditions
    and silent converts, metrics the certificate."""
    from ..parallel.exchange import WireProbe, normalize_wire_format, \
        recording
    from .probes import OpLog
    from .report import ERROR, Finding

    try:
        spec = target.build()
    except Exception as e:  # noqa: BLE001
        return [Finding("precision", target.name,
                        f"target build failed: {type(e).__name__}: {e}")]
    probe = WireProbe()
    wf = normalize_wire_format(spec.wire)
    with torch.no_grad(), recording(probe), OpLog() as log:
        spec.run()
    cert = certificate_of(probe.records, spec.mesh, wf, log.ops,
                          spec.compute_min,
                          declared_pairs(wf, spec.storage, spec.extra))
    cert.target = target.name
    findings = [Finding("precision", target.name, r, ERROR)
                for r in cert.reasons]
    if not log.ops:
        findings.append(Finding("precision", target.name,
                                "no op seen: nothing certified"))
    return findings, cert.to_dict()
