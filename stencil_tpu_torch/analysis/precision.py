"""The precision certificate of a halo wire format.

PyTorch-port counterpart of the wire-format gate of
``stencil_tpu/analysis/precision.py`` (``certify_wire_format``,
``PrecisionCertificate``). JAX proves the gate's conditions on the
traced program (a jaxpr walk); the port has no program to trace, so
``make_exchange`` runs one probe exchange on shards of the "meta"
device (shapes and dtypes, no storage and no kernel, so the probe costs
no device memory) and the engine records every message it moves between
mesh positions (``parallel/exchange.WireProbe``). The certificate checks two of JAX's
conditions on that record:

* (b) every message crossed at exactly its axis's declared wire dtype;
* (c) every message was widened back to its storage dtype before it
  was written, so the wire format never reaches the carried state.

JAX's condition (a), the accumulation floor, needs the walk over the
compute and waits for the port's analysis checkers (ROADMAP A14):
``narrowest_accum`` is None and ``silent_converts`` empty.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

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


def certificate_of(records, mesh, wire_formats: Dict[str, str]
                   ) -> PrecisionCertificate:
    """The certificate of a probe's ``records`` (``WireProbe.records``)
    against the declared per-axis ``wire_formats`` on ``mesh`` (a
    ``parallel/mesh.Mesh``). ``link_class`` is "same-device" or
    "cross-device" by where the axis's messages go between ``mesh``'s
    devices ("mixed" for both)."""
    from ..parallel.exchange import wire_dtype
    from ..parallel.mesh import mesh_neighbor

    counts = mesh.shape
    wire_dtypes: Dict[str, Dict[str, Any]] = {}
    reasons: List[str] = []
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
        silent_converts=[], narrowest_accum=None,
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

    n = mesh.shape.flatten()
    fields = {q: [torch.empty(tuple(shape), dtype=torch_dtype(dt),
                              device="meta") for _ in range(n)]
              for q, (shape, dt) in dict(fields_spec).items()}
    probe = WireProbe()
    try:
        exchange(fields, probe=probe)
    except (NotImplementedError, ValueError) as e:
        return PrecisionCertificate(
            target="<wire-format-gate>", wire_dtypes={}, silent_converts=[],
            narrowest_accum=None, max_rel_error_bound=0.0, safe=False,
            reasons=[f"probe exchange failed: {type(e).__name__}: {e}"])
    return certificate_of(probe.records, mesh, wire_formats)


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
