"""Plan data model: candidates, fingerprints, and the tuned Plan.

PyTorch-port counterpart of ``stencil_tpu/tuning/plan.py``. The
reference routes every halo message over the fastest measured transport
for its src/dst pair (reference: src/stencil.cu:371-458); here, as in
JAX, ONE exchange configuration — (Method, overlap, exchange_every,
wire format, wire layout) — serves every pair. A :class:`Plan` is that
choice plus what is needed to trust and reuse it: the measured
alpha-beta coefficients, the per-candidate costs, a provenance tag
(tuned/cached/default) and a fingerprint of the machine and problem the
measurements are valid for.

Two runs share a plan iff their fingerprint inputs match: platform
(``"gpu"`` and the card's name for the port, so a JAX plan and a port
plan never share a key) and device count, mesh shape, slice count,
global grid, the 26-direction radius, quantity names and dtypes,
boundary, wire format and layout, and the library version.

``Plan.tiling`` records the tiles the port's own kernel planners choose
for the shard (``ops/cuda_stencil.jacobi_ring_plan``, ``laplace6_plan``
and the halo path's N-step grouping, ``ops/halo_plan.py``), priced at
the card's memory rate. JAX records its TPU VMEM block shapes there; no
TPU constant is carried over.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..geometry import Dim3, Radius, all_directions, normalize_depths

SCHEMA_VERSION = 1

#: temporal-blocking depths the tuner sweeps by default
DEFAULT_DEPTHS: Tuple[int, ...] = (1, 2, 4, 8)

#: the strategies a plan may select, in generation (tie-break) order
PLAN_METHODS: Tuple[str, ...] = ("PpermuteSlab", "PpermutePacked",
                                 "PallasDMA", "AllGather")

#: strategies supporting deep allocations, uneven shards and the
#: zero-Dirichlet exterior (as ``DistributedDomain.realize``)
_PPERMUTE = ("PpermuteSlab", "PpermutePacked")

#: the H100 SXM's memory rate and SM count: the bounds PERF.md prices
#: kernels with, and the card the kernel planners are sized for
CARD_HBM_BYTES_PER_S = 3.35e12
CARD_SMS = 132


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the configuration space the tuner sweeps (JAX
    ``tuning/plan.py:47-114``): the method, the temporal depth (or
    per-axis ``depths`` (x, y, z), keyed ``s=1.1.4``), overlap, and the
    wire format and layout of the slab and packed engines."""

    method: str
    exchange_every: int = 1
    overlap: bool = False
    wire_format: str = "f32"
    wire_layout: str = "slab"
    depths: Optional[Tuple[int, int, int]] = None

    def depths_xyz(self) -> Tuple[int, int, int]:
        """The effective (x, y, z) depths."""
        return (self.depths if self.depths is not None
                else (self.exchange_every,) * 3)

    def key(self) -> str:
        d = self.depths
        if d is not None and len(set(d)) > 1:
            tag = f"{self.method}[s={d[0]}.{d[1]}.{d[2]}"
        else:
            tag = f"{self.method}[s={self.exchange_every}"
        if self.overlap:
            tag += ",overlap"
        if self.wire_format != "f32":
            tag += f",wire={self.wire_format}"
        if self.wire_layout != "slab":
            tag += f",layout={self.wire_layout}"
        return tag + "]"

    @staticmethod
    def from_key(key: str) -> "Candidate":
        method, _, rest = key.partition("[")
        parts = rest.rstrip("]").split(",")
        sval = parts[0].split("=")[1]
        depths: Optional[Tuple[int, int, int]] = None
        if "." in sval:
            dx, dy, dz = (int(v) for v in sval.split("."))
            depths = (dx, dy, dz)
            s = max(depths)
        else:
            s = int(sval)
        wire, layout = "f32", "slab"
        for p in parts[1:]:
            if p.startswith("wire="):
                wire = p.split("=", 1)[1]
            elif p.startswith("layout="):
                layout = p.split("=", 1)[1]
        return Candidate(method, s, "overlap" in parts[1:], wire, layout,
                         depths)


@dataclasses.dataclass(frozen=True)
class TuneGeometry:
    """The per-shard geometry every cost and feasibility rule reads.
    ``shard_interior_zyx`` is the CAPACITY interior (the slabs on the
    wire); ``min_interior_zyx`` the smallest shard, which bounds the
    feasible depth as realize()'s check does."""

    shard_interior_zyx: Tuple[int, int, int]
    min_interior_zyx: Tuple[int, int, int]
    radius: Radius
    counts: Dim3
    elem_sizes: Tuple[int, ...]
    uneven: bool = False
    nonperiodic: bool = False
    #: per-quantity dtype names — the packed engine groups messages by
    #: dtype; empty means unknown (distinct element sizes then)
    dtype_strs: Tuple[str, ...] = ()

    @property
    def dtype_groups(self) -> "int | None":
        return len(set(self.dtype_strs)) if self.dtype_strs else None


def candidate_feasible(cand: Candidate, geom: TuneGeometry) -> bool:
    """realize()'s rules, applied up front so that the tuner never
    measures a configuration the domain would refuse (JAX
    ``tuning/plan.py:143-184``)."""
    if cand.method not in PLAN_METHODS:
        return False
    if cand.method not in _PPERMUTE:
        if cand.exchange_every > 1 or geom.uneven or geom.nonperiodic:
            return False
        if cand.overlap or cand.wire_format != "f32" \
                or cand.wire_layout != "slab":
            return False
    if cand.exchange_every < 1:
        return False
    depths = cand.depths_xyz()
    if any(d < 1 for d in depths) or max(depths) != cand.exchange_every:
        return False
    if len(set(depths)) > 1:
        if cand.method not in _PPERMUTE or cand.overlap:
            return False
        if cand.wire_layout != "slab":
            return False
        if any(max(depths) % d for d in depths):
            return False
    mz, my, mx = geom.min_interior_zyx
    min_xyz = (mx, my, mz)
    for a in range(3):
        need = depths[a] * max(geom.radius.face(a, -1),
                               geom.radius.face(a, 1))
        if need > min_xyz[a]:
            return False
    return True


def candidate_space(geom: TuneGeometry,
                    depths: Sequence = DEFAULT_DEPTHS,
                    overlap_options: Sequence[bool] = (False,),
                    runnable: Optional[Callable] = None,
                    wire_formats: Sequence[str] = ("f32",),
                    wire_layouts: Sequence[str] = ("slab",)
                    ) -> List[Candidate]:
    """Every feasible, runnable configuration in deterministic
    tie-break order: method priority x depth ascending x overlap off
    first x full-precision wire first (JAX ``tuning/plan.py:187-247``).
    ``runnable`` filters methods; its default, the port's
    ``method_runnable``, passes every transport (``PallasDMA`` runs as
    B4 on the card and as its plain twin on the CPU), where JAX's drops
    ``PallasDMA`` off a TPU. ``depths`` entries are ints (uniform) or
    per-axis specs (a ``{"z": 4}`` dict or an (x, y, z) tuple)."""
    from ..parallel.methods import Method, method_runnable

    if runnable is None:
        runnable = method_runnable
    uniform = set()
    asym = set()
    for d in depths:
        if isinstance(d, int):
            uniform.add(int(d))
        else:
            nd = normalize_depths(d)
            if nd.x == nd.y == nd.z:
                uniform.add(nd.x)
            else:
                asym.add((nd.x, nd.y, nd.z))
    out: List[Candidate] = []
    for name in PLAN_METHODS:
        if not runnable(Method[name]):
            continue
        specs = ([(s, None) for s in sorted(uniform)]
                 + [(max(d), d) for d in sorted(asym)])
        for s, dxyz in specs:
            for ovl in overlap_options:
                for wf in wire_formats:
                    for wl in wire_layouts:
                        cand = Candidate(name, s, bool(ovl), str(wf),
                                         str(wl), dxyz)
                        if candidate_feasible(cand, geom):
                            out.append(cand)
    return out


# ---------------------------------------------------------------------------
# the kernel tiling record


def tiling_record(geom: TuneGeometry, steps: int = 2,
                  n_sms: int = CARD_SMS) -> Dict[str, Dict]:
    """The ``Plan.tiling`` payload: the launch the port's planners
    choose for this shard on a card of ``n_sms`` SMs — the N-step
    Jacobi ring kernel (K2 and B6, ``jacobi_ring_plan`` at N =
    ``steps``), whether the halo path groups its steps into B6 launches
    (``ops/halo_plan.pair_halo_refusal``) and B8's ring
    (``laplace6_plan``) — each with the seconds a step of one read and
    one write of the shard takes at the card's memory rate. The kernels
    derive the same launch from the same planners, so the record is
    provenance. The kernels take float32 and bfloat16 only."""
    from ..ops.cuda_stencil import jacobi_ring_plan, laplace6_plan
    from ..ops.halo_plan import pair_halo_refusal

    z, y, x = geom.shard_interior_zyx
    isz = max(geom.elem_sizes) if geom.elem_sizes else 4
    if isz not in (2, 4):
        reason = (f"the CUDA kernels take float32 and bfloat16, not "
                  f"{isz}-byte elements")
        return {"jacobi_ring_kernel": {"infeasible": reason},
                "laplace6_ring_kernel": {"infeasible": reason}}
    step_s = 2.0 * z * y * x * isz / CARD_HBM_BYTES_PER_S
    ring = jacobi_ring_plan(z, y, x, steps, n_sms, isz)
    refusal = pair_halo_refusal(z, y, x, isz, steps)
    lap = laplace6_plan(z, y, x, n_sms)
    return {
        "jacobi_ring_kernel": {
            "steps": int(steps), "tile_y": ring.ty, "depth": ring.depth,
            "zrun": ring.zrun, "blocks_per_sm": ring.blocks_per_sm,
            "modeled_hbm_s_per_step": step_s / steps},
        "jacobi7_halon_grouping": {"steps": int(steps),
                                   "grouped": refusal is None,
                                   "refusal": refusal},
        "laplace6_ring_kernel": {
            "zrun": lap.zrun, "blocks_per_sm": lap.blocks_per_sm,
            "modeled_hbm_s_per_step": step_s},
        "card": {"sms": int(n_sms),
                 "hbm_bytes_per_s": CARD_HBM_BYTES_PER_S},
    }


# ---------------------------------------------------------------------------
# particle-migration candidates (the PIC workload's tuning axis)


@dataclasses.dataclass(frozen=True)
class MigrationCandidate:
    """One (per-shard capacity, per-direction budget) point of the
    migration space (JAX ``tuning/plan.py:343-358``)."""

    capacity: int
    budget: int

    def key(self) -> str:
        return f"migrate[cap={self.capacity},budget={self.budget}]"


def migration_candidate_space(particles_per_shard: int,
                              capacities: Optional[Sequence[int]] = None,
                              budgets: Optional[Sequence[int]] = None
                              ) -> List[MigrationCandidate]:
    """The (capacity, budget) grid: capacities 1.25x-4x the mean fill,
    budgets capacity/32 up to capacity (JAX ``tuning/plan.py:
    361-381``)."""
    n = max(int(particles_per_shard), 1)
    if capacities is None:
        capacities = sorted({max(8, int(n * f))
                             for f in (1.25, 1.5, 2.0, 4.0)})
    out: List[MigrationCandidate] = []
    for cap in capacities:
        if cap < n:
            continue
        bs = (budgets if budgets is not None
              else sorted({max(1, cap // d) for d in (32, 16, 8, 4, 2, 1)}))
        for b in bs:
            if 1 <= b <= cap:
                out.append(MigrationCandidate(int(cap), int(b)))
    return out


def migration_candidate_feasible(cand: MigrationCandidate,
                                 particles_per_shard: int,
                                 max_crossing_fraction: float,
                                 headroom: float = 1.5) -> bool:
    """Overflow safety: the budget holds the worst expected flux and the
    capacity the fill, both with ``headroom`` of slack (JAX
    ``tuning/plan.py:384-404``)."""
    n = max(int(particles_per_shard), 1)
    need_budget = int(n * float(max_crossing_fraction)
                      * float(headroom)) + 1
    if cand.budget < need_budget:
        return False
    if cand.capacity < int(n * float(headroom)):
        return False
    return True


def rank_migration_candidates(particles_per_shard: int, n_fields: int,
                              counts, elem_size: int,
                              max_crossing_fraction: float = 0.25,
                              coeffs=None,
                              candidates: Optional[
                                  Sequence[MigrationCandidate]] = None,
                              headroom: float = 1.5
                              ) -> List[Tuple[float, MigrationCandidate]]:
    """Feasible migration configurations by alpha-beta wire seconds per
    step, cheapest first, capacity breaking ties (JAX ``tuning/plan.py:
    407-440``). Raises when nothing is feasible."""
    from ..analysis.costmodel import migration_step_seconds

    cands = (list(candidates) if candidates is not None
             else migration_candidate_space(particles_per_shard))
    ranked: List[Tuple[float, MigrationCandidate]] = []
    for c in cands:
        if not migration_candidate_feasible(
                c, particles_per_shard, max_crossing_fraction, headroom):
            continue
        ranked.append((migration_step_seconds(
            n_fields, c.budget, counts, elem_size, coeffs), c))
    if not ranked:
        raise ValueError(
            f"no feasible migration candidate for "
            f"{particles_per_shard} particles/shard at crossing "
            f"fraction {max_crossing_fraction} (budgets too small "
            f"everywhere — raise capacity or lower the flux)")
    ranked.sort(key=lambda t: (t[0], t[1].capacity, t[1].budget))
    return ranked


# ---------------------------------------------------------------------------
# fingerprint


def radius_signature(radius: Radius) -> List[List[int]]:
    """Canonical 26-direction serialization (x, y, z, dir -> r rows)."""
    return [[d.x, d.y, d.z, radius.dir(d)] for d in all_directions()]


def fingerprint(inputs: Dict) -> str:
    """Stable hash of the fingerprint inputs (sorted-key JSON)."""
    blob = json.dumps(inputs, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def fingerprint_inputs(platform: str, device_count: int,
                       mesh_shape: Sequence[int],
                       grid: Sequence[int], radius: Radius,
                       quantities: Dict[str, str],
                       boundary: str, n_slices: int = 1,
                       library_version: Optional[str] = None,
                       wire_format: str = "f32",
                       wire_layout: str = "slab",
                       exchange_depths: Optional[Sequence[int]] = None,
                       placement: str = "auto",
                       device_kind: str = "") -> Dict:
    """The identity a plan is valid for (JAX ``tuning/plan.py:
    454-497``). ``quantities`` maps name -> dtype name. Non-uniform
    ``exchange_depths``, a ``placement`` other than "auto" and a
    ``device_kind`` (the card's name, ``torch.cuda.get_device_name``)
    join only when given, so the remaining identity is JAX's."""
    if library_version is None:
        from .. import __version__ as library_version
    out = {
        "platform": str(platform),
        "device_count": int(device_count),
        "mesh_shape": [int(v) for v in mesh_shape],
        "grid": [int(v) for v in grid],
        "radius": radius_signature(radius),
        "quantities": {str(k): str(v) for k, v in quantities.items()},
        "boundary": str(boundary),
        "n_slices": int(n_slices),
        "library_version": str(library_version),
        "wire_format": str(wire_format),
        "wire_layout": str(wire_layout),
    }
    if exchange_depths is not None and len(set(exchange_depths)) > 1:
        out["exchange_depths"] = [int(v) for v in exchange_depths]
    if str(placement) != "auto":
        out["placement"] = str(placement)
    if device_kind:
        out["device_kind"] = str(device_kind)
    return out


# ---------------------------------------------------------------------------
# the Plan


@dataclasses.dataclass
class Plan:
    """The autotuner's output: the winning configuration plus the
    evidence (coefficients, per-candidate costs) and provenance (JAX
    ``tuning/plan.py:499-554``; records load across the two
    packages)."""

    config: Candidate
    fingerprint: str
    #: link class -> {"alpha_s": ..., "beta_bytes_per_s": ...}
    coefficients: Dict[str, Dict[str, float]]
    #: candidate key -> {"predicted_s": ..., "measured_s": ...?}
    costs: Dict[str, Dict[str, float]]
    provenance: str = "tuned"        # tuned | cached | default
    measurements: int = 0            # timer invocations THIS process
    created: float = 0.0
    library_version: str = ""
    fingerprint_inputs: Optional[Dict] = None
    #: predict_exchange_every's calibrated depth-crossover estimate
    predicted_best_depth: Optional[int] = None
    #: kernel -> its launch plan at this shard (``tiling_record``)
    tiling: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    #: the placement mode the plan was tuned under
    placement: str = "auto"

    def to_record(self) -> Dict:
        rec = dataclasses.asdict(self)
        rec["schema"] = SCHEMA_VERSION
        return rec

    @staticmethod
    def from_record(rec: Dict) -> "Plan":
        cfg = rec["config"]
        depths = cfg.get("depths")
        return Plan(
            config=Candidate(str(cfg["method"]),
                             int(cfg["exchange_every"]),
                             bool(cfg.get("overlap", False)),
                             str(cfg.get("wire_format", "f32")),
                             str(cfg.get("wire_layout", "slab")),
                             tuple(int(v) for v in depths)
                             if depths is not None else None),
            fingerprint=str(rec["fingerprint"]),
            coefficients=dict(rec.get("coefficients", {})),
            costs=dict(rec.get("costs", {})),
            provenance=str(rec.get("provenance", "tuned")),
            measurements=int(rec.get("measurements", 0)),
            created=float(rec.get("created", 0.0)),
            library_version=str(rec.get("library_version", "")),
            fingerprint_inputs=rec.get("fingerprint_inputs"),
            predicted_best_depth=rec.get("predicted_best_depth"),
            tiling=dict(rec.get("tiling", {})),
            placement=str(rec.get("placement", "auto")),
        )
