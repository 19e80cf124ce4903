"""Link observatory: per-link traffic attribution, a measured topology
fingerprint, and placement-quality scoring.

PyTorch-port counterpart of ``stencil_tpu/observatory/linkmap.py``
(reference: include/stencil/partition.hpp:525-831, qap.hpp,
src/gpu_topology.cpp — a measured distance matrix feeds the QAP that
puts the largest halo messages on the fastest links). Four pieces:

* **Modeled traffic matrix** — :class:`TrafficMatrix`: per-(src, dst)
  shard wire bytes of one exchange round, from the byte model the cost
  model and the runtime counters share
  (``parallel/exchange.exchanged_bytes_per_sweep`` split per direction,
  the migration ring's record buffers, the all-gather's per-shard
  contribution), with face/edge/corner shares.
* **Link classification** — :func:`classify`: every edge maps to
  ``self``, ``ici-hop<k>`` (hops over the shard lattice; a GPU host has
  no torus coordinates, so every coordless device takes the lattice's
  wrapped-torus hops) or ``dcn`` when it crosses a host boundary, and
  the bytes aggregate per mesh axis.
* **Measured topology fingerprint** — :func:`measure_topology`: per-axis
  ring-shift sweeps through the tuner's timer protocol
  (``pingpong_axis``), fitted to per-link alpha-beta coefficients and
  saved fingerprint-keyed (atomic publish, the plan cache's lock), which
  the tuner reads instead of its two global fits.
* **Placement quality** — :func:`placement_report`: the QAP-placement
  and deployed-placement costs against trivial placement on every
  registered mesh.

:func:`link_attribution_for` derives a realized domain's per-(axis,
link class) bytes a step and per-axis fitted peaks, which
``attribution.PerfAttributor`` exports as
``stencil_link_bytes_per_step`` and ``stencil_link_utilization_ratio``.

The JAX module's HLO checker (``LinkmapSpec``, ``LinkmapTarget``,
``check_linkmap``) waits for the analysis checkers (ROADMAP A14).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..geometry import Dim3, Radius, all_directions, normalize_depths

#: modeled wire B/step per mesh axis and link class
METRIC_LINK_BYTES_PER_STEP = "stencil_link_bytes_per_step"
#: achieved-vs-fitted-peak utilization per mesh axis and link class
METRIC_LINK_UTILIZATION = "stencil_link_utilization_ratio"

AXIS_NAMES = ("x", "y", "z")

#: direction classes of the face/edge/corner byte decomposition
DIRECTION_CLASSES = ("face", "edge", "corner")


def _axis_index(axis: Union[int, str]) -> int:
    if isinstance(axis, str):
        return AXIS_NAMES.index(axis)
    return int(axis)


def _linearize(ix: int, iy: int, iz: int, counts: Dim3) -> int:
    """x-fastest shard linear index (``RankPartition.linearize``)."""
    return ix + counts.x * (iy + counts.y * iz)


def _shard_index(i: int, counts: Dim3) -> Tuple[int, int, int]:
    return (i % counts.x, (i // counts.x) % counts.y,
            i // (counts.x * counts.y))


class TrafficEdge:
    """One planned message: ``src`` shard -> ``dst`` shard along
    ``axis`` toward ``side``, ``nbytes`` split into face/edge/corner
    shares (``class_bytes`` sums to ``nbytes``)."""

    __slots__ = ("src", "dst", "axis", "side", "nbytes", "class_bytes")

    def __init__(self, src: int, dst: int, axis: str, side: int,
                 nbytes: int, class_bytes: Dict[str, int]) -> None:
        self.src = int(src)
        self.dst = int(dst)
        self.axis = str(axis)
        self.side = int(side)
        self.nbytes = int(nbytes)
        self.class_bytes = dict(class_bytes)


class TrafficMatrix:
    """Per-(src, dst) shard wire bytes of one exchange round: the edge
    list keeps axis, side and direction class; ``matrix()`` is the
    QAP's ``w``. Byte counts are exact integers."""

    def __init__(self, counts: Dim3,
                 edges: Optional[List[TrafficEdge]] = None) -> None:
        self.counts = Dim3.of(counts)
        self.n = self.counts.flatten()
        self.edges: List[TrafficEdge] = list(edges or [])

    def add(self, edge: TrafficEdge) -> None:
        self.edges.append(edge)

    def merge(self, other: "TrafficMatrix") -> "TrafficMatrix":
        """Two rounds over the same shard lattice (e.g. the PIC step's
        accumulate, exchange and migration)."""
        assert self.counts == other.counts, (self.counts, other.counts)
        return TrafficMatrix(self.counts, self.edges + other.edges)

    def matrix(self) -> np.ndarray:
        w = np.zeros((self.n, self.n), dtype=np.int64)
        for e in self.edges:
            w[e.src, e.dst] += e.nbytes
        return w

    def per_shard_bytes(self) -> List[int]:
        """Row sums: the bytes each shard sends a round."""
        out = [0] * self.n
        for e in self.edges:
            out[e.src] += e.nbytes
        return out

    def uniform_per_shard(self) -> Optional[int]:
        """The common row sum when every shard sends the same bytes,
        else None."""
        rows = self.per_shard_bytes()
        return rows[0] if len(set(rows)) == 1 else None

    def total(self) -> int:
        return sum(e.nbytes for e in self.edges)

    def axis_bytes(self) -> Dict[str, int]:
        out = {a: 0 for a in AXIS_NAMES}
        for e in self.edges:
            out[e.axis] = out.get(e.axis, 0) + e.nbytes
        return out

    def direction_class_bytes(self) -> Dict[str, int]:
        """Face/edge/corner byte shares; for the sweep engines the
        edge and corner shares are the pad rows the axis slabs carry."""
        out = {k: 0 for k in DIRECTION_CLASSES}
        for e in self.edges:
            for k, v in e.class_bytes.items():
                out[k] = out.get(k, 0) + v
        return out


def _neighbor(ix: int, iy: int, iz: int, axis: int, side: int,
              counts: Dim3) -> Tuple[int, int, int]:
    idx = [ix, iy, iz]
    idx[axis] = (idx[axis] + side) % counts[axis]
    return idx[0], idx[1], idx[2]


def _cross_section_classes(axis: int, padded_zyx: Sequence[int],
                           lo: Dim3, hi: Dim3,
                           pads_included: bool) -> Dict[str, int]:
    """An axis message's cross-section (the two OTHER padded dims) as
    interior x interior (face), interior x pad (edge) and pad x pad
    (corner) element counts, summing to the product."""
    dims = []
    for a in range(3):
        if a == axis:
            continue
        full = int(padded_zyx[2 - a])
        pad = (lo[a] + hi[a]) if pads_included else 0
        dims.append((full - pad, pad))
    (i1, p1), (i2, p2) = dims
    return {"face": i1 * i2, "edge": i1 * p2 + p1 * i2,
            "corner": p1 * p2}


def _ring_edges(tm: TrafficMatrix, counts: Dim3, a: int, side: int,
                nbytes: int, class_bytes: Dict[str, int],
                reverse: bool = False) -> None:
    """One message from every shard to its ``side`` neighbour along
    axis ``a`` (``reverse``: the opposite flow)."""
    for iz in range(counts.z):
        for iy in range(counts.y):
            for ix in range(counts.x):
                src = _linearize(ix, iy, iz, counts)
                dst = _linearize(*_neighbor(ix, iy, iz, a, side, counts),
                                 counts)
                if reverse:
                    src, dst = dst, src
                tm.add(TrafficEdge(src, dst, AXIS_NAMES[a], side, nbytes,
                                   class_bytes))


def sweep_traffic(shard_padded_zyx: Sequence[int], radius: Radius,
                  counts: Dim3, elem_sizes: Sequence[int],
                  pads_included: bool = True,
                  reverse: bool = False,
                  layout: str = "slab",
                  alloc_radius: Optional[Radius] = None
                  ) -> TrafficMatrix:
    """The sweep engines' matrix (PpermuteSlab, PpermutePacked,
    PallasDMA — packing changes messages, not bytes; JAX
    ``observatory/linkmap.py:216-297``): per active axis one message a
    direction a quantity, rows x padded cross-section x element size,
    summing to ``exchanged_bytes_per_sweep``. The message toward ``+a``
    fills the neighbour's low halo (``radius.face(a, -1)`` rows).
    ``reverse``: the halo-accumulate adjoint (the PIC deposit).
    ``pads_included=False``: un-padded slabs (the all-gather's
    contribution). ``layout="irredundant"``: the each-cell-once layout
    (``parallel/packing.py``), ``alloc_radius`` locating the interior
    inside deeper pads."""
    from ..parallel.packing import normalize_wire_layout

    counts = Dim3.of(counts)
    tm = TrafficMatrix(counts)
    lo, hi = radius.pad_lo(), radius.pad_hi()
    irredundant = normalize_wire_layout(layout) == "irredundant"
    if irredundant and not pads_included:
        raise ValueError("layout='irredundant' prices padded sweep "
                         "messages (pads_included=True)")
    ar = alloc_radius if alloc_radius is not None else radius
    alo, ahi = ar.pad_lo(), ar.pad_hi()
    interiors = [int(shard_padded_zyx[2 - a]) - alo[a] - ahi[a]
                 for a in range(3)]
    for a in range(3):
        if counts[a] <= 1:
            continue  # a wrap on one shard: no wire traffic
        if irredundant:
            # axes swept before a carry their halo extension
            dims = [(interiors[j], (lo[j] + hi[j]) if j < a else 0)
                    for j in range(3) if j != a]
            (i1, e1), (i2, e2) = dims
            other = (i1 + e1) * (i2 + e2)
            classes = {"face": i1 * i2, "edge": i1 * e2 + e1 * i2,
                       "corner": e1 * e2}
        else:
            other = 1
            for d in range(3):
                if d != 2 - a:
                    other *= int(shard_padded_zyx[d])
            classes = _cross_section_classes(a, shard_padded_zyx, lo, hi,
                                             pads_included)
        for side in (1, -1):
            rows = radius.face(a, -side)
            if rows == 0:
                continue
            for es in elem_sizes:
                _ring_edges(tm, counts, a, side, rows * other * int(es),
                            {k: rows * v * int(es)
                             for k, v in classes.items()}, reverse)
    return tm


def allgather_traffic(shard_zyx: Sequence[int], radius: Radius,
                      counts: Dim3,
                      elem_sizes: Sequence[int]) -> TrafficMatrix:
    """The all-gather engine's matrix: each shard's per-direction slab
    contribution counted once (the ring moves ``(n-1)x`` that, which the
    cost model prices), sent to the ring successor."""
    return sweep_traffic(shard_zyx, radius, counts, elem_sizes,
                         pads_included=False)


def migration_traffic(counts: Dim3, n_fields: int, budget: int,
                      elem_size: int) -> TrafficMatrix:
    """The particle-migration ring's matrix: 2 fixed record buffers per
    active axis a shard (``record_rows x budget``), as
    ``analysis/costmodel.migration_wire_bytes_per_shard`` a row."""
    from ..parallel.migrate import migration_record_rows

    counts = Dim3.of(counts)
    tm = TrafficMatrix(counts)
    nbytes = (migration_record_rows(int(n_fields)) * int(budget)
              * int(elem_size))
    for a in range(3):
        if counts[a] <= 1:
            continue
        for side in (1, -1):
            _ring_edges(tm, counts, a, side, nbytes, {"face": nbytes})
    return tm


def _padded(shard_interior_zyx: Sequence[int], r: Radius):
    lo, hi = r.pad_lo(), r.pad_hi()
    z, y, x = shard_interior_zyx
    return (z + lo.z + hi.z, y + lo.y + hi.y, x + lo.x + hi.x)


def method_traffic(method_name: str,
                   shard_interior_zyx: Sequence[int], radius: Radius,
                   counts: Dim3, elem_sizes: Sequence[int],
                   steps=1,
                   wire_layout: str = "slab") -> TrafficMatrix:
    """The per-method matrix of one DEEP exchange round (the linkmap
    twin of ``analysis/costmodel.exchange_round_model``; JAX
    ``observatory/linkmap.py:342-384``). Per-axis ``steps`` make the
    matrix one GROUP of ``max(steps)`` sub-steps: axis ``a``'s edges
    scale by ``s / s_a``."""
    depths = normalize_depths(steps)
    s = max(depths)
    deep = radius.deepened(depths)
    if method_name == "AllGather":
        tm = allgather_traffic(shard_interior_zyx, deep, counts,
                               elem_sizes)
    else:
        tm = sweep_traffic(_padded(shard_interior_zyx, deep), deep, counts,
                           elem_sizes, layout=wire_layout)
    if depths.x == depths.y == depths.z:
        return tm
    out = TrafficMatrix(counts)
    for e in tm.edges:
        mult = s // depths[AXIS_NAMES.index(e.axis)]
        out.add(TrafficEdge(e.src, e.dst, e.axis, e.side, e.nbytes * mult,
                            {k: v * mult for k, v in e.class_bytes.items()}))
    return out


def pic_traffic(shard_interior_zyx: Sequence[int], radius: Radius,
                counts: Dim3, elem_size: int, n_fields: int,
                budget: int) -> TrafficMatrix:
    """The PIC step's whole wire bill: the reverse halo-accumulate, the
    forward exchange and the migration ring."""
    padded = _padded(shard_interior_zyx, radius)
    acc = sweep_traffic(padded, radius, counts, (elem_size,),
                        reverse=True)
    fwd = sweep_traffic(padded, radius, counts, (elem_size,))
    mig = migration_traffic(counts, n_fields, budget, elem_size)
    return acc.merge(fwd).merge(mig)


# ---------------------------------------------------------------------------
# link classification: matrix edges -> self / ici-hop<k> / dcn


def _lattice_torus_hops(counts: Dim3) -> np.ndarray:
    """Wrapped-torus hop distance over the shard lattice itself: per
    axis ``min(|d|, n - |d|)``, summed."""
    counts = Dim3.of(counts)
    n = counts.flatten()
    idx = np.arange(n)
    coords = np.stack([idx % counts.x,
                       (idx // counts.x) % counts.y,
                       idx // (counts.x * counts.y)], axis=1)
    dist = np.zeros((n, n), dtype=np.float64)
    for a in range(3):
        d = np.abs(coords[:, None, a] - coords[None, :, a])
        dist += np.minimum(d, counts[a] - d)
    return dist


def shard_slice(i: int, counts: Dim3, dcn_axis: int,
                n_slices: int) -> int:
    """Which host group holds shard ``i``: subdomains block onto the
    groups along the DCN axis (``multihost_device_order``)."""
    counts = Dim3.of(counts)
    coord = _shard_index(i, counts)[_axis_index(dcn_axis)]
    return coord * int(n_slices) // counts[_axis_index(dcn_axis)]


def mesh_distance_matrix(counts: Dim3,
                         devices: Optional[Sequence] = None,
                         dcn_axis: Optional[int] = None,
                         n_slices: int = 1,
                         dcn_hop_penalty: float = 8.0) -> np.ndarray:
    """Device-slot distances for the shard lattice: the devices'
    ``placement.torus_distance_matrix`` when every one has torus
    coordinates, else wrapped-torus hops over the lattice; pairs on
    different hosts (the DCN tier) add ``dcn_hop_penalty`` hops."""
    from ..placement import torus_distance_matrix

    counts = Dim3.of(counts)
    devs = list(devices or ())
    have_coords = bool(devs) and all(
        getattr(d, "coords", None) is not None
        and len(getattr(d, "coords", ())) >= 3 for d in devs)
    dist = (torus_distance_matrix(devs) if have_coords
            else _lattice_torus_hops(counts))
    if dcn_axis is not None and int(n_slices) > 1:
        slices = np.array([shard_slice(i, counts, dcn_axis, n_slices)
                           for i in range(counts.flatten())])
        dist = dist + float(dcn_hop_penalty) * (slices[:, None]
                                                != slices[None, :])
    return dist


def link_class_of(src: int, dst: int, dist: np.ndarray,
                  counts: Dim3, dcn_axis: Optional[int] = None,
                  n_slices: int = 1) -> str:
    """``self`` (no wire), ``dcn`` when the edge crosses a host
    boundary, else ``ici-hop<k>`` from the hop count."""
    if src == dst:
        return "self"
    if dcn_axis is not None and int(n_slices) > 1:
        if shard_slice(src, counts, dcn_axis, n_slices) \
                != shard_slice(dst, counts, dcn_axis, n_slices):
            return "dcn"
    hops = max(int(round(float(dist[src, dst]))), 1)
    return f"ici-hop{hops}"


@dataclasses.dataclass
class LinkmapSummary:
    """The classified matrix: per-(axis, link class) bytes a round and
    the face/edge/corner shares."""

    counts: Tuple[int, int, int]
    total_bytes: int
    #: (axis, link_class) -> wire bytes per round, all shards
    link_bytes: Dict[Tuple[str, str], int]
    direction_class_bytes: Dict[str, int]
    rounds_per_step: float = 1.0

    def link_bytes_per_step(self) -> Dict[Tuple[str, str], float]:
        return {k: v * self.rounds_per_step
                for k, v in self.link_bytes.items()}

    def to_record(self) -> Dict:
        total = max(self.total_bytes, 1)
        return {
            "counts": list(self.counts),
            "total_bytes": self.total_bytes,
            "rounds_per_step": self.rounds_per_step,
            "links": {f"{a}/{c}": {"bytes": b, "share": b / total}
                      for (a, c), b in sorted(self.link_bytes.items())},
            "direction_classes": {
                k: {"bytes": v, "share": v / total}
                for k, v in self.direction_class_bytes.items()},
        }


def classify(tm: TrafficMatrix, devices: Optional[Sequence] = None,
             dcn_axis: Optional[Union[int, str]] = None,
             n_slices: int = 1,
             rounds_per_step: float = 1.0) -> LinkmapSummary:
    """Every edge's link class, the bytes aggregated per mesh axis."""
    axis = None if dcn_axis is None else _axis_index(dcn_axis)
    dist = mesh_distance_matrix(tm.counts, devices=devices,
                                dcn_axis=axis, n_slices=n_slices)
    link_bytes: Dict[Tuple[str, str], int] = {}
    for e in tm.edges:
        klass = link_class_of(e.src, e.dst, dist, tm.counts,
                              dcn_axis=axis, n_slices=n_slices)
        key = (e.axis, klass)
        link_bytes[key] = link_bytes.get(key, 0) + e.nbytes
    return LinkmapSummary(counts=tuple(tm.counts), total_bytes=tm.total(),
                          link_bytes=link_bytes,
                          direction_class_bytes=tm.direction_class_bytes(),
                          rounds_per_step=float(rounds_per_step))


def link_attribution_for(dd) -> Optional[Dict]:
    """Live attribution inputs of a realized ``DistributedDomain``:
    ``{"bytes_per_step": {(axis, class): B}, "peak_bytes_per_s": {axis:
    B/s}, "summary": record}`` — the modeled wire bytes a step per
    (axis, link class) and each axis's fitted peak (the tuned plan's
    coefficients when present, else the default intra-host link). None
    on an unsharded mesh or an unpriceable geometry; never raises."""
    try:
        from ..analysis.costmodel import DEFAULT_ICI_COEFFS
        from ..parallel.methods import pick_method

        counts = dd.mesh_counts
        if counts.flatten() <= 1:
            return None
        local = dd.local_size
        elem_sizes = tuple(dd._dtypes[q].itemsize for q in dd._names)
        s = max(int(dd.exchange_every), 1)
        depths = getattr(dd, "exchange_depths", None)
        tm = method_traffic(pick_method(dd.methods).name,
                            (local.z, local.y, local.x), dd.radius,
                            counts, elem_sizes,
                            steps=depths if depths is not None else s,
                            wire_layout=getattr(dd, "wire_layout", "slab"))
        if not tm.edges:
            return None
        devices = None
        if getattr(dd, "placement", None) is not None:
            devices = [g.device for g in dd.placement.slot_order_for_mesh()]
        summary = classify(tm, devices=devices, dcn_axis=dd.dcn_axis,
                           n_slices=int(getattr(dd, "n_slices", 1)),
                           rounds_per_step=1.0 / s)
        peaks: Dict[str, float] = {}
        coeffs = getattr(getattr(dd, "plan", None), "coefficients",
                         None) or {}
        for a in range(3):
            if counts[a] <= 1:
                continue
            name = AXIS_NAMES[a]
            rec = coeffs.get(name)
            if rec is None and dd.dcn_axis == a and "dcn" in coeffs:
                rec = coeffs["dcn"]
            if rec is None:
                rec = coeffs.get("ici")
            peaks[name] = (float(rec["beta_bytes_per_s"]) if rec
                           else DEFAULT_ICI_COEFFS.beta_bytes_per_s)
        return {"bytes_per_step": summary.link_bytes_per_step(),
                "peak_bytes_per_s": peaks,
                "summary": summary.to_record()}
    except Exception:  # noqa: BLE001 - no linkmap -> attribution off
        return None


# ---------------------------------------------------------------------------
# the measured topology fingerprint (per-axis ring-shift sweeps)

#: bump when a record key changes meaning; the loader keys on this
TOPOLOGY_SCHEMA_VERSION = 1

ENV_TOPOLOGY_CACHE = "STENCIL_TOPOLOGY_CACHE"


def default_topology_path() -> Path:
    env = os.environ.get(ENV_TOPOLOGY_CACHE, "")
    if env:
        return Path(env)
    return Path(os.path.expanduser(
        "~/.cache/stencil_tpu_torch/topology.json"))


def topology_fingerprint_inputs(platform: str, device_count: int,
                                mesh_shape: Sequence[int],
                                n_slices: int = 1) -> Dict:
    """The identity a topology fingerprint is valid for: the fabric,
    not the problem, so every campaign on one machine shares one
    measurement."""
    return {
        "platform": str(platform),
        "device_count": int(device_count),
        "mesh_shape": [int(v) for v in mesh_shape],
        "n_slices": int(n_slices),
    }


def topology_fingerprint(inputs: Dict) -> str:
    from ..tuning.plan import fingerprint

    return fingerprint({"topology": inputs})


def measure_topology(timer, mesh_shape: Sequence[int],
                     inputs: Dict,
                     dcn_axis: Optional[int] = None,
                     sizes: Optional[Sequence[int]] = None,
                     created: Optional[float] = None) -> Dict:
    """One topology fingerprint record: per active mesh axis a
    ring-shift sweep (``timer.pingpong_axis``) at the calibration sizes,
    least-squares fitted (``tuning/fit.fit_alpha_beta``), plus a ``dcn``
    link on a host-blocked axis. The raw samples ride the record."""
    from ..tuning.fit import DEFAULT_CALIBRATION_BYTES, fit_alpha_beta

    sizes = tuple(sizes or DEFAULT_CALIBRATION_BYTES)
    links: Dict[str, Dict] = {}
    for a, n in enumerate(mesh_shape):
        if int(n) <= 1:
            continue
        name = AXIS_NAMES[a]
        samples = [(int(b), float(timer.pingpong_axis(name, int(b))))
                   for b in sizes]
        fit = fit_alpha_beta(samples)
        links[name] = {"alpha_s": fit.alpha_s,
                       "beta_bytes_per_s": fit.beta_bytes_per_s,
                       "samples": [[b, t] for b, t in samples]}
    if dcn_axis is not None and AXIS_NAMES[int(dcn_axis)] in links:
        links["dcn"] = dict(links[AXIS_NAMES[int(dcn_axis)]])
    return {
        "schema": TOPOLOGY_SCHEMA_VERSION,
        "kind": "topology_fingerprint",
        "fingerprint": topology_fingerprint(inputs),
        "inputs": dict(inputs),
        "created": float(created if created is not None else time.time()),
        "dcn_axis": (AXIS_NAMES[int(dcn_axis)]
                     if dcn_axis is not None else None),
        "links": links,
    }


def validate_topology(rec) -> List[str]:
    problems: List[str] = []
    if not isinstance(rec, dict):
        return ["topology record is not an object"]
    if rec.get("schema") != TOPOLOGY_SCHEMA_VERSION:
        problems.append(f"schema {rec.get('schema')!r} != "
                        f"{TOPOLOGY_SCHEMA_VERSION}")
    if rec.get("kind") != "topology_fingerprint":
        problems.append(f"kind {rec.get('kind')!r} != "
                        f"'topology_fingerprint'")
    if not isinstance(rec.get("fingerprint"), str) \
            or not rec.get("fingerprint"):
        problems.append("missing/invalid 'fingerprint'")
    links = rec.get("links")
    if not isinstance(links, dict) or not links:
        problems.append("missing/empty 'links'")
        return problems
    for name, c in links.items():
        for key in ("alpha_s", "beta_bytes_per_s"):
            v = (c or {}).get(key)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v <= 0:
                problems.append(f"link {name!r}: invalid {key}={v!r}")
    return problems


def save_topology(rec: Dict,
                  path: Union[str, Path, None] = None) -> Path:
    """Publish one fingerprint record into the topology file (a
    fingerprint-keyed table), read-merge-write under the plan cache's
    writer lock and published atomically."""
    from ..tuning.cache import _write_lock, publish_json

    problems = validate_topology(rec)
    if problems:
        raise ValueError(f"refusing to save invalid topology "
                         f"fingerprint: {problems}")
    p = Path(path) if path is not None else default_topology_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    with _write_lock(p):
        table: Dict[str, Dict] = {}
        if p.exists():
            try:
                data = json.loads(p.read_text())
                if isinstance(data, dict) \
                        and data.get("schema") == TOPOLOGY_SCHEMA_VERSION:
                    table = dict(data.get("topologies") or {})
            except (OSError, ValueError):
                table = {}  # corrupt: rewrite
        table[rec["fingerprint"]] = rec
        publish_json(p, {"schema": TOPOLOGY_SCHEMA_VERSION,
                         "topologies": table})
    return p


def load_topology(fingerprint: str,
                  path: Union[str, Path, None] = None
                  ) -> Optional[Dict]:
    """The stored record, or None (a miss, an absent or corrupt file,
    another schema, an invalid record)."""
    p = Path(path) if path is not None else default_topology_path()
    if not p.exists():
        return None
    try:
        data = json.loads(p.read_text())
    except (OSError, ValueError):
        return None
    if not isinstance(data, dict) \
            or data.get("schema") != TOPOLOGY_SCHEMA_VERSION:
        return None
    rec = (data.get("topologies") or {}).get(fingerprint)
    if rec is None or validate_topology(rec):
        return None
    return rec


def topology_coefficients(rec: Dict) -> Dict:
    """The record's links as ``LinkCoefficients`` per link name, which
    ``run_autotune(topology=...)`` consumes."""
    from ..analysis.costmodel import LinkCoefficients

    return {name: LinkCoefficients(
                alpha_s=float(c["alpha_s"]),
                beta_bytes_per_s=float(c["beta_bytes_per_s"]))
            for name, c in rec["links"].items()}


# ---------------------------------------------------------------------------
# placement-quality scoring

#: the meshes the placement gate holds QAP <= trivial on
REGISTERED_MESHES: Tuple[Dict, ...] = (
    {"name": "2x2x2", "counts": (2, 2, 2)},
    {"name": "1x2x4", "counts": (1, 2, 4)},
    {"name": "4x2x1", "counts": (4, 2, 1)},
    {"name": "1x1x8", "counts": (1, 1, 8)},
    {"name": "2x2x2+dcn", "counts": (2, 2, 2), "dcn_axis": 2,
     "n_slices": 2},
)


def placement_quality(counts: Dim3, radius: Radius,
                      elem_sizes: Sequence[int],
                      grid: Optional[Dim3] = None,
                      devices: Optional[Sequence] = None,
                      dcn_axis: Optional[int] = None,
                      n_slices: int = 1,
                      qap_solver: Optional[Callable] = None,
                      mode: str = "auto") -> Dict:
    """Score placements of one mesh under the NodeAware objective
    (``placement.comm_bytes_matrix`` against the fabric distances):
    trivial order, the ``qap.solve_catch`` hill climb, and the
    assignment ``placement.make_placement`` deploys under ``mode`` on
    coordless devices (``"cpu"`` stand-ins by default). ``ok`` needs the
    QAP and the deployed costs to be no more than trivial's (JAX
    ``observatory/linkmap.py:803-867``)."""
    from .. import qap
    from ..partition import RankPartition
    from ..placement import (PlacementStrategy, comm_bytes_matrix,
                             make_placement)

    counts = Dim3.of(counts)
    if grid is None:
        grid = counts * Dim3(8, 8, 8)
    part = RankPartition.from_dim(tuple(grid), tuple(counts))
    w = comm_bytes_matrix(part, radius, elem_sizes)
    dist = mesh_distance_matrix(counts, devices=devices,
                                dcn_axis=dcn_axis, n_slices=n_slices)
    n = counts.flatten()
    trivial = qap.cost(w, dist, list(range(n)))
    solver = qap_solver or qap.solve_catch
    assignment, qap_cost = solver(w, dist)
    qap_cost = qap.cost(w, dist, list(assignment))
    stubs = list(devices) if devices is not None else ["cpu"] * n
    placed = make_placement(PlacementStrategy.NodeAware, part, stubs,
                            radius, elem_sizes, mode=mode,
                            dcn_axis=dcn_axis, n_slices=n_slices)
    deployed_cost = qap.cost(w, dist, list(placed.assignment))
    return {
        "counts": list(counts),
        "grid": list(grid),
        "subdomains": n,
        "dcn_axis": (AXIS_NAMES[dcn_axis] if dcn_axis is not None
                     else None),
        "n_slices": int(n_slices),
        "traffic_total_bytes": float(w.sum()),
        "trivial_cost": float(trivial),
        "qap_cost": float(qap_cost),
        "qap_over_trivial": (float(qap_cost) / float(trivial)
                             if trivial else 1.0),
        "assignment": [int(a) for a in assignment],
        "placement_mode": str(mode),
        "deployed_assignment": [int(a) for a in placed.assignment],
        "deployed_cost": float(deployed_cost),
        "ok": bool(qap_cost <= trivial * (1 + 1e-12)
                   and deployed_cost <= trivial * (1 + 1e-12)),
    }


def placement_report(meshes: Sequence[Dict] = REGISTERED_MESHES,
                     radius: Optional[Radius] = None,
                     elem_sizes: Sequence[int] = (4,)) -> Dict:
    """``placement_quality`` over every registered mesh; ``ok`` when
    every row is."""
    r = radius if radius is not None else Radius.constant(1)
    rows = []
    for spec in meshes:
        row = placement_quality(
            Dim3.of(tuple(spec["counts"])), r, elem_sizes,
            grid=(Dim3.of(tuple(spec["grid"]))
                  if spec.get("grid") else None),
            dcn_axis=spec.get("dcn_axis"),
            n_slices=int(spec.get("n_slices", 1)))
        row["name"] = spec.get("name", "x".join(
            str(c) for c in spec["counts"]))
        rows.append(row)
    return {
        "schema": 1,
        "kind": "placement_report",
        "radius": [[d.x, d.y, d.z, r.dir(d)]
                   for d in all_directions() if r.dir(d)],
        "meshes": rows,
        "ok": all(row["ok"] for row in rows),
    }


def render_heatmap(tm: TrafficMatrix, width: int = 2) -> str:
    """ASCII heatmap of the matrix (rows send, columns receive)."""
    w = tm.matrix()
    peak = float(w.max()) or 1.0
    shades = " .:-=+*#%@"
    lines = [f"traffic matrix ({tm.n} shards, {tm.total()} B/round; "
             f"rows send, cols receive)"]
    for i in range(tm.n):
        cells = []
        for j in range(tm.n):
            level = int(round((len(shades) - 1) * float(w[i, j]) / peak))
            cells.append(shades[level] * width)
        lines.append(f"  {i:>3} |{''.join(cells)}|")
    return "\n".join(lines)


def render_summary(summary: LinkmapSummary) -> str:
    rec = summary.to_record()
    lines = [f"link classes ({rec['total_bytes']} B/round, "
             f"{rec['rounds_per_step']:.3g} rounds/step):"]
    for key, row in rec["links"].items():
        lines.append(f"  {key:<14} {row['bytes']:>12} B  "
                     f"({100 * row['share']:5.1f}%)")
    lines.append("direction classes:")
    for key, row in rec["direction_classes"].items():
        lines.append(f"  {key:<14} {row['bytes']:>12} B  "
                     f"({100 * row['share']:5.1f}%)")
    return "\n".join(lines)
