"""The alpha-beta exchange cost model.

PyTorch-port counterpart of the alpha-beta part of
``stencil_tpu/analysis/costmodel.py`` (its lines 242-470): per-link
coefficients (a latency per message and a sustained byte rate), the
analytic messages and wire bytes one shard contributes per exchange
round under each method, per mesh axis, and the per-step seconds under
per-axis temporal depths with one axis on the slow inter-host link. The
DCN planner (``DistributedDomain._plan_dcn_partition``) ranks candidate
mesh shapes and host-blocked axes with ``asymmetric_step_seconds``.

The byte and time model of the exchange autotuner (``tuning/``) and the
performance observatory (``observatory/``) follows (JAX
``analysis/costmodel.py:125-238``, ``:472-535``): the deep exchange's
bytes and their amortization over the steps it feeds, the particle
migration's static wire bill, the per-step seconds of one (method,
depth) configuration and the depth crossover. The checker
(``CostModelSpec``, ``CostModelTarget``, ``check_costmodel``; checker 5)
holds the bytes the engines' probe records against that model exactly,
and prices a run's arithmetic with JAX's ``jaxpr_flops`` weights over
the aten ops ``probes.OpLog`` sees (``op_flops``), its inputs' and
outputs' bytes standing for ``io_bytes``.

The defaults price the H100 host, not a TPU: the intra-host link is the
fit ``apps/pingpong.py`` makes on the card, the inter-host link an
assumption from its nominal rate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

from ..geometry import normalize_depths
from ..parallel.exchange import exchanged_bytes_per_sweep
from ..parallel.migrate import migration_messages, migration_record_rows
from ..parallel.packing import (irredundant_bytes_per_sweep,
                                normalize_wire_layout)


@dataclasses.dataclass(frozen=True)
class LinkCoefficients:
    """Alpha-beta coefficients of one link class (intra-host or
    inter-host): the latency of one message and the sustained rate one
    shard can put on the link."""

    alpha_s: float           # seconds of latency per message
    beta_bytes_per_s: float  # sustained bytes/s one shard puts on the wire

    def seconds(self, messages: int, wire_bytes: float) -> float:
        return messages * self.alpha_s + wire_bytes / self.beta_bytes_per_s


#: the intra-host link (card to card over NVLink): the fit of
#: ``python -m stencil_tpu_torch.apps.pingpong --devices
#: cuda:0,cuda:1,cuda:2,cuda:3 --iters 40`` (its ``pingpong fit`` line:
#: every card sends to the next at once, issued by one host thread, so
#: alpha carries the host's copy issue and synchronize) on four NVIDIA
#: H100 80GB HBM3 cards of one host at a 700.00 W power limit
DEFAULT_ICI_COEFFS = LinkCoefficients(alpha_s=1.1941886173898174e-04,
                                      beta_bytes_per_s=1.7329498110167914e+11)

#: the inter-host link: ASSUMED, not measured — the nominal 400 Gb/s
#: (50 GB/s) of one NDR InfiniBand port per card, and the intra-host
#: latency plus 5 us for the network hop
DEFAULT_DCN_COEFFS = LinkCoefficients(
    alpha_s=DEFAULT_ICI_COEFFS.alpha_s + 5e-6, beta_bytes_per_s=50e9)

AXIS_NAMES = ("x", "y", "z")


def sweep_wire_bytes(shard_padded_zyx: Sequence[int], radius, counts,
                     elem_size: int,
                     axis_order: Tuple[int, ...] = (0, 1, 2),
                     wire_format=None, layout: str = "slab",
                     alloc_radius=None) -> Dict[str, int]:
    """Per-axis wire bytes one shard ships per exchange round under
    either wire layout: ``exchanged_bytes_per_sweep`` for "slab",
    ``irredundant_bytes_per_sweep`` for "irredundant" (JAX
    ``analysis/costmodel.py:100-122``)."""
    if normalize_wire_layout(layout) == "irredundant":
        return irredundant_bytes_per_sweep(
            shard_padded_zyx, radius, counts, elem_size, axis_order,
            wire_format=wire_format, alloc_radius=alloc_radius)
    return exchanged_bytes_per_sweep(shard_padded_zyx, radius, counts,
                                     elem_size, axis_order,
                                     wire_format=wire_format)


def resolve_link_coeffs(coeffs, axis: "int | None" = None,
                        dcn: bool = False) -> LinkCoefficients:
    """The ``LinkCoefficients`` pricing one mesh axis's exchange.

    ``coeffs`` may be None (the defaults: ``DEFAULT_DCN_COEFFS`` for a
    host-blocked axis, ``DEFAULT_ICI_COEFFS`` otherwise), one
    ``LinkCoefficients`` for every link, or a dict keyed by link name:
    per-axis ``"x"``/``"y"``/``"z"``, the ``"dcn"`` tier, and an
    ``"ici"`` catch-all."""
    if coeffs is None:
        return DEFAULT_DCN_COEFFS if dcn else DEFAULT_ICI_COEFFS
    if isinstance(coeffs, LinkCoefficients):
        return coeffs
    if dcn and "dcn" in coeffs:
        return coeffs["dcn"]
    if axis is not None and AXIS_NAMES[axis] in coeffs:
        return coeffs[AXIS_NAMES[axis]]
    if "ici" in coeffs:
        return coeffs["ici"]
    if dcn:
        return DEFAULT_DCN_COEFFS
    return next(iter(coeffs.values()), DEFAULT_ICI_COEFFS)


def _padded(shard_interior_zyx: Sequence[int], deep) -> Tuple[int, int, int]:
    lo, hi = deep.pad_lo(), deep.pad_hi()
    z, y, x = shard_interior_zyx
    return (z + lo.z + hi.z, y + lo.y + hi.y, x + lo.x + hi.x)


def _wire(method_name: str, wire_format, wire_layout: str):
    """Only the slab and packed engines narrow the wire or take the
    irredundant layout; the others ship storage bytes in slabs."""
    capable = method_name in ("PpermuteSlab", "PpermutePacked")
    return ((wire_format, wire_layout) if capable else (None, "slab"))


def _groups(method_name: str, elem_sizes: Sequence[int],
            dtype_groups: "int | None") -> int:
    """Messages a direction: one per quantity, or, packed, one per
    storage dtype (approximated by the distinct element sizes)."""
    if method_name == "PpermutePacked":
        return int(dtype_groups) if dtype_groups else len(set(elem_sizes))
    return len(elem_sizes)


def exchange_round_model(method_name: str,
                         shard_interior_zyx: Sequence[int], radius,
                         counts, elem_sizes: Sequence[int],
                         steps: int = 1,
                         dtype_groups: "int | None" = None,
                         wire_format=None,
                         wire_layout: str = "slab") -> Tuple[int, int]:
    """Analytic (messages, wire_bytes) ONE shard contributes per deep
    exchange round under method ``method_name`` (JAX
    ``analysis/costmodel.py:297-366``): ``PpermuteSlab`` and
    ``PallasDMA`` one message per active axis-direction per quantity,
    ``PpermutePacked`` one per dtype group, the same bytes;
    ``AllGather`` one per quantity, with ``(n_axis - 1)`` times the slab
    bytes. ``steps`` > 1 prices the deepened round; ``wire_format`` and
    ``wire_layout`` price the slab and packed engines only."""
    deep = radius.deepened(steps)
    padded = _padded(shard_interior_zyx, deep)
    directions = 0
    gather_factor = {}
    for a, name in enumerate(AXIS_NAMES):
        if counts[a] <= 1:
            continue
        for side in (-1, 1):
            if deep.face(a, side) > 0:
                directions += 1
        gather_factor[name] = counts[a] - 1
    messages = directions * _groups(method_name, elem_sizes, dtype_groups)
    wf, layout = _wire(method_name, wire_format, wire_layout)
    nbytes = 0
    for esize in elem_sizes:
        per_axis = sweep_wire_bytes(padded, deep, counts, esize,
                                    wire_format=wf, layout=layout)
        for name, b in per_axis.items():
            if method_name == "AllGather":
                b *= gather_factor.get(name, 1)
            nbytes += b
    return messages, nbytes


def per_axis_round_model(method_name: str,
                         shard_interior_zyx: Sequence[int], radius,
                         counts, elem_sizes: Sequence[int],
                         steps=1,
                         dtype_groups: "int | None" = None,
                         wire_format=None,
                         wire_layout: str = "slab"
                         ) -> Dict[str, Tuple[int, int]]:
    """``exchange_round_model`` split per mesh axis: ``{axis: (messages,
    wire_bytes)}`` ONE shard contributes per full-depth refresh of that
    axis (JAX ``analysis/costmodel.py:369-418``). ``steps`` may be
    per-axis; axis ``a`` ships ``s_a * r`` rows over the full deepened
    cross-sections, so its per-STEP price is this entry over ``s_a``.
    Summed at uniform depth it is ``exchange_round_model``."""
    deep = radius.deepened(normalize_depths(steps))
    padded = _padded(shard_interior_zyx, deep)
    wf, layout = _wire(method_name, wire_format, wire_layout)
    groups = _groups(method_name, elem_sizes, dtype_groups)
    per_axis_bytes = [sweep_wire_bytes(padded, deep, counts, esize,
                                       wire_format=wf, layout=layout)
                      for esize in elem_sizes]
    out: Dict[str, Tuple[int, int]] = {}
    for a, name in enumerate(AXIS_NAMES):
        directions = 0
        if counts[a] > 1:
            for side in (-1, 1):
                if deep.face(a, side) > 0:
                    directions += 1
        nbytes = 0
        for b in per_axis_bytes:
            v = b[name]
            if method_name == "AllGather":
                v *= max(counts[a] - 1, 1)
            nbytes += v
        out[name] = (directions * groups, nbytes)
    return out


def asymmetric_group_bytes_per_shard(shard_interior_zyx: Sequence[int],
                                     radius, counts, elem_size: int,
                                     depths,
                                     wire_layout: str = "slab") -> int:
    """Wire bytes ONE shard sends per ``max(depths)``-step temporal
    group under per-axis depths: the sub-step-0 exchange plus every
    mid-group refresh — axis ``a`` ships its deep slab ``max(s) / s_a``
    times (JAX ``analysis/costmodel.py:421-439``)."""
    depths = normalize_depths(depths)
    s = max(depths)
    per_axis = per_axis_round_model(
        "PpermuteSlab", shard_interior_zyx, radius, counts, [elem_size],
        depths, wire_layout=wire_layout)
    return sum(per_axis[AXIS_NAMES[a]][1] * (s // depths[a])
               for a in range(3))


def asymmetric_step_seconds(method_name: str,
                            shard_interior_zyx: Sequence[int], radius,
                            counts, elem_sizes: Sequence[int],
                            depths, coeffs=None,
                            dcn_axis: "int | None" = None,
                            dtype_groups: "int | None" = None,
                            wire_format=None,
                            wire_layout: str = "slab") -> float:
    """Alpha-beta exchange seconds per STEP under per-axis temporal
    depths: axis ``a`` pays ``coeffs[link(a)].seconds(messages_a,
    bytes_a)`` once per ``s_a`` steps, the host-blocked ``dcn_axis`` at
    the inter-host link's price (JAX ``analysis/costmodel.py:
    442-469``)."""
    depths = normalize_depths(depths)
    per_axis = per_axis_round_model(
        method_name, shard_interior_zyx, radius, counts, elem_sizes,
        depths, dtype_groups, wire_format=wire_format,
        wire_layout=wire_layout)
    total = 0.0
    for a in range(3):
        m, b = per_axis[AXIS_NAMES[a]]
        c = resolve_link_coeffs(coeffs, axis=a, dcn=a == dcn_axis)
        total += c.seconds(m, b) / depths[a]
    return total


def deep_exchange_bytes_per_shard(shard_interior_zyx: Sequence[int],
                                  radius, counts, elem_size: int,
                                  steps: int,
                                  wire_layout: str = "slab") -> int:
    """Wire bytes ONE shard sends per ``steps``-deep exchange (temporal
    blocking): the deepened radius' rows over the deepened padded
    cross-sections, under the selected wire layout (JAX
    ``analysis/costmodel.py:125-139``)."""
    deep = radius.deepened(steps)
    return sum(sweep_wire_bytes(_padded(shard_interior_zyx, deep), deep,
                                counts, elem_size,
                                layout=wire_layout).values())


def amortized_step_wire_bytes(shard_interior_zyx: Sequence[int],
                              radius, counts, elem_size: int,
                              steps: int,
                              wire_layout: str = "slab") -> float:
    """Per-shard wire bytes charged to each STEP under ``steps``-deep
    blocking: the deep exchange's bytes over the ``steps`` steps it
    feeds (JAX ``analysis/costmodel.py:142-155``)."""
    return deep_exchange_bytes_per_shard(shard_interior_zyx, radius,
                                         counts, elem_size, steps,
                                         wire_layout) / steps


def migration_wire_bytes_per_shard(n_fields: int, budget: int, counts,
                                   elem_size: int) -> int:
    """Wire bytes ONE shard sends per particle-migration step: 2
    messages per mesh axis of more than one shard, each a fixed
    ``record_rows x budget`` buffer (JAX ``analysis/costmodel.py:
    169-180``)."""
    return (migration_messages(counts) * migration_record_rows(n_fields)
            * int(budget) * int(elem_size))


def migration_step_seconds(n_fields: int, budget: int, counts,
                           elem_size: int,
                           coeffs: "LinkCoefficients | None" = None
                           ) -> float:
    """Alpha-beta migration cost per STEP: the messages plus the
    budget-sized buffers over the link's rate (JAX
    ``analysis/costmodel.py:183-196``)."""
    c = coeffs if coeffs is not None else DEFAULT_ICI_COEFFS
    return c.seconds(migration_messages(counts),
                     migration_wire_bytes_per_shard(
                         n_fields, budget, counts, elem_size))


def temporal_step_exchange_seconds(shard_interior_zyx: Sequence[int],
                                   radius, counts, elem_size: int,
                                   steps: int, round_latency_s: float,
                                   wire_bytes_per_s: float) -> float:
    """Alpha-beta exchange cost per STEP at blocking depth ``steps``:
    ``latency / steps + amortized_bytes / bandwidth`` (JAX
    ``analysis/costmodel.py:199-209``)."""
    amort = amortized_step_wire_bytes(shard_interior_zyx, radius, counts,
                                      elem_size, steps)
    return round_latency_s / steps + amort / wire_bytes_per_s


def _depth_fits(d, radius, shard_interior_zyx) -> bool:
    z, y, x = shard_interior_zyx
    interior_xyz = (x, y, z)
    return all(d[a] * max(radius.face(a, -1), radius.face(a, 1))
               <= interior_xyz[a] for a in range(3))


def predict_exchange_every(shard_interior_zyx: Sequence[int], radius,
                           counts, elem_size: int,
                           round_latency_s: float,
                           wire_bytes_per_s: float,
                           candidates: Sequence[int] = (1, 2, 3, 4, 6, 8)
                           ) -> Tuple[int, Dict[int, float]]:
    """The ``exchange_every`` minimizing the alpha-beta per-step
    exchange time, among the depths the shard can host (JAX
    ``analysis/costmodel.py:212-238``). Returns ``(best_s, {s:
    seconds_per_step})``."""
    costs: Dict[int, float] = {}
    for s in candidates:
        if not _depth_fits((s, s, s), radius, shard_interior_zyx):
            continue
        costs[s] = temporal_step_exchange_seconds(
            shard_interior_zyx, radius, counts, elem_size, s,
            round_latency_s, wire_bytes_per_s)
    if not costs:
        raise ValueError(f"no candidate depth fits shards "
                         f"{shard_interior_zyx} with radius {radius}")
    return min(costs, key=costs.get), costs


def predict_exchange_depths(shard_interior_zyx: Sequence[int], radius,
                            counts, elem_size: int, coeffs=None,
                            dcn_axis: "int | None" = None,
                            candidates: Sequence = (1, 2, 4, 8)
                            ) -> Tuple[Tuple[int, int, int],
                                       Dict[Tuple[int, int, int], float]]:
    """``predict_exchange_every`` over per-axis depths priced per link
    with ``asymmetric_step_seconds`` (JAX ``analysis/costmodel.py:
    472-498``). Returns ``(best, {depths_xyz: seconds})``."""
    costs: Dict[Tuple[int, int, int], float] = {}
    for cand in candidates:
        d = normalize_depths(cand)
        if not _depth_fits(d, radius, shard_interior_zyx):
            continue
        costs[tuple(d)] = asymmetric_step_seconds(
            "PpermuteSlab", shard_interior_zyx, radius, counts,
            [elem_size], d, coeffs=coeffs, dcn_axis=dcn_axis)
    if not costs:
        raise ValueError(f"no candidate depth fits shards "
                         f"{shard_interior_zyx} with radius {radius}")
    return min(costs, key=costs.get), costs


def configured_step_seconds(method_name: str,
                            shard_interior_zyx: Sequence[int], radius,
                            counts, elem_sizes: Sequence[int],
                            steps,
                            coeffs=DEFAULT_ICI_COEFFS,
                            dtype_groups: "int | None" = None,
                            wire_format=None,
                            wire_layout: str = "slab",
                            dcn_axis: "int | None" = None) -> float:
    """Alpha-beta exchange seconds per STEP of one (method, depth)
    configuration: the deep round's cost over the ``steps`` steps it
    feeds (JAX ``analysis/costmodel.py:501-535``). The autotuner calls
    it with MEASURED coefficients to prune its sweep. Per-axis ``steps``
    or a per-link ``coeffs`` dict (with ``dcn_axis``) go through
    ``asymmetric_step_seconds``; the uniform single-link case keeps the
    one-term arithmetic."""
    depths = normalize_depths(steps)
    uniform = depths.x == depths.y == depths.z
    if uniform and isinstance(coeffs, LinkCoefficients) \
            and dcn_axis is None:
        messages, nbytes = exchange_round_model(
            method_name, shard_interior_zyx, radius, counts, elem_sizes,
            depths.x, dtype_groups, wire_format=wire_format,
            wire_layout=wire_layout)
        return coeffs.seconds(messages, nbytes) / depths.x
    return asymmetric_step_seconds(
        method_name, shard_interior_zyx, radius, counts, elem_sizes,
        depths, coeffs=coeffs, dcn_axis=dcn_axis,
        dtype_groups=dtype_groups, wire_format=wire_format,
        wire_layout=wire_layout)


# ---------------------------------------------------------------------------
# the checker: probed wire bytes against the byte model, FLOPs
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FlopsSpec:
    """A plain computation to price: ``fn()`` runs it once on small CPU
    tensors; ``io_bytes`` its inputs' and outputs' bytes."""
    fn: "object"
    io_bytes: int


@dataclasses.dataclass
class CostModelSpec:
    """A run whose messages are held to the byte model: ``run()`` runs
    it once in one process; ``expected_bytes_total`` is what the model
    says its messages carry, over every shard; ``flops`` (optional) a
    ``FlopsSpec`` of its arithmetic."""
    run: "object"
    expected_bytes_total: int
    flops: "FlopsSpec | None" = None


@dataclasses.dataclass
class CostModelTarget:
    name: str
    build: "object"

    checker = "costmodel"


def op_flops(fn) -> Tuple[int, int]:
    """(FLOPs by JAX's ``jaxpr_flops`` weights, ops seen) of ``fn()``,
    through ``probes.OpLog``."""
    import torch

    from .probes import OpLog

    with torch.no_grad(), OpLog() as log:
        fn()
    return log.flops, len(log.ops)


def check_costmodel(target: CostModelTarget):
    """Probed wire bytes equal the byte model exactly (JAX's
    HLO-observed bytes against its analytic model); FLOPs and the
    arithmetic intensity where the target prices its arithmetic."""
    import torch

    from ..parallel.exchange import WireProbe, recording
    from .entries import ExchangeSpec, probe_messages
    from .report import Finding

    try:
        spec = target.build()
    except Exception as e:  # noqa: BLE001
        return [Finding("costmodel", target.name,
                        f"target build failed: {type(e).__name__}: {e}")]
    if isinstance(spec, ExchangeSpec):
        observed = probe_messages(spec).bytes
        expected = spec.expected_bytes_per_shard * spec.counts.flatten()
        flops = None
    else:
        probe = WireProbe()
        with torch.no_grad(), recording(probe):
            spec.run()
        observed, expected = probe.bytes, spec.expected_bytes_total
        flops = spec.flops
    findings = []
    if observed != expected:
        findings.append(Finding(
            "costmodel", target.name,
            f"probed wire bytes {observed} != the byte model's {expected} "
            f"(difference {observed - expected})"))
    metrics = {"observed_bytes": observed, "expected_bytes": expected}
    if flops is not None:
        n, ops = op_flops(flops.fn)
        if not ops:
            findings.append(Finding("costmodel", target.name,
                                    "no op seen: nothing priced"))
        metrics.update(flops=n, io_bytes=flops.io_bytes,
                       arithmetic_intensity=n / max(flops.io_bytes, 1))
    return findings, metrics
