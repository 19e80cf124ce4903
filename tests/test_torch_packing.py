"""The port's irredundant wire layout (``parallel/packing.py``) and its
byte models against the JAX package's.

The planner is a copy of JAX's pure-Python one, so every Span, every
report entry and every byte figure must be equal, under every wire
format. The engine's irredundant boxes land where the slab layout's
rows land: on the live window (interior plus the wire-radius shell)
both layouts fill the same bits, on even and uneven (+-1) shards.
Tolerance: exact (integers) and bitwise (an exchange only copies).
"""

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.geometry import Dim3 as JDim3, Radius as JRadius
from stencil_tpu.parallel import packing as jp
from stencil_tpu.parallel.exchange import (
    exchanged_bytes_per_sweep as j_slab_bytes)
from stencil_tpu_torch import Boundary, Dim3, Radius
from stencil_tpu_torch.distributed import DistributedDomain
from stencil_tpu_torch.local_domain import raw_size
from stencil_tpu_torch.parallel import packing as pp
from stencil_tpu_torch.parallel.exchange import (WIRE_FORMATS,
                                                 exchanged_bytes_per_sweep)

jax.config.update("jax_platforms", "cpu")


def _asym(R):
    r = R.constant(0)
    r.set_dir((1, 0, 0), 2)
    r.set_dir((-1, 0, 0), 1)
    r.set_dir((0, 1, 0), 1)
    return r


# name: (radius factory, alloc radius factory or None, interiors xyz)
PLANS = {
    "r1": (lambda R: R.constant(1), None, (8, 8, 8)),
    "r3": (lambda R: R.constant(3), None, (9, 8, 7)),
    "asym": (_asym, None, (11, 12, 13)),
    "deep": (lambda R: R.constant(1), lambda R: R.constant(2), (12, 10, 9)),
}
ORDERS = [(0, 1, 2), (2, 1, 0), (1, 2, 0)]


def _spans(plan):
    return [(s.base, s.plus_L, s.size) for s in plan.src], \
        [(s.base, s.plus_L, s.size) for s in plan.dst]


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_sweep_matches_jax_span_by_span(name):
    make_r, make_alloc, interiors = PLANS[name]
    for order in ORDERS:
        got = pp.plan_sweep(make_r(Radius),
                            make_alloc(Radius) if make_alloc else None,
                            interiors, order)
        want = jp.plan_sweep(make_r(JRadius),
                             make_alloc(JRadius) if make_alloc else None,
                             interiors, order)
        assert list(got) == list(want)
        for key in want:
            assert _spans(got[key]) == _spans(want[key]), (name, order, key)
            assert (got[key].axis, got[key].side, got[key].elems) == \
                (want[key].axis, want[key].side, want[key].elems)


def test_pack_layout_report_matches_jax_and_its_figures():
    got = pp.pack_layout_report()
    assert got == jp.pack_layout_report()
    figures = {"exchange[r1]": (6144, 5408), "exchange[r3]": (28800, 21024),
               "exchange[asym]": (3472, 3304),
               "exchange_packed[uneven,f32]": (2400, 1952),
               "temporal[s=2,deep]": (6912, 4864),
               "deep_tail[r1,alloc=r2]": (6144, 4064)}
    assert {k: (v["slab_bytes"], v["irredundant_bytes"])
            for k, v in got.items()} == figures


# (padded shard shape zyx, radius factory, alloc factory, mesh xyz)
BYTE_CASES = [
    ((16, 16, 16), lambda R: R.constant(1), None, (2, 2, 2)),
    ((20, 18, 22), lambda R: R.constant(3), None, (2, 1, 2)),
    ((14, 15, 17), _asym, None, (2, 2, 1)),
    ((16, 16, 16), lambda R: R.constant(1), lambda R: R.constant(2),
     (1, 2, 2)),
    ((514, 258, 258), lambda R: R.constant(1), None, (1, 2, 2)),
]


@pytest.mark.parametrize("fmt", list(WIRE_FORMATS) + ["dict"])
def test_byte_models_match_jax_under_every_wire_format(fmt):
    wire = {"y": "bf16", "z": "e5m2"} if fmt == "dict" else fmt
    for padded, make_r, make_alloc, mesh in BYTE_CASES:
        for elem in (4, 8, 2):
            for order in ORDERS:
                got = pp.irredundant_bytes_per_sweep(
                    padded, make_r(Radius), Dim3(*mesh), elem, order,
                    wire_format=wire,
                    alloc_radius=make_alloc(Radius) if make_alloc else None)
                want = jp.irredundant_bytes_per_sweep(
                    padded, make_r(JRadius), JDim3(*mesh), elem, order,
                    wire_format=wire,
                    alloc_radius=make_alloc(JRadius) if make_alloc
                    else None)
                assert got == want, (padded, mesh, elem, order)
                assert exchanged_bytes_per_sweep(
                    padded, make_r(Radius), Dim3(*mesh), elem, order,
                    wire_format=wire) == j_slab_bytes(
                    padded, make_r(JRadius), JDim3(*mesh), elem, order,
                    wire_format=wire)


def test_jacobi_512_on_four_shards_byte_figures():
    """512^3 over (1,2,2), radius 1, padded 514 x 258 x 258 a shard:
    1,593,408 B slab, 1,589,280 B irredundant, 794,640 B at bf16."""
    padded, r, mesh = (514, 258, 258), Radius.constant(1), Dim3(1, 2, 2)
    assert sum(exchanged_bytes_per_sweep(padded, r, mesh, 4).values()) == \
        1_593_408
    assert sum(pp.irredundant_bytes_per_sweep(padded, r, mesh, 4)
               .values()) == 1_589_280
    assert sum(pp.irredundant_bytes_per_sweep(
        padded, r, mesh, 4, wire_format="bf16").values()) == 794_640


def test_bench_exchange_layout_bytes_ratio():
    """Four 256^3 shards over the bench's (2,2,1) mesh, radius 2:
    2,113,536 / 2,163,200 B a shard."""
    padded, r, mesh = (260, 260, 260), Radius.constant(2), Dim3(2, 2, 1)
    slab = sum(exchanged_bytes_per_sweep(padded, r, mesh, 4).values())
    irr = sum(pp.irredundant_bytes_per_sweep(padded, r, mesh, 4).values())
    assert (irr, slab) == (2_113_536, 2_163_200)
    assert round(irr / slab, 5) == 0.97704


@pytest.mark.parametrize("layout", [None, "slab", "irredundant", "packed",
                                    "", 3])
def test_normalize_wire_layout_matches_jax(layout):
    try:
        want = jp.normalize_wire_layout(layout)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pp.normalize_wire_layout(layout)
        assert str(got.value) == str(e)
    else:
        assert pp.normalize_wire_layout(layout) == want
    assert pp.WIRE_LAYOUTS == jp.WIRE_LAYOUTS


def _exchanged(size, mesh, radius, boundary, layout, wire, method=None,
               seed=51):
    """A port domain whose shards hold seeded random values everywhere
    (halos and dead rows too), after one exchange."""
    n = mesh[0] * mesh[1] * mesh[2]
    dd = DistributedDomain(*size, devices=["cpu"] * n)
    dd.set_mesh_shape(mesh)
    dd.set_radius(radius)
    dd.set_boundary(boundary)
    dd.set_wire_layout(layout)
    dd.set_wire_format(wire)
    if method is not None:
        dd.set_methods(method)
    dd.add_data("q", torch.float32)
    dd.realize()
    rng = np.random.default_rng(seed)
    for t in dd.curr["q"]:
        t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape))
                                 .astype(np.float32)))
    dd.exchange()
    return dd


def _live(dd, i):
    """Shard i's live window: the interior and the wire-radius shell."""
    sz = dd.shard_size(i)
    lo, hi = dd.radius.pad_lo(), dd.radius.pad_hi()
    return (slice(0, lo.z + sz.z + hi.z), slice(0, lo.y + sz.y + hi.y),
            slice(0, lo.x + sz.x + hi.x))


@pytest.mark.parametrize("boundary", [Boundary.PERIODIC, Boundary.NONE])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("n", [16, 17])
def test_irredundant_equals_slab_on_the_live_window(n, r, wire, boundary):
    slab = _exchanged((n, n, n), (2, 2, 2), r, boundary, "slab", wire)
    irr = _exchanged((n, n, n), (2, 2, 2), r, boundary, "irredundant", wire)
    assert tuple(slab.rem) == ((1, 1, 1) if n == 17 else (0, 0, 0))
    for i in range(8):
        live = _live(slab, i)
        np.testing.assert_array_equal(irr.curr["q"][i][live].numpy(),
                                      slab.curr["q"][i][live].numpy(),
                                      err_msg=f"shard {i}")
    padded = raw_size(slab.local_size, slab.radius)
    assert irr.exchange_bytes_total() < slab.exchange_bytes_total()
    assert padded == raw_size(irr.local_size, irr.radius)
