"""The port's halo wire formats, exchange engines and wire-aware Jacobi3D
against the JAX package's.

JAX runs its ``DistributedDomain`` and ``Jacobi3D`` over the 8 fake CPU
devices; the port runs the same mesh with ``devices=["cpu"] * 8``.
Tolerance: bitwise (the uint32 bits, NaN signs included). A narrowing
wire rounds each message once, by the same rule in both packages
(``_to_wire``: round to nearest even, and float8_e4m3fn's NaN above 464,
which JAX applies and torch's own cast does not), and widens it back
exactly; the Jacobi ``xla`` path adds in JAX's order.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from stencil_tpu.distributed import DistributedDomain as JDomain
from stencil_tpu.geometry import Radius as JRadius
from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.parallel import exchange as jx
from stencil_tpu.parallel.mesh import make_mesh as j_make_mesh
from stencil_tpu.parallel.methods import Method as JMethod
from stencil_tpu.topology import Boundary as JBoundary
from stencil_tpu_torch import Boundary, Dim3, Jacobi3D, Radius
from stencil_tpu_torch.analysis.precision import (PrecisionGateError,
                                                  wire_edge_values)
from stencil_tpu_torch.distributed import DistributedDomain
from stencil_tpu_torch.parallel import exchange as px
from stencil_tpu_torch.parallel import methods as pmethods
from stencil_tpu_torch.parallel.mesh import Mesh
from stencil_tpu_torch.parallel.methods import Method
from torch_port_support import reference_block_planner

jax.config.update("jax_platforms", "cpu")

BOUNDARIES = {"periodic": (JBoundary.PERIODIC, Boundary.PERIODIC),
              "none": (JBoundary.NONE, Boundary.NONE)}
WIRES = {"f32": None, "bf16": "bf16", "e4m3": "e4m3",
         "dict": {"y": "bf16", "z": "e4m3"}}
METHODS = {"slab": Method.PpermuteSlab, "packed": Method.PpermutePacked,
           "allgather": Method.AllGather}
JDT = {"bf16": jax.numpy.bfloat16, "e4m3": jax.numpy.float8_e4m3fn,
       "e5m2": jax.numpy.float8_e5m2}


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# conversions


@pytest.mark.parametrize("fmt", ["bf16", "e4m3", "e5m2"])
def test_wire_round_trip_equals_jax(fmt):
    """``_to_wire`` then ``_from_wire`` equals JAX's ``astype`` round
    trip bit for bit, NaN signs included; e4m3 turns |x| > 464 and +-inf
    into NaN, as JAX does, where torch's own cast saturates to 448."""
    vals = wire_edge_values()
    want = np.asarray(jax.jit(lambda x: x.astype(JDT[fmt]).astype(
        jax.numpy.float32))(vals))
    t = torch.from_numpy(vals)
    wire = px._to_wire(t, fmt)
    assert wire.dtype == px.wire_dtype(torch.float32, fmt)
    got = px._from_wire(wire, torch.float32).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if fmt == "e4m3":
        big = np.abs(vals) > 464
        assert big.sum() > 100 and np.isnan(got[big]).all()
        saturated = t.to(torch.float8_e4m3fn).to(torch.float32).numpy()
        assert not np.isnan(saturated[big & np.isfinite(vals)]).any()


def test_to_wire_keeps_other_dtypes_and_the_identity():
    t = torch.arange(6, dtype=torch.float64)
    assert px._to_wire(t, "bf16") is t
    f = torch.ones(3)
    assert px._to_wire(f, "f32") is f
    assert px._from_wire(f, torch.float32) is f


@pytest.mark.parametrize("fmt", [None, "f32", "bf16", "e4m3", "e5m2",
                                 {"x": "bf16"}, {"z": "e5m2", "y": "e4m3"},
                                 "fp16", {"w": "bf16"}, {"x": "int8"}],
                         ids=str)
def test_normalize_wire_format_matches_jax(fmt):
    try:
        want = jx.normalize_wire_format(fmt)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            px.normalize_wire_format(fmt)
        assert str(got.value) == str(e)
        return
    assert px.normalize_wire_format(fmt) == want
    for f in want.values():
        for elem in (2, 4, 8):
            assert px.wire_elem_size(elem, f) == jx.wire_elem_size(elem, f)
        assert px.WIRE_DTYPE_NAMES[f] == jx.WIRE_DTYPE_NAMES[f]
        wd = px.wire_dtype(torch.float32, f)
        assert str(wd).replace("torch.", "") == np.dtype(
            jx.wire_dtype(np.float32, f)).name
        assert px.wire_dtype(torch.float64, f) == torch.float64
    assert px.WIRE_FORMATS == jx.WIRE_FORMATS


def test_wire_capable_methods_match_jax():
    from stencil_tpu.parallel import methods as jmethods

    assert [m.name for m in pmethods.WIRE_CAPABLE] == \
        [m.name for m in jmethods.WIRE_CAPABLE]
    for name in ("PpermuteSlab", "PpermutePacked", "PallasDMA",
                 "AllGather"):
        assert pmethods.method_supports_wire_format(Method[name]) == \
            jmethods.method_supports_wire_format(JMethod[name])


# ---------------------------------------------------------------------------
# the exchange matrix against JAX's DistributedDomain.exchange()


def _padded_blocks(host, counts, shard_shape):
    pz, py, px_ = shard_shape
    return [host[z * pz:(z + 1) * pz, y * py:(y + 1) * py,
                 x * px_:(x + 1) * px_]
            for z in range(counts[2]) for y in range(counts[1])
            for x in range(counts[0])]


def _global_values(n, r, seed):
    """Seeded values of a (2,2,2) mesh of padded shards, halos and dead
    rows included, at magnitudes up to ~1,500 (so e4m3 messages carry
    NaNs) and down to subnormals."""
    cap = -(-n // 2) + 2 * r
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((2 * cap,) * 3) * 10.0 ** rng.uniform(
        -40, 3.2, (2 * cap,) * 3)
    return v.astype(np.float32), (cap,) * 3


_JAX_RESULTS = {}


def _jax_exchanged(n, r, boundary, wire, layout):
    key = (n, r, boundary, wire, layout)
    if key not in _JAX_RESULTS:
        vals, _ = _global_values(n, r, seed=71 + n + r)
        with reference_block_planner():
            jd = JDomain(n, n, n, devices=jax.devices()[:8])
            jd.set_mesh_shape((2, 2, 2))
            jd.set_radius(JRadius.constant(r))
            jd.set_boundary(BOUNDARIES[boundary][0])
            jd.set_wire_format(WIRES[wire] or "f32")
            jd.set_wire_layout(layout)
            jd.add_data("q", np.float32)
            jd.realize()
            assert tuple(jd.curr["q"].shape) == vals.shape
            jd.curr["q"] = jax.device_put(
                vals, NamedSharding(jd.mesh, P("z", "y", "x")))
            jd.exchange()
            _JAX_RESULTS[key] = (np.asarray(jd.curr["q"]),
                                 jd.exchange_bytes_per_axis())
    return _JAX_RESULTS[key]


def _port_exchanged(n, r, boundary, wire, layout, method):
    vals, shard = _global_values(n, r, seed=71 + n + r)
    dd = DistributedDomain(n, n, n, devices=["cpu"] * 8)
    dd.set_mesh_shape((2, 2, 2))
    dd.set_radius(r)
    dd.set_boundary(BOUNDARIES[boundary][1])
    if WIRES[wire] is not None:
        dd.set_wire_format(WIRES[wire])
    dd.set_wire_layout(layout)
    dd.set_methods(METHODS[method])
    dd.add_data("q", torch.float32)
    dd.realize()
    for t, blk in zip(dd.curr["q"], _padded_blocks(vals, (2, 2, 2), shard)):
        t.copy_(torch.from_numpy(blk.copy()))
    dd.exchange()
    return dd, shard


@pytest.mark.parametrize("method", ["slab", "packed"])
@pytest.mark.parametrize("layout", ["slab", "irredundant"])
@pytest.mark.parametrize("wire", sorted(WIRES))
@pytest.mark.parametrize("boundary", ["periodic", "none"])
@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("n", [16, 17])
def test_exchange_matrix_matches_jax(n, r, boundary, wire, layout, method):
    """Every cell of every shard, halos and dead capacity rows included,
    equals JAX's after one exchange; the byte counters too."""
    want, want_bytes = _jax_exchanged(n, r, boundary, wire, layout)
    dd, shard = _port_exchanged(n, r, boundary, wire, layout, method)
    blocks = _padded_blocks(want, (2, 2, 2), shard)
    for i, (t, w) in enumerate(zip(dd.curr["q"], blocks)):
        np.testing.assert_array_equal(_bits(t.numpy()), _bits(w),
                                      err_msg=f"shard {i}")
    assert dd.exchange_bytes_per_axis() == want_bytes


@pytest.mark.parametrize("r", [1, 3])
def test_allgather_matches_jax_on_even_periodic_grids(r):
    want, want_bytes = _jax_exchanged(16, r, "periodic", "f32", "slab")
    dd, shard = _port_exchanged(16, r, "periodic", "f32", "slab",
                                "allgather")
    for t, w in zip(dd.curr["q"], _padded_blocks(want, (2, 2, 2), shard)):
        np.testing.assert_array_equal(_bits(t.numpy()), _bits(w))
    assert dd.exchange_bytes_per_axis() == want_bytes


def _two_dtype_fields(size, mesh, r, seed):
    n = mesh[0] * mesh[1] * mesh[2]
    dd = DistributedDomain(*size, devices=["cpu"] * n)
    dd.set_mesh_shape(mesh)
    dd.set_radius(r)
    dd.add_data("a", torch.float64)
    dd.add_data("b", torch.float32)
    dd.realize()
    rng = np.random.default_rng(seed)
    for q in ("a", "b"):
        for t in dd.curr[q]:
            t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)) *
                                     600.0))
    return dd


@pytest.mark.parametrize("wire,layout", [(None, "slab"), ("bf16", "slab"),
                                         ("e4m3", "irredundant"),
                                         ("bf16", "irredundant")])
@pytest.mark.parametrize("nonperiodic", [False, True])
def test_packed_equals_slab_with_two_dtypes(wire, layout, nonperiodic):
    """Two quantities of different dtypes (float64 never narrows) on an
    uneven mesh: ``exchange_shard_packed`` equals ``exchange_shard`` per
    quantity, bitwise, halos and dead rows included."""
    size, mesh, r = (17, 13, 11), (2, 2, 2), Radius.constant(2)
    slab = _two_dtype_fields(size, mesh, 2, 81)
    packed = _two_dtype_fields(size, mesh, 2, 81)
    kw = dict(rem=slab.rem, nonperiodic=nonperiodic, wire_format=wire,
              wire_layout=layout)
    px.dispatch_exchange(slab.curr, r, slab.mesh_counts,
                         Method.PpermuteSlab, **kw)
    px.dispatch_exchange(packed.curr, r, packed.mesh_counts,
                         Method.PpermutePacked, **kw)
    for q in ("a", "b"):
        for s, p in zip(slab.curr[q], packed.curr[q]):
            assert torch.equal(s.view(torch.int32 if s.dtype ==
                                      torch.float32 else torch.int64),
                               p.view(torch.int32 if p.dtype ==
                                      torch.float32 else torch.int64))


def test_only_multi_shard_axes_narrow():
    """Four shards of (1,2,2): y and z narrow, the one-shard x axis is a
    local wrap at full precision — even with the four shards on one
    device."""
    probe = px.WireProbe()
    shards = [torch.full((4, 4, 4), 1.0 + 2.0 ** -12) for _ in range(4)]
    px.exchange_shard(shards, Radius.constant(1), Dim3(1, 2, 2),
                      wire_format="bf16", probe=probe)
    assert {(a, w) for a, w, *_ in probe.records} == \
        {("y", torch.bfloat16), ("z", torch.bfloat16)}
    s = shards[0]
    assert float(s[1, 1, 0]) == 1.0 + 2.0 ** -12    # x halo: full width
    assert float(s[1, 0, 1]) == 1.0                 # y halo: bf16
    assert float(s[0, 1, 1]) == 1.0                 # z halo: bf16


# ---------------------------------------------------------------------------
# Jacobi3D


def _jacobi_pair(size, wire, layout, boundary="periodic", dtype=np.float32,
                 **kw):
    x, y, z = size
    jb, pb = BOUNDARIES[boundary]
    with reference_block_planner():
        jj = JJacobi3D(x, y, z, mesh_shape=(2, 2, 2), dtype=dtype,
                       devices=jax.devices()[:8], kernel="xla", boundary=jb,
                       wire_format=wire, wire_layout=layout, **kw)
    pj = Jacobi3D(x, y, z, dtype=torch.float32 if dtype == np.float32
                  else torch.float64, kernel="xla", boundary=pb,
                  mesh_shape=(2, 2, 2), devices=["cpu"] * 8,
                  wire_format=wire, wire_layout=layout, **kw)
    return jj, pj


@pytest.mark.parametrize("layout", ["slab", "irredundant"])
@pytest.mark.parametrize("wire", ["bf16", "e4m3"])
@pytest.mark.parametrize("n", [16, 17])
def test_jacobi_wire_matches_jax_bitwise(n, wire, layout):
    jj, pj = _jacobi_pair((n, n, n), wire, layout)
    assert pj.kernel_path == jj.kernel_path == "xla"
    vals = np.random.default_rng(91 + n).random((n, n, n)).astype(
        np.float32)
    with reference_block_planner():
        jj.dd.set_interior("temp", vals)
        jj.run(3)
        want = jj.temperature()
    pj.load_interior(vals)
    pj.run(3)
    np.testing.assert_array_equal(_bits(pj.temperature()), _bits(want))
    assert pj.exchange_stats() == jj.exchange_stats()
    assert pj.dd.exchange_bytes_per_axis() == jj.dd.exchange_bytes_per_axis()
    jc, pc = jj.dd.precision_certificate, pj.dd.precision_certificate
    assert pc.safe and jc.safe
    assert pc.max_rel_error_bound == jc.max_rel_error_bound
    assert {a: (v["dtypes"], v["declared"]) for a, v in
            pc.wire_dtypes.items()} == {
        a: (v["dtypes"], v["declared"]) for a, v in jc.wire_dtypes.items()}


@pytest.mark.parametrize("boundary", ["periodic", "none"])
@pytest.mark.parametrize("n", [16, 17])
def test_jacobi_bf16_wire_error_bound(boundary, n):
    """tests/test_jacobi.py's bound on the port: a bf16 wire injects at
    most one 2^-8 relative rounding per halo cell per hop, and the
    7-point average is a contraction, so ``steps`` steps stay within
    ``steps * max_rel_error_bound * max`` of the port's f32-wire run —
    and the narrowed wire did perturb the halos."""
    steps = 5
    pb = BOUNDARIES[boundary][1]
    ref = Jacobi3D(n, n, n, kernel="xla", boundary=pb, mesh_shape=(2, 2, 2),
                   devices=["cpu"] * 8)
    jw = Jacobi3D(n, n, n, kernel="xla", boundary=pb, mesh_shape=(2, 2, 2),
                  devices=["cpu"] * 8, wire_format="bf16")
    for j in (ref, jw):
        j.init()
        j.run(steps)
    want, got = ref.temperature(), jw.temperature()
    cert = jw.dd.precision_certificate
    assert cert is not None and cert.safe
    assert cert.max_rel_error_bound == 2.0 ** -8
    assert got.dtype == np.float32
    err = np.abs(got - want).max()
    assert err <= steps * cert.max_rel_error_bound * np.abs(want).max()
    assert err > 0.0


def test_f32_wire_is_no_wire_argument_bitwise():
    runs = []
    for kw in ({}, {"wire_format": "f32"}, {"wire_format": {"x": "f32"}}):
        j = Jacobi3D(17, 17, 17, kernel="xla", mesh_shape=(2, 2, 2),
                     devices=["cpu"] * 8, **kw)
        assert j.dd.precision_certificate is None
        j.init()
        j.run(3)
        runs.append(_bits(j.temperature()))
    np.testing.assert_array_equal(runs[1], runs[0])
    np.testing.assert_array_equal(runs[2], runs[0])


def test_jacobi_blocked_equals_stepwise_irredundant_uneven():
    """tests/test_packing.py's case on the port: s-blocked equals
    step-by-step bitwise under the irredundant layout on uneven
    shards; 5 iterations so s=2 runs a tail group."""
    def run(s=None):
        j = Jacobi3D(17, 8, 8, dtype=torch.float64, kernel="xla",
                     mesh_shape=(2, 2, 2), devices=["cpu"] * 8,
                     wire_layout="irredundant", exchange_every=s)
        assert tuple(j.dd.rem) == (1, 0, 0)
        j.init()
        j.run(5)
        return j
    ref = run().temperature()
    for s in (2, 4):
        j = run(s)
        assert j.kernel_path == f"xla-temporal[s={s}]"
        np.testing.assert_array_equal(j.temperature(), ref)


def test_jacobi_pallas_path_takes_a_narrowed_wire():
    """``kernel="pallas"`` (K3's plain twin on the CPU) behind a bf16
    irredundant wire agrees with the ``xla`` path behind the same wire
    within ``steps * 8 * eps(float32)``: K3 and the plain stencil add
    the 7 points in different orders (values lie in [0, 1], and a
    Jacobi step never amplifies an earlier difference). Behind an f32
    wire K3 lands elsewhere, by more than that: the wire narrowed."""
    steps = 3
    out = {}
    for kernel, wire in (("xla", "bf16"), ("pallas", "bf16"),
                         ("pallas", "f32")):
        j = Jacobi3D(16, 16, 16, kernel=kernel, mesh_shape=(1, 2, 2),
                     devices=["cpu"] * 4, wire_format=wire,
                     wire_layout="irredundant")
        assert j.kernel_path == kernel
        vals = np.random.default_rng(93).random((16, 16, 16))
        j.load_interior(vals.astype(np.float32))
        j.run(steps)
        out[kernel, wire] = j.temperature()
    tol = steps * 8 * np.finfo(np.float32).eps
    assert np.abs(out["pallas", "bf16"] - out["xla", "bf16"]).max() <= tol
    assert np.abs(out["pallas", "bf16"] - out["pallas", "f32"]).max() > tol


# ---------------------------------------------------------------------------
# refusals, with JAX's exception types


def _both_raise(exc, make_jax, make_port, match=None):
    with reference_block_planner():
        with pytest.raises(exc, match=match):
            make_jax()
    with pytest.raises(exc, match=match):
        make_port()


@pytest.mark.parametrize("case", [
    "narrow+exchange_every", "narrow+overlap", "narrow+dma",
    "irredundant+halo", "irredundant+asym", "layout+dma", "unknown format",
    "unknown layout"])
def test_refusals_match_jax(case):
    def jacobi(package, **kw):
        if package == "jax":
            return JJacobi3D(16, 16, 16, mesh_shape=(1, 2, 2),
                             devices=jax.devices()[:4], **kw)
        return Jacobi3D(16, 16, 16, mesh_shape=(1, 2, 2),
                        devices=["cpu"] * 4, **kw)

    jm = {"dma": JMethod.PallasDMA}
    pm = {"dma": Method.PallasDMA}
    kw, exc, match = {
        "narrow+exchange_every": (dict(kernel="xla", wire_format="bf16",
                                       exchange_every=2),
                                  NotImplementedError, "exchange_every > 1"),
        "narrow+overlap": (dict(kernel="xla", wire_format="bf16",
                                overlap=True), NotImplementedError,
                           "overlap=True"),
        "narrow+dma": (dict(kernel="xla", wire_format="e4m3",
                            methods="dma"), NotImplementedError,
                       "PpermuteSlab and PpermutePacked"),
        "irredundant+halo": (dict(kernel="halo", wire_layout="irredundant"),
                             ValueError, "kernel='halo'"),
        "irredundant+asym": (dict(kernel="xla", wire_layout="irredundant",
                                  exchange_every={"z": 2}),
                             NotImplementedError, "asymmetric"),
        "layout+dma": (dict(kernel="xla", wire_layout="irredundant",
                            methods="dma"), NotImplementedError,
                       "PpermuteSlab and PpermutePacked"),
        "unknown format": (dict(kernel="xla", wire_format="fp16"),
                           ValueError, "unknown wire format"),
        "unknown layout": (dict(kernel="xla", wire_layout="packed"),
                           ValueError, "unknown wire layout"),
    }[case]
    jkw = dict(kw, methods=jm[kw["methods"]]) if "methods" in kw else kw
    pkw = dict(kw, methods=pm[kw["methods"]]) if "methods" in kw else kw
    _both_raise(exc, lambda: jacobi("jax", **jkw),
                lambda: jacobi("port", **pkw), match)


def test_wire_setters_refuse_after_realize_like_jax():
    jd = JDomain(16, 16, 16, devices=jax.devices()[:8])
    pd = DistributedDomain(16, 16, 16, devices=["cpu"] * 8)
    for d, dt in ((jd, np.float32), (pd, torch.float32)):
        d.set_mesh_shape((2, 2, 2))
        d.set_radius(1)
        d.add_data("q", dt)
        d.realize()
        with pytest.raises(AssertionError):
            d.set_wire_layout("irredundant")
        with pytest.raises(AssertionError):
            d.set_wire_format("bf16")


def test_temporal_engine_refuses_asymmetric_irredundant():
    from stencil_tpu_torch.parallel import temporal as pt

    fields = {"q": [torch.zeros((8, 8, 8)) for _ in range(4)]}
    with pytest.raises(NotImplementedError, match="asymmetric"):
        pt.temporal_shard_steps(fields, Radius.constant(1), Dim3(1, 2, 2),
                                Method.PpermuteSlab, lambda *a: {},
                                {"z": 2}, wire_layout="irredundant")


# ---------------------------------------------------------------------------
# make_exchange and its certificate


def _mesh(shape, n):
    return Mesh(shape, ["cpu"] * n)


SPEC = {"q": ((10, 10, 10), torch.float32)}


@pytest.mark.parametrize("fmt,bound,name", [
    ("bf16", 2.0 ** -8, "bfloat16"), ("e4m3", 2.0 ** -4, "float8_e4m3fn"),
    ("e5m2", 2.0 ** -3, "float8_e5m2")])
def test_make_exchange_certificate(fmt, bound, name):
    ex = px.make_exchange(_mesh((2, 2, 2), 8), Radius.constant(1),
                          wire_format=fmt, fields_spec=SPEC)
    cert = ex.precision_certificate
    assert cert.safe and not cert.reasons
    assert cert.max_rel_error_bound == bound
    assert cert.silent_converts == [] and cert.narrowest_accum is None
    assert {a: v["dtypes"] for a, v in cert.wire_dtypes.items()} == \
        {a: [name] for a in ("x", "y", "z")}
    assert all(v["link_class"] == "same-device" and v["declared"] == fmt
               for v in cert.wire_dtypes.values())
    assert ex.wire_format == {"x": fmt, "y": fmt, "z": fmt}
    assert ex.wire_layout == "slab"
    assert ex.precision_declaration == {"wire": ex.wire_format,
                                        "compute": "float32"}
    assert set(cert.to_dict()) == {
        "target", "wire_dtypes", "silent_converts", "narrowest_accum",
        "max_rel_error_bound", "safe", "reasons"}


def test_gate_probe_holds_no_storage(monkeypatch):
    """The gate's probe exchange moves "meta" tensors only: it costs no
    memory on the mesh's devices."""
    seen = []
    ship = px._ship

    def spy(src, device, *args, **kw):
        seen.append((src.device.type, torch.device(device).type))
        return ship(src, device, *args, **kw)

    monkeypatch.setattr(px, "_ship", spy)
    px.make_exchange(_mesh((2, 2, 2), 8), Radius.constant(1),
                     wire_format="bf16", fields_spec=SPEC)
    assert seen and set(seen) == {("meta", "meta")}


@pytest.mark.parametrize("layout,narrows", [("slab", {1}),
                                            ("irredundant", {1, 2, 3})])
def test_moves_are_planned_once(layout, narrows):
    """An exchange configuration is planned once and its moves reused;
    a slab box is one ``narrow`` of the shard, an irredundant box one to
    three."""
    args = ((12, 12, 12), Radius.constant(2), Radius.constant(2),
            Dim3(2, 2, 1), Dim3(0, 0, 0), (0, 1, 2), layout, False)
    moves = px._moves(*args)
    assert px._moves(*args) is moves
    assert [(a, side) for a, side, _ in moves] == [
        (0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]
    assert {len(box) for _, _, per in moves for dst, _, src in per
            for box in (dst, src)} == narrows


def test_make_exchange_matches_jax_certificate():
    """Per-axis dtypes, declared formats and bound equal JAX's
    certificate of the same exchange (its link classes name TPU links)."""
    fmt = {"y": "bf16", "z": "e5m2"}
    with reference_block_planner():
        jm = j_make_mesh((1, 2, 2), jax.devices()[:4])
        jex = jx.make_exchange(
            jm, JRadius.constant(1), wire_format=fmt,
            fields_spec={"q": jax.ShapeDtypeStruct((10, 20, 20),
                                                   np.float32)})
    pex = px.make_exchange(_mesh((1, 2, 2), 4), Radius.constant(1),
                           wire_format=fmt, fields_spec=SPEC)
    jc, pc = jex.precision_certificate, pex.precision_certificate
    assert pc.safe == jc.safe is True
    assert pc.max_rel_error_bound == jc.max_rel_error_bound == 2.0 ** -3
    assert {a: (v["dtypes"], v["declared"]) for a, v in
            pc.wire_dtypes.items()} == {
        a: (v["dtypes"], v["declared"]) for a, v in jc.wire_dtypes.items()}


def test_make_exchange_needs_fields_spec_and_f32_has_no_certificate():
    with pytest.raises(ValueError, match="fields_spec"):
        px.make_exchange(_mesh((2, 2, 2), 8), Radius.constant(1),
                         wire_format="bf16")
    ex = px.make_exchange(_mesh((2, 2, 2), 8), Radius.constant(1))
    assert ex.precision_certificate is None
    fields = {"q": [torch.rand((10, 10, 10)) for _ in range(8)]}
    assert ex(fields) is fields


def test_gate_refuses_an_engine_that_ships_the_wrong_dtype(monkeypatch):
    """A wire that does not narrow what it declares, or widens nothing
    back, is unsafe, and the gate raises."""
    monkeypatch.setattr(px, "_to_wire", lambda t, fmt: t)
    with pytest.raises(PrecisionGateError, match=r"\(b\) wire dtype"):
        px.make_exchange(_mesh((2, 2, 2), 8), Radius.constant(1),
                         wire_format="bf16", fields_spec=SPEC)
    monkeypatch.undo()
    monkeypatch.setattr(px, "_from_wire", lambda t, dtype: t)
    with pytest.raises(PrecisionGateError, match=r"\(c\)"):
        px.make_exchange(_mesh((2, 2, 2), 8), Radius.constant(1),
                         wire_format="bf16", fields_spec=SPEC)


def test_gate_refuses_a_method_that_cannot_narrow():
    with pytest.raises(PrecisionGateError, match="probe exchange failed"):
        px.make_exchange(_mesh((2, 2, 2), 8), Radius.constant(1),
                         methods=Method.AllGather, wire_format="bf16",
                         fields_spec=SPEC)
