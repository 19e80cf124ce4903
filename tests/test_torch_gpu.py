"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

Each kernel against its plain PyTorch twin on the card, at small odd
shapes, and the models' kernel paths against their plain ``xla`` paths.
Tolerances: 0 for the Jacobi kernels and laplace6 (they add and multiply
in their twins' order and are built -fmad=false); per field
``64 * eps(f32) * max |twin|`` for the MHD substep kernels (the same
order, but ``expf`` in the kernel and PyTorch's exp in the twin).
Without a CUDA device these skip. This file imports no JAX, so it runs
on a machine without it; there, skip the JAX-side ``tests/conftest.py``:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.local_domain import raw_size, zyx_shape
from stencil_tpu_torch.utils.timers import kernel_profile

pytestmark = pytest.mark.gpu

SHAPES = [(5, 8, 7), (9, 16, 13), (3, 8, 33), (1, 8, 1)]


@pytest.fixture
def cs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from stencil_tpu_torch.ops import _build, cuda_stencil

    try:
        _build.find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    return cuda_stencil


def _rand(shape, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.random(shape).astype(np.float32)).cuda()


@pytest.mark.parametrize("shape", SHAPES)
def test_wrap_kernels_equal_twins(cs, shape):
    t = _rand(shape, 31)
    Z, Y, X = shape
    hot, cold, r = (X // 3, Y // 2, Z // 2), (2 * X // 3, Y // 2, Z // 2), 2
    before = dict(cs.LAUNCHES)
    assert torch.equal(cs.jacobi7_wrap_cuda(t, hot, cold, r),
                       cs.jacobi7_wrap_plain(t, hot, cold, r))
    for n in (1, 2, 3, 8):
        assert torch.equal(cs.jacobi7_wrapn_cuda(t, hot, cold, r, steps=n),
                           cs.jacobi7_wrapn_plain(t, hot, cold, r, steps=n))
    assert cs.LAUNCHES["jacobi7_wrap"] == before["jacobi7_wrap"] + 1
    assert cs.LAUNCHES["jacobi7_wrapn"] == before["jacobi7_wrapn"] + 4


@pytest.mark.parametrize("asym", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_padded_kernel_equals_twin(cs, shape, asym):
    r = Radius.constant(1)
    if asym:
        r.set_dir((1, 0, 0), 2)
        r.set_dir((0, 0, -1), 3)
    interior = Dim3(shape[2], shape[1], shape[0])
    p = _rand(zyx_shape(raw_size(interior, r)), 32)
    assert torch.equal(cs.jacobi7_padded_cuda(p, r, interior),
                       cs.jacobi7_padded_plain(p, r, interior))


def test_wrapper_never_takes_a_cuda_tensor_to_the_twin(cs):
    t = _rand((4, 8, 4), 33).to(torch.float64)
    with pytest.raises(TypeError):
        cs.jacobi7_wrap_cuda(t, (1, 4, 2), (2, 4, 2), 1)
    with pytest.raises(ValueError, match="contiguous"):
        cs.jacobi7_wrap_cuda(_rand((4, 8, 8), 34)[:, :, ::2],
                             (1, 4, 2), (2, 4, 2), 1)


@pytest.mark.parametrize("kernel,iters", [("wrap", 5), ("pallas", 3)])
def test_paths_agree_with_plain_path(cs, kernel, iters):
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    cs.reset_launch_counts()
    j = Jacobi3D(24, 16, 20, kernel=kernel, device="cuda")
    ref = Jacobi3D(24, 16, 20, kernel="xla", device="cuda")
    for m in (j, ref):
        m.init()
        m.run(iters)
    eps = float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(j.temperature(), ref.temperature(), rtol=0,
                               atol=iters * 8 * eps)
    if kernel == "wrap":
        assert cs.LAUNCHES["jacobi7_wrapn"] == iters // 2
        assert cs.LAUNCHES["jacobi7_wrap"] == iters % 2
    else:
        assert cs.LAUNCHES["jacobi7_padded"] == iters


# shapes of K2 beyond SHAPES (X % 4 != 0 there, so 4-byte copies):
# X % 4 == 0 (16-byte copies), Y not a multiple of the tile's 32 rows,
# several tiles in x and y; the z runs come from the card's plan
RING_SHAPES = [(6, 16, 20), (7, 40, 68), (11, 8, 4), (23, 72, 132)]


def _ring_runs(cs, shape, steps):
    """The plan of a (Z, Y, X) shape on this card, and whether it splits
    z into runs with a shorter last one."""
    Z, Y, X = shape
    plan = cs.jacobi_ring_plan(Z, Y, X, steps, cs.sm_count(
        torch.device("cuda")))
    return plan, Z > plan.zrun and Z % plan.zrun != 0


@pytest.mark.parametrize("shape", RING_SHAPES + [(131, 64, 128)])
def test_wrapn_ring_kernel_equals_twin_across_tiles_and_runs(cs, shape):
    """K2 (the ring kernel with the field's own wrapped rows) bitwise
    its twin at N = 1, 2, 3, 8; (131, 64, 128) at N = 2 walks z in runs
    whose last one is shorter, and a field whose base is not 16-byte
    aligned takes the 4-byte copies although X % 4 == 0."""
    Z, Y, X = shape
    t = _rand(shape, 35)
    hot, cold, r = (X // 3, Y // 2, Z // 2), (2 * X // 3, Y // 2, Z // 2), 3
    for n in (1, 2, 3, 8):
        assert torch.equal(cs.jacobi7_wrapn_cuda(t, hot, cold, r, steps=n),
                           cs.jacobi7_wrapn_plain(t, hot, cold, r, steps=n))
    if shape == (131, 64, 128):
        assert _ring_runs(cs, shape, 2)[1]
    buf = _rand((t.numel() + 1,), 36)
    odd = buf[1:].view(shape)
    assert odd.data_ptr() % 16 != 0
    assert torch.equal(cs.jacobi7_wrapn_cuda(odd, hot, cold, r, steps=2),
                       cs.jacobi7_wrapn_plain(odd, hot, cold, r, steps=2))


@pytest.mark.parametrize("steps", range(1, 9))
def test_ring_plan_matches_the_card(cs, steps):
    """The planner's blocks an SM (shared memory and registers) are the
    card's: ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on K2's
    instantiation at the planned tile and depth."""
    ty, depth, bps = cs.ring_tile(steps)
    assert cs.ring_occupancy(torch.device("cuda"), steps, ty, depth) == bps


def _fresh_ptxas(lib, tmp_path, kernel):
    """Registers, spills and static shared memory of every instantiation
    of ``kernel`` in a fresh build of library ``lib``, built as the
    package builds it, from the ``-Xptxas=-v`` lines."""
    import subprocess

    from stencil_tpu_torch.ops import _build

    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
           str(tmp_path / f"lib{lib}.so"), str(_build.sources()[lib])]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True,
                         timeout=600)
    return {name: use for (_, name), use
            in _build.ptxas_usage(log.stdout + log.stderr, lib).items()
            if kernel in name}


@pytest.mark.parametrize("lib", ["jacobi7", "jacobi_halo"])
def test_jacobi_ring_kernel_fits_the_planners_registers_without_spills(
        cs, lib, tmp_path):
    """Every instantiation of the Jacobi ring kernel in each library (K2
    in ``jacobi7``, float32 and bfloat16; B6 in ``jacobi_halo``, float32
    and bfloat16 from the slabs and bfloat16 from the padded buffer of
    its second launch): at most the registers and exactly the static
    shared memory that the planner counts (``RING_REGISTERS``,
    ``RING_STATIC_BYTES``), and no spill."""
    usage = _fresh_ptxas(lib, tmp_path, "jacobi_ring_kernel")
    assert len(usage) == {"jacobi7": 2, "jacobi_halo": 3}[lib], usage
    for name, use in usage.items():
        assert use["registers"] <= cs.RING_REGISTERS, (name, use)
        assert use["static_smem"] == cs.RING_STATIC_BYTES, (name, use)
        assert (use["spill_stores"], use["spill_loads"]) == (0, 0), \
            (name, use)


# ---------------------------------------------------------------------------
# Astaroth MHD: B9/B10 (csrc/mhd.cu) and B8 (csrc/laplace6.cu)
# ---------------------------------------------------------------------------
MHD_SHAPES = [(8, 8, 8), (16, 8, 24), (8, 16, 40), (8, 8, 5)]
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def cm(cs):
    from stencil_tpu_torch.ops import cuda_mhd

    return cuda_mhd


def _mhd_state(shape, seed, w_scale=1e-3):
    """8 fields of sigma 0.1 and 8 w of sigma 0.1 * w_scale, float32 on
    the card, from a seeded numpy generator."""
    from stencil_tpu_torch.models.astaroth import FIELDS

    g = np.random.default_rng(seed)
    f = {q: torch.from_numpy(g.normal(0, 0.1, shape).astype(np.float32))
         .cuda() for q in FIELDS}
    w = {q: torch.from_numpy((g.normal(0, 0.1, shape) * w_scale)
                             .astype(np.float32)).cuda() for q in FIELDS}
    return f, w


def _assert_fields_close(got, want):
    """Per field: max |kernel - twin| <= 64 * eps(f32) * max |twin| (the
    kernels' expf and PyTorch's exp differ by an ulp, and the rates add
    many terms of either sign)."""
    assert set(got) == set(want)
    for q in want:
        err = float((got[q] - want[q]).abs().max())
        tol = 64 * EPS32 * float(want[q].abs().max())
        assert bool(torch.isfinite(got[q]).all()), q
        assert err <= tol, (q, err, tol)


@pytest.mark.parametrize("dt", [1e-8, 1e-4])
@pytest.mark.parametrize("shape", MHD_SHAPES)
def test_mhd_substep_kernel_matches_twin(cm, shape, dt):
    from stencil_tpu_torch.models.astaroth import MhdParams

    prm = MhdParams(dt=dt)
    f, w = _mhd_state(shape, 41)
    before = cm.LAUNCHES["mhd_substep_wrap"]
    for s, w_in, write_w in [(0, None, True), (1, w, True), (2, w, False),
                             (0, w, True), (2, w, True)]:
        kf, kw = cm.mhd_substep_wrap_cuda(f, w_in, s, prm, dt, write_w=write_w)
        tf, tw = cm.mhd_substep_wrap_plain(f, w_in, s, prm, dt,
                                           write_w=write_w)
        _assert_fields_close(kf, tf)
        if write_w:
            _assert_fields_close(kw, tw)
        else:
            assert kw is None and tw is None
    assert cm.LAUNCHES["mhd_substep_wrap"] == before + 5


@pytest.mark.parametrize("dt", [1e-8, 1e-4])
@pytest.mark.parametrize("shape", MHD_SHAPES)
def test_mhd_pair_kernel_matches_twin_and_two_substeps(cm, shape, dt):
    """B10 against its twin within the kernels' tolerance, and bitwise
    against B9 s=0 then B9 s=1, which is what it launches; one count a
    call."""
    from stencil_tpu_torch.models.astaroth import MhdParams

    prm = MhdParams(dt=dt)
    f, _ = _mhd_state(shape, 42)
    before = dict(cm.LAUNCHES)
    kf, kw = cm.mhd_substep01_wrap_cuda(f, prm, dt)
    tf, tw = cm.mhd_substep01_wrap_plain(f, prm, dt)
    _assert_fields_close(kf, tf)
    _assert_fields_close(kw, tw)
    f1, w1 = cm.mhd_substep_wrap_cuda(f, None, 0, prm, dt)
    f2, w2 = cm.mhd_substep_wrap_cuda(f1, w1, 1, prm, dt)
    for q in f:
        assert torch.equal(kf[q], f2[q]) and torch.equal(kw[q], w2[q]), q
    assert cm.LAUNCHES["mhd_substep01_wrap"] == before["mhd_substep01_wrap"] + 1
    assert cm.LAUNCHES["mhd_substep_wrap"] == before["mhd_substep_wrap"] + 2


def test_mhd_wrappers_never_take_a_cuda_tensor_to_the_twin(cm):
    from stencil_tpu_torch.models.astaroth import MhdParams

    f, w = _mhd_state((8, 8, 8), 43)
    f64 = {q: t.double() for q, t in f.items()}
    with pytest.raises(TypeError, match="float32"):
        cm.mhd_substep_wrap_cuda(f64, None, 0, MhdParams(), 1e-8)
    with pytest.raises(TypeError, match="float32"):
        cm.mhd_substep01_wrap_cuda(f64, MhdParams(), 1e-8)
    with pytest.raises(ValueError, match="alpha"):
        cm.mhd_substep_wrap_cuda(f, None, 1, MhdParams(), 1e-8)


# (Z, Y, X): small shapes (x not a multiple of 4 at 33), one smaller
# than a tile, z runs whose last one is shorter (131 on 132 SMs: runs of
# 2), Astaroth's per-rank grid and the timing app's ragged shape
LAPLACE6_SHAPES = [(8, 8, 8), (16, 8, 24), (5, 7, 33), (1, 8, 1),
                   (131, 64, 128), (256, 256, 256), (136, 128, 96)]
LAPLACE6_INV = (1 / 0.049, 1 / 0.05, 1 / 0.047)


@pytest.mark.parametrize("shape", LAPLACE6_SHAPES)
def test_laplace6_kernel_equals_twin(cs, shape):
    Z, Y, X = shape
    r = Radius.constant(3)
    interior = Dim3(X, Y, Z)
    p = _rand(zyx_shape(raw_size(interior, r)), 44)
    inv = LAPLACE6_INV
    before = cs.LAUNCHES["laplace6"]
    assert torch.equal(cs.laplace6_cuda(p, r, interior, inv),
                       cs.laplace6_plain(p, r, interior, inv))
    assert cs.LAUNCHES["laplace6"] == before + 1
    plan = cs.laplace6_plan(Z, Y, X, cs.sm_count(p.device))
    if shape == (131, 64, 128):
        assert Z > plan.zrun and Z % plan.zrun != 0
    if shape == (1, 8, 1):
        assert X < cs.RING_TILE_X and Y < cs.LAPLACE6_TY


def _laplace6_radius(lo_xyz):
    r = Radius.constant(3)
    for axis, v in enumerate(lo_xyz):
        d = [0, 0, 0]
        d[axis] = -1
        r.set_dir(tuple(d), v)
    return r


@pytest.mark.parametrize("lo,hi,offset,out_offset", [
    ((5, 4, 6), (4, 4, 3), 0, 0),    # Xp odd: 4-byte copies
    ((3, 3, 3), (3, 3, 3), 1, 0),    # rows on 4 bytes: 4-byte copies
    ((3, 5, 4), (5, 3, 3), 2, 0),    # odd low x pad, 8-byte copies
    ((4, 4, 4), (4, 4, 4), 0, 1),    # even low x pad: 4-byte copies
    ((6, 3, 5), (4, 4, 4), 2, 3),
])   # (x, y, z)
def test_laplace6_kernel_equals_twin_on_wide_and_unaligned_pads(
        cs, lo, hi, offset, out_offset):
    """Low pads above 3, padded rows that start on 4 or 8 bytes, each
    copy width, and outputs that start off 16 bytes (X = 70 takes 4-byte
    stores), over several tiles and z runs: bitwise, one launch a
    call."""
    X, Y, Z = 70, 37, 29
    shape = (Z + lo[2] + hi[2], Y + lo[1] + hi[1], X + lo[0] + hi[0])
    n = shape[0] * shape[1] * shape[2]
    p = _rand((n + offset,), 45)[offset:].view(shape)
    out = torch.full((Z * Y * X + out_offset,), float("nan"),
                     device="cuda")[out_offset:].view(Z, Y, X)
    r = _laplace6_radius(lo)
    before = cs.LAUNCHES["laplace6"]
    got = cs.laplace6_cuda(p, r, Dim3(X, Y, Z), LAPLACE6_INV, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, cs.laplace6_plain(p, r, Dim3(X, Y, Z),
                                              LAPLACE6_INV))
    assert cs.LAUNCHES["laplace6"] == before + 1


def test_laplace6_plan_matches_the_card(cs):
    """The planner's blocks an SM (shared memory and registers) are the
    card's: ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on B8's
    kernel."""
    assert cs.laplace6_occupancy(torch.device("cuda")) \
        == cs.laplace6_blocks_per_sm()


def test_laplace6_kernel_fits_the_planners_registers_without_spills(
        cs, tmp_path):
    """Every instantiation of B8's kernel (copy width, store width): at
    most the registers the planner counts (``LAPLACE6_REGISTERS``), no
    spill and no static shared memory."""
    usage = _fresh_ptxas("laplace6", tmp_path, "laplace6_ring_kernel")
    assert len(usage) == 4, usage   # 2 copy widths x 2 store widths
    for name, use in usage.items():
        assert use["registers"] <= cs.LAPLACE6_REGISTERS, (name, use)
        assert (use["spill_stores"], use["spill_loads"]) == (0, 0), \
            (name, use)
        assert use.get("static_smem", 0) == 0, (name, use)


@pytest.mark.parametrize("pair", ["0", "1"])
def test_astaroth_wrap_path_agrees_with_plain_path(cm, monkeypatch, pair):
    """Two iterations at 16 x 16 x 24 with dt = 1e-4: the wrap path
    (kernels) against the xla path (plain PyTorch), per field within
    substeps * 64 * eps(f32) * max|xla|; launch counts as the JAX
    model's grouping gives them."""
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth, MhdParams

    monkeypatch.setenv("STENCIL_MHD_PAIR", pair)
    prm = MhdParams(dt=1e-4)
    m = Astaroth(24, 16, 16, params=prm, kernel="auto", device="cuda")
    ref = Astaroth(24, 16, 16, params=prm, kernel="xla", device="cuda")
    assert m.kernel_path == "wrap"
    cm.reset_launch_counts()
    for a in (m, ref):
        a.init()
        a.run(2)
    halo = {"mhd_substep_halo": 0, "mhd_substep01_halo": 0}
    if pair == "1":
        assert cm.LAUNCHES == dict(halo, mhd_substep_wrap=2,
                                   mhd_substep01_wrap=2)
    else:
        assert cm.LAUNCHES == dict(halo, mhd_substep_wrap=6,
                                   mhd_substep01_wrap=0)
    for q in FIELDS:
        got, want = m.field(q), ref.field(q)
        assert np.isfinite(got).all(), q
        assert np.abs(got - want).max() <= 6 * 64 * EPS32 * np.abs(want).max(), q


# ---------------------------------------------------------------------------
# the MHD halo path: B11/B12 (csrc/mhd.cu) on slabs of meshes of shards
# ---------------------------------------------------------------------------
def _mhd_mesh(size_zyx, mesh, seed, device="cuda"):
    """(8, Z, Y, X) shards (sigma 0.1) and w (sigma 1e-4) of an
    x-unsharded mesh, float32, from a seeded numpy generator."""
    g = np.random.default_rng(seed)
    Z, Y, X = size_zyx
    lz, ly = Z // mesh[2], Y // mesh[1]
    n = mesh[1] * mesh[2]
    f = [torch.from_numpy(g.normal(0, 0.1, (8, lz, ly, X)).astype(np.float32))
         .to(device) for _ in range(n)]
    w = [torch.from_numpy(g.normal(0, 1e-4, (8, lz, ly, X))
                          .astype(np.float32)).to(device) for _ in range(n)]
    return f, w


def _fields(t):
    from stencil_tpu_torch.models.astaroth import FIELDS

    return dict(zip(FIELDS, t.unbind(0)))


def _mhd_slabs(shards, mesh, **kw):
    from stencil_tpu_torch.models.astaroth import FIELDS
    from stencil_tpu_torch.parallel.exchange import exchange_interior_slabs

    return [{q: {k: v[j] for k, v in sl.items()} for j, q in enumerate(FIELDS)}
            for sl in exchange_interior_slabs(shards, Dim3(*mesh),
                                              y_z_extended=True, **kw)]


@pytest.mark.parametrize("layout", ["jax", "exact"])
@pytest.mark.parametrize("size,mesh", [((16, 8, 16), (1, 1, 1)),
                                       ((16, 16, 24), (1, 2, 2)),
                                       ((32, 16, 5), (1, 2, 4))])
def test_mhd_halo_kernels_match_twins(cm, size, mesh, layout):
    from stencil_tpu_torch.models.astaroth import MhdParams

    kw11, kw12 = ((dict(rz=8, ry=8, radius_rows=3),
                   dict(rz=8, ry=8, radius_rows=6)) if layout == "jax"
                  else (dict(rz=3, ry=3), dict(rz=6, ry=6)))
    shards, ws = _mhd_mesh(size, mesh, 45)
    sl11, sl12 = _mhd_slabs(shards, mesh, **kw11), _mhd_slabs(shards, mesh,
                                                              **kw12)
    before = dict(cm.LAUNCHES)
    for dt in (1e-8, 1e-4):
        prm = MhdParams(dt=dt)
        for t, w, s11, s12 in zip(shards, ws, sl11, sl12):
            f, w = _fields(t), _fields(w)
            for s, w_in, write_w in [(0, None, True), (1, w, True),
                                     (2, w, False), (0, w, True),
                                     (2, w, True)]:
                kf, kw = cm.mhd_substep_halo_cuda(f, w_in, s11, s, prm, dt,
                                                  write_w=write_w)
                tf, tw = cm.mhd_substep_halo_plain(f, w_in, s11, s, prm, dt,
                                                   write_w=write_w)
                _assert_fields_close(kf, tf)
                if write_w:
                    _assert_fields_close(kw, tw)
                else:
                    assert kw is None and tw is None
            kf, kw = cm.mhd_substep01_halo_cuda(f, s12, prm, dt)
            tf, tw = cm.mhd_substep01_halo_plain(f, s12, prm, dt)
            _assert_fields_close(kf, tf)
            _assert_fields_close(kw, tw)
    n = len(shards)
    assert cm.LAUNCHES["mhd_substep_halo"] == before["mhd_substep_halo"] + 10 * n
    assert (cm.LAUNCHES["mhd_substep01_halo"]
            == before["mhd_substep01_halo"] + 2 * n)


@pytest.mark.parametrize("layout", ["jax", "exact"])
@pytest.mark.parametrize("size,mesh", [((16, 8, 16), (1, 1, 1)),
                                       ((16, 16, 24), (1, 2, 2)),
                                       ((32, 16, 40), (1, 2, 4)),
                                       ((512, 256, 256), (1, 1, 2)),
                                       ((272, 256, 96), (1, 2, 2))])
def test_b12_is_bitwise_b11_then_a_slab_round_then_b11(cm, size, mesh,
                                                       layout):
    """B12 on slabs of 2R rows (JAX's layout, rz = ry = 8, or the path's
    exact rows) equals B11 s=0, a radius-R slab round and B11 s=1 bit for
    bit — on (1,1,1), (1,2,2) and (1,2,4) meshes of small shards (x not a
    multiple of the 32-wide tile, y below its 16 rows), on two 256^3
    shards and on four 136 x 128 x 96 shards, where ``ring_zrun`` splits
    z. One count a call."""
    from stencil_tpu_torch.models.astaroth import FIELDS, MhdParams

    kw12 = (dict(rz=8, ry=8, radius_rows=6) if layout == "jax"
            else dict(rz=6, ry=6))
    shards, _ = _mhd_mesh(size, mesh, 47)
    prm = MhdParams(dt=1e-4)
    one = [cm.mhd_substep_halo_cuda(_fields(t), None, sl, 0, prm, 1e-4)
           for t, sl in zip(shards, _mhd_slabs(shards, mesh, rz=3, ry=3))]
    f1 = [torch.stack([f[q] for q in FIELDS]) for f, _ in one]
    sl1 = _mhd_slabs(f1, mesh, rz=3, ry=3)
    sl12 = _mhd_slabs(shards, mesh, **kw12)
    before = cm.LAUNCHES["mhd_substep01_halo"]
    for i, t in enumerate(shards):
        f2, w2 = cm.mhd_substep_halo_cuda(_fields(f1[i]), one[i][1], sl1[i],
                                          1, prm, 1e-4)
        kf, kw = cm.mhd_substep01_halo_cuda(_fields(t), sl12[i], prm, 1e-4)
        for q in FIELDS:
            assert torch.equal(kf[q], f2[q]), (i, q)
            assert torch.equal(kw[q], w2[q]), (i, q)
    assert cm.LAUNCHES["mhd_substep01_halo"] == before + len(shards)


@pytest.mark.parametrize("lib", ["mhd", "mhd_overlap"])
def test_margin_kernel_holds_128_registers_without_spills(cs, lib, tmp_path):
    """The margin kernel (``csrc/mhd_margin.cuh`` ``mhd_margin_kernel``:
    both instances of the ring behind one uniform branch), as B12 in
    ``mhd`` and B14's pair in ``mhd_overlap`` build it, built as the
    package builds it: at most 128 registers a thread and no spill, in
    both its instantiations (float32 and bfloat16 shards)."""
    usage = _fresh_ptxas(lib, tmp_path, "mhd_margin_kernel")
    assert len(usage) == 2, usage      # the shard's storage type
    for name, use in usage.items():
        assert use["registers"] <= 128, (name, use)
        assert (use["spill_stores"], use["spill_loads"]) == (0, 0), \
            (name, use)


B11_VARIANTS = [(0, False, True), (1, True, True), (2, True, False),
                (0, True, True), (2, True, True)]


@pytest.mark.parametrize("shape", MHD_SHAPES + [(136, 128, 96)])
def test_mhd_halo_kernels_on_one_shard_equal_the_wrap_kernels(cm, shape):
    """On a (1,1,1) mesh the slabs are the shard's own wrapped rows: B11
    computes B9's values (one kernel body, ``csrc/mhd_ring.cuh``, that
    differs only in where a margin row comes from) for every (s, read_w,
    write_w), and B12 B10's, bit for bit — at shapes with x below the
    ring's 32-wide tile and y below its 16 rows, and at 136 x 128 x 96,
    where ``ring_zrun`` splits z into runs, the last one shorter."""
    from stencil_tpu_torch.models.astaroth import MhdParams

    (t,), (wt,) = _mhd_mesh(shape, (1, 1, 1), 46)
    f, w, prm = _fields(t), _fields(wt), MhdParams(dt=1e-4)
    (s3,), (s6,) = (_mhd_slabs([t], (1, 1, 1), rz=3, ry=3),
                    _mhd_slabs([t], (1, 1, 1), rz=6, ry=6))
    if shape == (136, 128, 96):
        assert shape[0] % cm.ring_zrun(*shape, cm.sm_count(t.device))
    pairs = [(cm.mhd_substep01_halo_cuda(f, s6, prm, 1e-4),
              cm.mhd_substep01_wrap_cuda(f, prm, 1e-4))]
    for s, read_w, write_w in B11_VARIANTS:
        w_in = w if read_w else None
        pairs.append((cm.mhd_substep_halo_cuda(f, w_in, s3, s, prm, 1e-4,
                                               write_w=write_w),
                      cm.mhd_substep_wrap_cuda(f, w_in, s, prm, 1e-4,
                                               write_w=write_w)))
    for got, want in pairs:
        assert (got[1] is None) == (want[1] is None)
        for q in f:
            assert torch.equal(got[0][q], want[0][q]), q
            if want[1] is not None:
                assert torch.equal(got[1][q], want[1][q]), q


@pytest.mark.parametrize("lib", ["mhd", "mhd_overlap"])
def test_ring_kernel_holds_128_registers_without_spills(cs, lib, tmp_path):
    """Every instantiation of the ring kernel (B9 and B11 in ``mhd``,
    B13's interior in ``mhd_overlap``), built as the package builds it:
    at most 128 registers a thread (one 512-thread block an SM) and no
    spill, from the ``-Xptxas=-v`` lines."""
    usage = _fresh_ptxas(lib, tmp_path, "mhd_substep_ring_kernel")
    # (read_w, write_w) for float32 and for bfloat16 storage, and the
    # bf16 pair's bf16 -> float32 substep 0 and float32 -> bf16 substep 1
    assert len(usage) == 10, usage
    for name, use in usage.items():
        assert use["registers"] <= 128, (name, use)
        assert (use["spill_stores"], use["spill_loads"]) == (0, 0), \
            (name, use)


@pytest.mark.parametrize("size,mesh", [((256, 256, 256), (1, 1, 1)),
                                       ((512, 512, 256), (1, 2, 2)),
                                       ((1024, 512, 256), (1, 2, 4)),
                                       ((24, 16, 40), (1, 1, 1)),
                                       ((48, 16, 24), (1, 2, 2)),
                                       ((64, 16, 40), (1, 2, 4))])
def test_b11_is_bitwise_its_twin_without_a_window(cm, monkeypatch, size,
                                                  mesh):
    """B11, every (s, read_w, write_w), bitwise equal to its twin on the
    halo path's exact slabs — at 256^3 a shard and at shapes whose x is
    not a multiple of the 32-wide tile — and on a (1,1,1) mesh also to
    B9. One launch, and no
    window: the call allocates nothing but its outputs."""
    from stencil_tpu_torch.models.astaroth import MhdParams

    shards, ws = _mhd_mesh(size, mesh, 47)
    sl = _mhd_slabs(shards, mesh, rz=3, ry=3)
    prm = MhdParams(dt=1e-4)
    picks = range(len(shards)) if size[2] < 256 else (0, len(shards) - 1)
    for i in picks:
        f, w = _fields(shards[i]), _fields(ws[i])
        for s, read_w, write_w in B11_VARIANTS:
            w_in = w if read_w else None
            out_f = {q: torch.empty_like(t) for q, t in f.items()}
            out_w = ({q: torch.empty_like(t) for q, t in f.items()}
                     if write_w else None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            before = cm.LAUNCHES["mhd_substep_halo"]
            kf, kw = cm.mhd_substep_halo_cuda(f, w_in, sl[i], s, prm, 1e-4,
                                              write_w=write_w, out_f=out_f,
                                              out_w=out_w)
            torch.cuda.synchronize()
            assert cm.LAUNCHES["mhd_substep_halo"] == before + 1
            assert torch.cuda.max_memory_allocated() - base < 2 ** 20
            tf, tw = cm.mhd_substep_halo_plain(f, w_in, sl[i], s, prm, 1e-4,
                                               write_w=write_w)
            for q in tf:
                assert torch.equal(kf[q], tf[q]), (i, s, q)
                if write_w:
                    assert torch.equal(kw[q], tw[q]), (i, s, q)
            assert (kw is None) == (not write_w)
            if mesh == (1, 1, 1):
                bf, bw = cm.mhd_substep_wrap_cuda(f, w_in, s, prm, 1e-4,
                                                  write_w=write_w)
                for q in bf:
                    assert torch.equal(kf[q], bf[q]), (s, q)
                    if write_w:
                        assert torch.equal(kw[q], bw[q]), (s, q)
            del kf, kw, tf, tw
        torch.cuda.empty_cache()


def test_b11_z_runs_are_bitwise_its_twin(cm):
    """(136, 128, 96) shards on (1,2,2): the tiles alone leave most SMs
    idle, so ``ring_zrun`` splits z into runs (on 132 SMs five of 28
    planes, the last one 24); every (s, read_w, write_w) is still bitwise
    equal to the twin."""
    from stencil_tpu_torch.models.astaroth import MhdParams

    shards, ws = _mhd_mesh((272, 256, 96), (1, 2, 2), 48)
    zrun = cm.ring_zrun(136, 128, 96, cm.sm_count(shards[0].device))
    assert zrun < 136
    sl = _mhd_slabs(shards, (1, 2, 2), rz=3, ry=3)
    prm = MhdParams(dt=1e-4)
    for i in range(len(shards)):
        f, w = _fields(shards[i]), _fields(ws[i])
        for s, read_w, write_w in B11_VARIANTS:
            w_in = w if read_w else None
            kf, kw = cm.mhd_substep_halo_cuda(f, w_in, sl[i], s, prm, 1e-4,
                                              write_w=write_w)
            tf, tw = cm.mhd_substep_halo_plain(f, w_in, sl[i], s, prm, 1e-4,
                                               write_w=write_w)
            for q in tf:
                assert torch.equal(kf[q], tf[q]), (i, s, q)
                if write_w:
                    assert torch.equal(kw[q], tw[q]), (i, s, q)


@pytest.mark.parametrize("kernel,mesh", [("wrap", (1, 1, 1)),
                                         ("halo", (1, 1, 1)),
                                         ("halo", (1, 2, 2))])
def test_astaroth_pair_equals_single_substeps(cm, monkeypatch, kernel, mesh):
    """24 x 16 x 32 (x, y, z), two iterations at dt = 1e-4: each path with
    the pair (B10 or B12 for substeps 0 and 1) equals the same path
    without it bitwise, fields and carried w, on one shard and on four
    that share the card."""
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth, MhdParams

    prm = MhdParams(dt=1e-4)
    n = mesh[1] * mesh[2]
    got = []
    for pair in ("1", "0"):
        monkeypatch.setenv("STENCIL_MHD_PAIR", pair)
        m = Astaroth(24, 16, 32, params=prm, kernel=kernel, mesh_shape=mesh,
                     devices=["cuda:0"] * n)
        assert m.kernel_path == kernel
        cm.reset_launch_counts()
        m.init()
        m.run(2)
        pairs = cm.LAUNCHES[f"mhd_substep01_{kernel}"]
        assert pairs == (2 * n if pair == "1" else 0), cm.LAUNCHES
        got.append(m)
    for q in FIELDS:
        np.testing.assert_array_equal(got[0].field(q), got[1].field(q))
        np.testing.assert_array_equal(got[0].accumulator(q),
                                      got[1].accumulator(q))


@pytest.mark.parametrize("pair", ["0", "1"])
@pytest.mark.parametrize("mesh", [(1, 1, 1), (1, 2, 2)])
def test_astaroth_halo_path_equals_wrap_path(cm, monkeypatch, mesh, pair):
    """24 x 16 x 32 (x, y, z), two iterations at dt = 1e-4: the halo path
    on one shard, and on four shards that share the card, equals the wrap
    path bitwise (fields and carried w); 3 launches per shard an
    iteration (B12 + B11 with the pair)."""
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth, MhdParams

    monkeypatch.setenv("STENCIL_MHD_PAIR", pair)
    prm = MhdParams(dt=1e-4)
    n = mesh[1] * mesh[2]
    # auto takes halo on a mesh of more than one shard
    h = Astaroth(24, 16, 32, params=prm, kernel="halo" if n == 1 else "auto",
                 mesh_shape=mesh, devices=["cuda:0"] * n)
    w = Astaroth(24, 16, 32, params=prm, kernel="wrap", device="cuda")
    assert h.kernel_path == "halo"
    cm.reset_launch_counts()
    h.init()
    h.run(2)
    want = ({"mhd_substep_halo": 2 * n, "mhd_substep01_halo": 2 * n}
            if pair == "1" else {"mhd_substep_halo": 6 * n,
                                 "mhd_substep01_halo": 0})
    assert cm.LAUNCHES == dict(want, mhd_substep_wrap=0, mhd_substep01_wrap=0)
    w.init()
    w.run(2)
    for q in FIELDS:
        np.testing.assert_array_equal(h.field(q), w.field(q))
        np.testing.assert_array_equal(h.accumulator(q), w.accumulator(q))


# ---------------------------------------------------------------------------
# the halo path: B5/B6 (csrc/jacobi_halo.cu) on slabs of meshes of shards
# ---------------------------------------------------------------------------
@pytest.fixture
def ch(cs):
    from stencil_tpu_torch.ops import cuda_halo

    return cuda_halo


def _halo_case(size_xyz, mesh, slab_kw, seed, dtype=torch.float32):
    """Random capacity shards of a grid over a mesh on the card, their
    slabs, and per shard its origin (z, y, x) and live (z, y) extents."""
    from stencil_tpu_torch.parallel.exchange import (exchange_interior_slabs,
                                                     shard_interior_len,
                                                     shard_origin)
    from stencil_tpu_torch.parallel.mesh import mesh_index

    size, counts = Dim3(*size_xyz), Dim3(*mesh)
    cap = Dim3(*(-(-size[a] // counts[a]) for a in range(3)))
    rem = Dim3(*(size[a] % counts[a] for a in range(3)))
    shards = [_rand((cap.z, cap.y, cap.x), seed + i).to(dtype)
              for i in range(counts.flatten())]
    kw = dict(slab_kw)
    if not kw.get("y_z_extended"):
        kw["rem"] = rem
    slabs = exchange_interior_slabs(shards, counts, **kw)
    meta = []
    for i in range(len(shards)):
        idx = mesh_index(i, counts)
        ox, oy, oz = shard_origin(cap, rem, idx)
        meta.append(((oz, oy, ox), (shard_interior_len(2, cap.z, rem, idx.z),
                                    shard_interior_len(1, cap.y, rem, idx.y))))
    X, Y, Z = size_xyz
    spheres = (X // 3, Y // 2, Z // 2), (2 * X // 3, Y // 2, Z // 2), 3
    return shards, slabs, meta, spheres, (Z, Y, X)


@pytest.mark.parametrize("size,mesh,kw", [
    ((7, 8, 5), (1, 1, 1), dict(rz=1, ry=8)),
    ((13, 17, 9), (1, 2, 2), dict(rz=1, ry=1)),        # uneven y and z
    ((33, 16, 11), (1, 2, 2), dict(rz=1, ry=8)),       # uneven z
    ((33, 13, 9), (1, 1, 1), dict(rz=3, ry=8, radius_rows=1)),
])
def test_halo_kernel_equals_twin(ch, size, mesh, kw):
    shards, slabs, meta, (hot, cold, r), _ = _halo_case(size, mesh, kw, 61)
    before = ch.LAUNCHES["jacobi7_halo"]
    for t, sl, (org, lens) in zip(shards, slabs, meta):
        assert torch.equal(
            ch.jacobi7_halo_cuda(t, sl, org, hot, cold, r,
                                 interior_len_zy=lens),
            ch.jacobi7_halo_plain(t, sl, org, hot, cold, r, lens))
    assert ch.LAUNCHES["jacobi7_halo"] == before + len(shards)


@pytest.mark.parametrize("steps,rz", [(1, 1), (2, 2), (2, 4), (3, 3), (8, 8)])
@pytest.mark.parametrize("size,mesh", [((7, 16, 20), (1, 1, 1)),
                                       ((33, 16, 24), (1, 2, 2)),
                                       ((5, 40, 32), (1, 1, 4))])
def test_halon_kernel_equals_twin(ch, size, mesh, steps, rz):
    kw = dict(rz=rz, ry=8, radius_rows=steps, y_z_extended=True)
    shards, slabs, meta, (hot, cold, r), gsize = _halo_case(size, mesh, kw, 62)
    for t, sl, (org, _) in zip(shards, slabs, meta):
        assert torch.equal(
            ch.jacobi7_halon_cuda(t, sl, org, gsize, hot, cold, r,
                                  steps=steps),
            ch.jacobi7_halon_plain(t, sl, org, gsize, hot, cold, r,
                                   steps=steps))


@pytest.mark.parametrize("steps", [1, 2, 3, 8])
@pytest.mark.parametrize("layout", ["path", "jax"])
@pytest.mark.parametrize("mesh", [(1, 1, 1), (1, 2, 2), (1, 2, 4)])
@pytest.mark.parametrize("size", [(20, 48, 64), (13, 40, 48)])
def test_halon_ring_kernel_equals_twin_on_both_slab_layouts(ch, size, mesh,
                                                            layout, steps):
    """B6 (the ring kernel with rows from the shard and its slabs)
    bitwise its twin on the halo path's own slabs (rz = ry = N) and on
    JAX-style ones (rz = 8, ry = 8), x a multiple of 4 (16-byte copies)
    or not; on (1,1,1) it also equals K2 bitwise (its slabs are the
    shard's own wrapped rows)."""
    from stencil_tpu_torch.ops import cuda_stencil as cs

    rz, ry = (steps, steps) if layout == "path" else (8, 8)
    kw = dict(rz=rz, ry=ry, radius_rows=steps, y_z_extended=True)
    shards, slabs, meta, (hot, cold, r), gsize = _halo_case(size, mesh, kw,
                                                            64)
    for t, sl, (org, _) in zip(shards, slabs, meta):
        got = ch.jacobi7_halon_cuda(t, sl, org, gsize, hot, cold, r,
                                    steps=steps)
        assert torch.equal(got, ch.jacobi7_halon_plain(
            t, sl, org, gsize, hot, cold, r, steps=steps))
        if mesh == (1, 1, 1) and t.shape[1] % 8 == 0:
            assert torch.equal(got, cs.jacobi7_wrapn_cuda(t, hot, cold, r,
                                                          steps=steps))


def test_halon_ring_kernel_runs_with_a_shorter_last_run(ch):
    """Quarter shards (Z, Y, X) = (131, 64, 128) of 128 x 128 x 262 (x y
    z) over (1,2,2): four tiles a plane, so the plan walks z in short
    runs whose last is shorter; B6 stays bitwise its twin there."""
    from stencil_tpu_torch.ops import cuda_stencil as cs

    size, mesh = (128, 128, 262), (1, 2, 2)
    kw = dict(rz=2, ry=2, radius_rows=2, y_z_extended=True)
    shards, slabs, meta, (hot, cold, r), gsize = _halo_case(size, mesh, kw,
                                                            65)
    plan, uneven = _ring_runs(cs, tuple(shards[0].shape), 2)
    assert uneven, plan
    for t, sl, (org, _) in zip(shards, slabs, meta):
        assert torch.equal(
            ch.jacobi7_halon_cuda(t, sl, org, gsize, hot, cold, r, steps=2),
            ch.jacobi7_halon_plain(t, sl, org, gsize, hot, cold, r, steps=2))


def test_halo_wrappers_never_take_a_cuda_tensor_to_the_twin(ch):
    shards, slabs, meta, (hot, cold, r), _ = _halo_case(
        (8, 8, 8), (1, 1, 1), dict(rz=1, ry=8), 63)
    t, sl = shards[0], slabs[0]
    with pytest.raises(TypeError, match="float32"):
        ch.jacobi7_halo_cuda(t.double(), {k: v.double() for k, v in sl.items()},
                             meta[0][0], hot, cold, r)
    with pytest.raises(ValueError, match="on"):
        ch.jacobi7_halo_cuda(t, {k: v.cpu() for k, v in sl.items()},
                             meta[0][0], hot, cold, r)


@pytest.mark.parametrize("mesh", [(1, 1, 1), (1, 2, 2)])
def test_halo_path_equals_wrap_path(ch, mesh):
    """64^3, run(5): the halo path on one shard, and on four shards that
    share the card, equals the wrap path bitwise; 2 B6 + 1 B5 launches
    per shard."""
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    n = mesh[1] * mesh[2]
    h = Jacobi3D(64, 64, 64, kernel="halo", mesh_shape=mesh,
                 devices=["cuda:0"] * n)
    w = Jacobi3D(64, 64, 64, kernel="wrap", device="cuda")
    ch.reset_launch_counts()
    for m in (h, w):
        m.init()
        m.run(5)
    assert ch.LAUNCHES == {"jacobi7_halo": n, "jacobi7_halon": 2 * n}
    np.testing.assert_array_equal(h.temperature(), w.temperature())


# ---------------------------------------------------------------------------
# shards on distinct cards: every kernel launches on its tensors' device
# ---------------------------------------------------------------------------
def test_kernels_launch_on_their_tensors_device_and_stream(ch, monkeypatch):
    """Each launch asks for the current stream OF ITS TENSORS' DEVICE and
    makes that device current, whatever device is current before it."""
    seen = []
    real = torch.cuda.current_stream

    def spy(device=None):
        seen.append((device, torch.cuda.current_device()))
        return real(device)

    monkeypatch.setattr(torch.cuda, "current_stream", spy)
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    t = _rand((8, 8, 8), 64).to(dev)
    slabs = {k: v.to(dev) for k, v in
             _halo_case((8, 8, 8), (1, 1, 1), dict(rz=1, ry=1), 64)[1][0]
             .items()}
    from stencil_tpu_torch.ops import cuda_stencil

    with torch.cuda.device(0):
        ch.jacobi7_halo_cuda(t, slabs, (0, 0, 0), (2, 4, 4), (5, 4, 4), 1)
        cuda_stencil.jacobi7_wrap_cuda(t, (2, 4, 4), (5, 4, 4), 1)
    assert seen == [(dev, dev.index)] * 2


def test_mhd_halo_kernels_launch_on_each_shards_device_and_stream(
        cm, monkeypatch):
    """B11 and B12 launch on the device of their shard and on that
    device's current stream, shard by shard, whatever device is current
    (with one card every shard is on it)."""
    from stencil_tpu_torch.models.astaroth import MhdParams

    n_dev = torch.cuda.device_count()
    devs = [torch.device("cuda", (n_dev - 1 - i) % n_dev) for i in range(4)]
    shards, _ = _mhd_mesh((16, 16, 8), (1, 2, 2), 47)
    shards = [t.to(d) for t, d in zip(shards, devs)]
    s3 = _mhd_slabs(shards, (1, 2, 2), rz=3, ry=3)
    s6 = _mhd_slabs(shards, (1, 2, 2), rz=6, ry=6)
    seen = []
    real = torch.cuda.current_stream

    def spy(device=None):
        seen.append((device, torch.cuda.current_device()))
        return real(device)

    monkeypatch.setattr(torch.cuda, "current_stream", spy)
    prm = MhdParams()
    with torch.cuda.device(0):
        for t, a, b in zip(shards, s3, s6):
            cm.mhd_substep_halo_cuda(_fields(t), None, a, 0, prm, 1e-8)
            cm.mhd_substep01_halo_cuda(_fields(t), b, prm, 1e-8)
    assert seen == [(d, d.index) for d in devs for _ in range(2)]


def _distinct_cards():
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA GPUs")
    # shard 0 on the last card, so that the current device (0) is not
    # the one that holds the first shard
    return [f"cuda:{n - 1 - i % n}" for i in range(4)]


@pytest.mark.parametrize("kernel,mesh", [("halo", (1, 2, 2)),
                                         ("xla", (2, 2, 1)),
                                         ("pallas", (2, 2, 1))])
def test_paths_on_distinct_cards_equal_one_card(ch, kernel, mesh):
    """128^3, run(9): four shards over distinct cards equal the same four
    shards on one card bitwise (the same arithmetic; only the placement,
    and so the cross-device copies and launches, differ)."""
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    devs = _distinct_cards()
    runs = []
    for devices in (devs, ["cuda:0"] * 4):
        m = Jacobi3D(128, 128, 128, kernel=kernel, mesh_shape=mesh,
                     devices=devices)
        assert [d.index for d in m.dd.mesh.devices] == \
            [torch.device(d).index for d in devices]
        m.init()
        m.run(9)
        runs.append(m.temperature())
    np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.parametrize("method", ["PpermuteSlab", "PpermutePacked"])
def test_narrowed_irredundant_exchange_on_distinct_cards_equals_one_card(
        cs, method):
    """A bf16 irredundant exchange of two quantities on uneven shards
    over distinct cards equals the same exchange on one card bitwise:
    each message narrows on its sender's card, crosses at bf16 (the
    precision certificate's record) and widens on the receiver's."""
    from stencil_tpu_torch.distributed import DistributedDomain
    from stencil_tpu_torch.parallel.methods import Method

    devs = _distinct_cards()
    runs = []
    for devices in (devs, ["cuda:0"] * 4):
        dd = DistributedDomain(67, 66, 33, devices=devices)
        dd.set_mesh_shape((2, 2, 1))
        dd.set_radius(2)
        dd.set_methods(Method[method])
        dd.set_wire_format("bf16")
        dd.set_wire_layout("irredundant")
        for q in ("a", "b"):
            dd.add_data(q, torch.float32)
        dd.realize()
        cert = dd.precision_certificate
        assert cert.safe and cert.max_rel_error_bound == 2.0 ** -8
        assert {v["dtypes"][0] for v in cert.wire_dtypes.values()} == \
            {"bfloat16"}
        rng = np.random.default_rng(37)
        for q in ("a", "b"):
            for t in dd.curr[q]:
                t.copy_(torch.from_numpy(rng.standard_normal(
                    tuple(t.shape)).astype(np.float32) * 500))
        dd.exchange()
        runs.append({q: [t.cpu().view(torch.int32) for t in dd.curr[q]]
                     for q in ("a", "b")})
    for q in ("a", "b"):
        for x, y in zip(runs[0][q], runs[1][q]):
            assert torch.equal(x, y)


def test_default_devices_spread_the_halo_path_over_every_card(ch):
    """With no device given, the solver takes every visible card, an
    x-free mesh and the halo path; 256^3 run(21) equals the one-card
    wrap path bitwise."""
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    _distinct_cards()
    m = Jacobi3D(256, 256, 256)
    assert m.kernel_path == "halo"
    assert len(set(m.dd.mesh.devices)) == torch.cuda.device_count()
    w = Jacobi3D(256, 256, 256, kernel="wrap", device="cuda:0")
    for s in (m, w):
        s.init()
        s.run(21)
    np.testing.assert_array_equal(m.temperature(), w.temperature())


def test_astaroth_halo_on_four_distinct_cards_equals_one_card(cm):
    """64 x 32 x 32 (x, y, z), run(3), halo path (and the pair): four
    shards over four distinct cards equal the same shards on one card
    bitwise, fields and carried w. Runs only with four or more cards."""
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth, MhdParams

    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip("needs four or more CUDA GPUs")
    prm = MhdParams(dt=1e-4)
    for pair in (0, 2):
        runs = []
        for devices in ([f"cuda:{3 - i}" for i in range(4)], ["cuda:0"] * 4):
            m = Astaroth(64, 32, 32, params=prm, kernel="halo",
                         mesh_shape=(1, 2, 2), devices=devices,
                         exchange_every=pair or None)
            assert [d.index for d in m.dd.mesh.devices] == \
                [torch.device(d).index for d in devices]
            m.init()
            m.run(3)
            runs.append({q: (m.field(q), m.accumulator(q)) for q in FIELDS})
        for q in FIELDS:
            np.testing.assert_array_equal(runs[0][q][0], runs[1][q][0])
            np.testing.assert_array_equal(runs[0][q][1], runs[1][q][1])


# ---------------------------------------------------------------------------
# the remote-write paths: B4 (csrc/exchange_dma.cu, Method.PallasDMA) and B7
# (csrc/jacobi_overlap.cu, the overlap path)
# ---------------------------------------------------------------------------
@pytest.fixture
def cx(cs):
    from stencil_tpu_torch.ops import cuda_exchange

    return cuda_exchange


@pytest.fixture
def co(cs):
    from stencil_tpu_torch.ops import cuda_overlap

    return cuda_overlap


def _asym():
    r = Radius.constant(1)
    r.set_dir((1, 0, 0), 2)
    r.set_dir((0, 0, -1), 3)
    r.set_dir((0, 1, 0), 0)
    return r


def _padded_shards(local_zyx, mesh, radius, dtype, seed):
    lo, hi = radius.pad_lo(), radius.pad_hi()
    Z, Y, X = local_zyx
    shape = (Z + lo.z + hi.z, Y + lo.y + hi.y, X + lo.x + hi.x)
    n = mesh[0] * mesh[1] * mesh[2]
    return [(1000 * _rand(shape, seed + i)).to(dtype) for i in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.int16])
@pytest.mark.parametrize("local,mesh,rad", [
    ((5, 6, 7), (2, 2, 2), "r2"),
    ((9, 4, 11), (3, 2, 2), "asym"),
    ((4, 8, 9), (1, 2, 3), "r1"),
])
def test_exchange_axis_kernel_equals_twin(cx, local, mesh, rad, dtype):
    """Every sweep (one-shard axes too), kernel against twin, every cell
    bitwise (any dtype: the kernel copies units of 2 to 16 bytes), one
    launch per sweep for the one card; then the whole remote-write
    exchange against the slab copy."""
    from stencil_tpu_torch.parallel.cuda_exchange import exchange_shard_cuda
    from stencil_tpu_torch.parallel.exchange import exchange_shard

    radius = {"r1": Radius.constant(1), "r2": Radius.constant(2),
              "asym": _asym()}[rad]
    counts = Dim3(*mesh)
    shards = _padded_shards(local, mesh, radius, dtype, 71)
    for a in range(3):
        r_lo, r_hi = radius.face(a, -1), radius.face(a, 1)
        if r_lo + r_hi == 0:
            continue
        k = [t.clone() for t in shards]
        w = [t.clone() for t in shards]
        before = cx.LAUNCHES["exchange_axis"]
        cx.exchange_axis_cuda(k, a, r_lo, r_hi, counts)
        assert cx.LAUNCHES["exchange_axis"] == before + 1
        cx.exchange_axis_plain(w, a, r_lo, r_hi, counts)
        for i, (g, t) in enumerate(zip(k, w)):
            assert torch.equal(g, t), (a, i)
    k = [t.clone() for t in shards]
    exchange_shard_cuda(k, radius, counts)
    exchange_shard(shards, radius, counts)
    for g, t in zip(k, shards):
        assert torch.equal(g, t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_q", [1, 8])
@pytest.mark.parametrize("mesh,local", [((1, 2, 2), (24, 20, 16)),
                                        ((1, 2, 4), (17, 12, 9))])
def test_sweeps_of_every_quantity_are_one_launch_per_card(cx, mesh, local,
                                                          n_q, dtype):
    """``start_sweeps`` over ``n_q`` quantities of a mesh on one card: one
    B4 launch per sweep, whatever the quantities and shards, every cell
    bitwise equal to the twin's sweeps; a second exchange of the same
    buffers reuses the cached plan, a replaced buffer gets a new one."""
    counts = Dim3(*mesh)
    radius = Radius.constant(3)
    fields = [_padded_shards(local, mesh, radius, dtype, 90 + 10 * q)
              for q in range(n_q)]
    want = [[t.clone() for t in f] for f in fields]
    sweeps = [(0, 3, 3), (1, 3, 3), (2, 3, 3)]
    for rep in range(2):
        before = cx.LAUNCHES["exchange_axis"]
        cx.start_sweeps(fields, sweeps, counts).exit()
        assert cx.LAUNCHES["exchange_axis"] == before + 3
        for f in want:
            for a, lo, hi in sweeps:
                cx.exchange_axis_plain(f, a, lo, hi, counts)
        for f, g in zip(fields, want):
            for a, b in zip(f, g):
                assert torch.equal(a, b)
    plan = cx.exchange_plan(fields, sweeps, counts)
    assert cx.exchange_plan(fields, sweeps, counts) is plan
    assert all(len(per_card) == 1 and len(per_card[0].rows)
               == n_q * counts.flatten() for per_card in plan.launches)
    fields[0][1] = fields[0][1].clone()
    assert cx.exchange_plan(fields, sweeps, counts) is not plan


def test_sweeps_on_distinct_cards_are_one_launch_per_card(cx):
    """8 quantities of a (1,2,2) mesh over four cards (each shard's card
    storing into its neighbours' over the peer link): one launch per card
    and sweep, bitwise equal to the twin on one card."""
    devs = _distinct_cards()
    counts = Dim3(1, 2, 2)
    radius = Radius.constant(3)
    fields = [_padded_shards((16, 12, 20), (1, 2, 2), radius, torch.float32,
                             70 + q) for q in range(8)]
    want = [[t.clone() for t in f] for f in fields]
    spread = [[t.to(devs[i]) for i, t in enumerate(f)] for f in fields]
    sweeps = [(0, 3, 3), (1, 3, 3), (2, 3, 3)]
    before = cx.LAUNCHES["exchange_axis"]
    cx.start_sweeps(spread, sweeps, counts).exit()
    assert (cx.LAUNCHES["exchange_axis"]
            == before + 3 * len(set(devs)))
    cx.start_sweeps(want, sweeps, counts).exit()
    for f, g in zip(spread, want):
        for a, b in zip(f, g):
            assert torch.equal(a.cpu(), b.cpu())


@pytest.fixture
def delayed_b4(cx, monkeypatch):
    """From then on, every B4 launch first sleeps on its card's side
    stream; returns the count of launches delayed (a one-item list)."""
    def delay(cycles=2_000_000):
        real = cx._launch_card
        seen = [0]

        def launch(args, stream):
            with torch.cuda.stream(stream):
                torch.cuda._sleep(cycles)
            seen[0] += 1
            return real(args, stream)
        monkeypatch.setattr(cx, "_launch_card", launch)
        return seen
    return delay


@pytest.mark.parametrize("model", ["jacobi", "astaroth"])
def test_xla_overlap_with_dma_is_unchanged_by_a_delayed_exchange(
        cx, delayed_b4, model):
    """``xla-overlap`` + ``PallasDMA`` on (1,2,2) of one card: the inner
    blocks run while the exchange is in flight on the card's side
    stream, the outer ones after ``wait()``. With every B4 launch
    sleeping first, the result is bitwise the same."""
    from stencil_tpu_torch import Method
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth, MhdParams
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    def run():
        if model == "jacobi":
            m = Jacobi3D(48, 48, 48, kernel="xla", overlap=True,
                         methods=Method.PallasDMA, mesh_shape=(1, 2, 2),
                         devices=["cuda:0"] * 4)
        else:
            m = Astaroth(32, 32, 48, params=MhdParams(dt=1e-4), kernel="xla",
                         overlap=True, methods=Method.PallasDMA,
                         mesh_shape=(1, 2, 2), devices=["cuda:0"] * 4)
        m.init()
        cx.reset_launch_counts()
        m.run(2)
        got = ([m.temperature()] if model == "jacobi"
               else [m.field(q) for q in FIELDS])
        # one launch per exchange and sweep: 2 steps, or 2 x 3 substeps
        assert cx.LAUNCHES["exchange_axis"] == 3 * (2 if model == "jacobi"
                                                    else 6)
        return got
    ref = run()
    seen = delayed_b4()
    slow = run()
    assert seen[0] == cx.LAUNCHES["exchange_axis"]
    for a, b in zip(slow, ref):
        np.testing.assert_array_equal(a, b)


def test_exchange_axis_refuses_mixed_or_strided_shards(cx):
    shards = [_rand((6, 6, 6), 72 + i) for i in range(2)]
    with pytest.raises(ValueError, match="CUDA"):
        cx.exchange_axis_cuda([shards[0], shards[1].cpu()], 0, 1, 1,
                              Dim3(2, 1, 1))
    with pytest.raises(ValueError, match="contiguous"):
        cx.exchange_axis_cuda([t.transpose(0, 1) for t in shards], 0, 1, 1,
                              Dim3(2, 1, 1))


def _overlap_case(size_xyz, mesh, seed):
    X, Y, Z = size_xyz
    lz, ly = Z // mesh[2], Y // mesh[1]
    n = mesh[1] * mesh[2]
    shards = [_rand((lz, ly, X), seed + i) for i in range(n)]
    orgs = [((i // mesh[1]) * lz, (i % mesh[1]) * ly, 0) for i in range(n)]
    return shards, orgs, ((X // 3, Y // 2, Z // 2),
                          (2 * X // 3, Y // 2, Z // 2), 3)


@pytest.mark.parametrize("size,mesh", [((24, 16, 16), (1, 2, 2)),
                                       ((33, 32, 32), (1, 2, 4)),
                                       ((17, 6, 9), (1, 1, 1)),
                                       ((24, 8, 4), (1, 4, 1))])
def test_overlap_kernel_equals_twin(co, size, mesh):
    shards, orgs, (hot, cold, r) = _overlap_case(size, mesh, 73)
    counts = Dim3(*mesh)
    co.reset_launch_counts()
    out, recv = co.jacobi7_overlap_cuda(shards, orgs, hot, cold, r, counts)
    assert co.LAUNCHES["jacobi7_overlap"] == len(shards)
    new, slabs = co.jacobi7_overlap_plain(shards, orgs, hot, cold, r, counts)
    for i in range(len(shards)):
        assert torch.equal(out[i], new[i]), i
        for k in co.SLAB_NAMES:
            assert torch.equal(recv.slabs[i][k], slabs[i][k]), (i, k)


@pytest.fixture
def delayed_launches(monkeypatch):
    """``delay(shard, n_shards)``: from then on, every B7 launch of mesh
    position ``shard`` (A and B) first sleeps on its own stream; ``fns``
    names other launchers (B13/B14's). Returns the launch counts seen."""
    from stencil_tpu_torch.ops import _build

    real = _build.launch

    def delay(shard, n_shards, cycles=2_000_000,
              fns=("jacobi7_overlap_inner_launch",
                   "jacobi7_overlap_faces_launch")):
        calls = {fn: 0 for fn in fns}

        def launch(name, fn_name, *args):
            if fn_name in calls:
                if calls[fn_name] % n_shards == shard:
                    torch.cuda._sleep(cycles)
                calls[fn_name] += 1
            return real(name, fn_name, *args)
        monkeypatch.setattr(_build, "launch", launch)
        return calls
    return delay


@pytest.mark.parametrize("shard", [0, 3])
def test_overlap_steps_with_a_delayed_neighbour_equal_the_twin(
        co, delayed_launches, shard):
    """Six steps in one session, one shard's stream sleeping before each
    of its launches: rule (b) keeps its neighbours' launch B from reading
    slabs it has not sent yet, rule (a) keeps them from overwriting slabs
    it has not read yet. Equals six steps of the twin bitwise."""
    shards, orgs, (hot, cold, r) = _overlap_case((64, 32, 32), (1, 2, 2), 74)
    counts = Dim3(1, 2, 2)
    want = [t.clone() for t in shards]
    for _ in range(6):
        want, _ = co.jacobi7_overlap_plain(want, orgs, hot, cold, r, counts)
    a = [t.clone() for t in shards]
    b = [torch.empty_like(t) for t in a]
    recv = co.OverlapRecv(a, counts)
    calls = delayed_launches(shard, 4)
    with recv.session():
        for _ in range(6):
            co.jacobi7_overlap_cuda(a, orgs, hot, cold, r, counts, out=b,
                                    recv=recv)
            a, b = b, a
    assert set(calls.values()) == {24}
    for g, w in zip(a, want):
        assert torch.equal(g, w)


def test_overlap_path_agrees_with_plain_path(co, delayed_launches):
    """64^3 on four shards of the card: ``overlap=True`` (auto takes
    ``overlap``) launches B7 once per shard a step and nothing else,
    agrees with ``xla`` within steps x 8 eps(f32) after run(5), and
    equals itself with a delayed shard bitwise."""
    from stencil_tpu_torch.models.jacobi import Jacobi3D
    from stencil_tpu_torch.ops import cuda_halo, cuda_stencil

    runs = {}
    for label, kw in (("overlap", dict(overlap=True)), ("xla",
                                                        dict(kernel="xla")),
                      ("delayed", dict(overlap=True))):
        m = Jacobi3D(64, 64, 64, mesh_shape=(1, 2, 2),
                     devices=["cuda:0"] * 4, **kw)
        assert m.kernel_path == ("xla" if label == "xla" else "overlap")
        m.init()
        if label == "delayed":
            delayed_launches(1, 4)
        for mod in (co, cuda_halo, cuda_stencil):
            mod.reset_launch_counts()
        m.run(5)
        if label != "xla":
            assert co.LAUNCHES["jacobi7_overlap"] == 20
            assert not any(cuda_halo.LAUNCHES.values())
            assert not any(cuda_stencil.LAUNCHES.values())
        runs[label] = m.temperature()
    eps = np.finfo(np.float32).eps
    assert np.abs(runs["overlap"] - runs["xla"]).max() <= 5 * 8 * eps
    np.testing.assert_array_equal(runs["delayed"], runs["overlap"])


@pytest.mark.parametrize("kernel,overlap", [("pallas", False),
                                            ("xla", True)])
def test_pallas_dma_paths_equal_slab_paths(cx, kernel, overlap):
    """The padded paths with Method.PallasDMA equal them with the slab
    copy bitwise (48^3 on (2,2,1) and (1,2,2), run(3)); every step
    launches B4 once per card and sweep (x, y and z: 3 on one card)."""
    from stencil_tpu_torch import Method
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    for mesh in ((2, 2, 1), (1, 2, 2)):
        runs = []
        for methods in (Method.PallasDMA, Method.PpermuteSlab):
            m = Jacobi3D(48, 48, 48, kernel=kernel, overlap=overlap,
                         methods=methods, mesh_shape=mesh,
                         devices=["cuda:0"] * 4)
            m.init()
            cx.reset_launch_counts()
            m.run(3)
            want = 3 * 3 if methods == Method.PallasDMA else 0
            assert cx.LAUNCHES["exchange_axis"] == want
            runs.append(m.temperature())
        np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.parametrize("kernel,overlap,methods", [
    ("halo", True, None), ("xla", False, "dma"), ("pallas", False, "dma")])
def test_remote_write_paths_on_distinct_cards_equal_one_card(
        cx, kernel, overlap, methods):
    """128^3, run(7): four shards over distinct cards (their kernels
    storing into each other's memory over the peer link) equal the same
    four shards on one card bitwise."""
    from stencil_tpu_torch import Method
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    devs = _distinct_cards()
    mesh = (1, 2, 2) if kernel == "halo" else (2, 2, 1)
    kw = {} if methods is None else {"methods": Method.PallasDMA}
    runs = []
    for devices in (devs, ["cuda:0"] * 4):
        m = Jacobi3D(128, 128, 128, kernel=kernel, overlap=overlap,
                     mesh_shape=mesh, devices=devices, **kw)
        m.init()
        m.run(7)
        runs.append(m.temperature())
    np.testing.assert_array_equal(runs[0], runs[1])


# ---------------------------------------------------------------------------
# the MHD overlap path: B13/B14 (csrc/mhd_overlap.cu, halo-overlap)
# ---------------------------------------------------------------------------
MHD_OVERLAP_FNS = ("mhd_substep_overlap_launch", "mhd_substep_fixup_launch")


@pytest.fixture
def mo(cm):
    from stencil_tpu_torch.ops import cuda_mhd_overlap

    return cuda_mhd_overlap


def _overlap_variants(pair):
    return ([(0, False, True, True)] if pair else
            [(0, False, True, False), (1, True, True, False),
             (2, True, False, False)])


@pytest.mark.parametrize("size,mesh", [((16, 8, 24), (1, 1, 1)),
                                       ((32, 8, 16), (1, 1, 2)),
                                       ((48, 48, 16), (1, 2, 2)),
                                       ((32, 16, 5), (1, 2, 4)),
                                       ((208, 256, 96), (1, 2, 2)),
                                       ((48, 16, 24), (1, 2, 2)),
                                       ((80, 64, 40), (1, 2, 2))])
def test_mhd_overlap_kernels_match_twins_and_halo_kernels(mo, cm, size, mesh):
    """B13 against its twin (the interior within 64 eps(f32) x max, the
    landed rows bitwise), B13's interior against B11 (B12 with the pair)
    at the same points bitwise, and B14 after B13 against B11 (B12) on
    the same shards and rows bitwise, for every variant: s = 0 with
    w=None, s = 1, s = 2 with write_w=False, and the pair. The interior's
    ny is not a multiple of the ring kernel's 16-row tile, at (32, 16, 5)
    on (1,2,4) with X below its 32 columns; on 104 x 128 x 96 shards the
    ring kernel walks the interior's z in runs, the last one shorter.
    B14's y strips span Z - 2R rows of z, 18 on the 24 x 24 x 16 and
    24 x 8 x 24 shards and 34 on 40 x 32 x 40 ones (none a multiple of
    its 16-row tile; the last holds 2 rows); 24 x 8 x 24 shards are thin
    in y (Y = 8) and narrower than a 32-column tile, 40 x 32 x 40 ones
    take a second, partial column tile. Every launch of B14 is, per
    shard, the launches ``fixup_plan`` counts (one with one substep; with
    the pair two of the shell kernel and one of the margin kernel)."""
    from stencil_tpu_torch.models.astaroth import FIELDS, MhdParams

    shards, ws = _mhd_mesh(size, mesh, 81)
    counts = Dim3(*mesh)
    f = [_fields(t) for t in shards]
    w = [_fields(t) for t in ws]
    prm = MhdParams(dt=1e-4)
    Z, Y = shards[0].shape[1:3]
    for pair in (False, True):
        hr = mo.halo_rows(pair)
        slabs = _mhd_slabs(shards, mesh, rz=hr, ry=hr)
        inner = mo.interior_region(Z, Y, pair)
        for s, read_w, write_w, _ in _overlap_variants(pair):
            w_in = w if read_w else None
            mo.reset_launch_counts()
            kf, kw, recv = mo.mhd_substep_overlap_cuda(
                f, w_in, s, prm, 1e-4, counts, pair=pair, write_w=write_w)
            tf, tw, tsl = mo.mhd_substep_overlap_plain(
                f, w_in, s, prm, 1e-4, counts, pair=pair, write_w=write_w)
            landed = recv.landed(hr)
            if pair:
                halo = [cm.mhd_substep01_halo_cuda(f[i], slabs[i], prm, 1e-4)
                        for i in range(len(f))]
            else:
                halo = [cm.mhd_substep_halo_cuda(
                    f[i], None if w_in is None else w_in[i], slabs[i], s,
                    prm, 1e-4, write_w=write_w) for i in range(len(f))]
            for i in range(len(f)):
                for q in FIELDS:
                    for k in cm.SLAB_NAMES:
                        assert torch.equal(landed[i][q][k], tsl[i][q][k])
                        assert torch.equal(landed[i][q][k], slabs[i][q][k])
                if inner is not None:
                    z0, nz, y0, ny = inner
                    cut = (slice(z0, z0 + nz), slice(y0, y0 + ny))
                    _assert_fields_close({q: kf[i][q][cut] for q in FIELDS},
                                         {q: tf[i][q][cut] for q in FIELDS})
                    if write_w:
                        _assert_fields_close(
                            {q: kw[i][q][cut] for q in FIELDS},
                            {q: tw[i][q][cut] for q in FIELDS})
                    hf, hw = halo[i]
                    for q in FIELDS:
                        assert torch.equal(kf[i][q][cut], hf[q][cut]), (
                            pair, s, i, q)
                        if write_w:
                            assert torch.equal(kw[i][q][cut], hw[q][cut]), (
                                pair, s, i, q)
            kernels, calls = kernel_profile(
                lambda: mo.mhd_substep_fixup_cuda(f, w_in, kf, kw, s, prm,
                                                  1e-4, counts, recv,
                                                  pair=pair))
            plan = mo.fixup_plan(Z, Y, shards[0].shape[3], pair)
            assert sum(k["launches"] for k in kernels.values()) == \
                len(f) * plan.launches, kernels
            assert set(kernels) == ({"mhd_shell_kernel", "mhd_margin_kernel"}
                                    if pair else {"mhd_shell_kernel"}), \
                kernels
            # one count a shard and call: B13 once, B14 once a call
            assert mo.LAUNCHES == {"mhd_substep_overlap": len(f),
                                   "mhd_substep_fixup": calls * len(f)}
            for i, (hf, hw) in enumerate(halo):
                for q in FIELDS:
                    assert torch.equal(kf[i][q], hf[q]), (pair, s, i, q)
                    if write_w:
                        assert torch.equal(kw[i][q], hw[q]), (pair, s, i, q)


def test_b14_kernel_fits_the_planners_registers_without_spills(mo, tmp_path):
    """B14's one-substep kernel (``mhd_shell_kernel``: both instances of
    the ring, z and y, behind one uniform branch), every (read_w,
    write_w) instantiation built as the package builds it: at most 128
    registers a thread, no spill, and the one block an SM that the
    planner counts (``FIXUP_BLOCKS_PER_SM``), as the card counts it."""
    usage = _fresh_ptxas("mhd_overlap", tmp_path, "mhd_shell_kernel")
    assert len(usage) == 10, usage     # as the ring kernel's
    for name, use in usage.items():
        assert use["registers"] <= 128, (name, use)
        assert (use["spill_stores"], use["spill_loads"]) == (0, 0), \
            (name, use)
    assert mo.fixup_occupancy(torch.device("cuda")) == mo.FIXUP_BLOCKS_PER_SM


PAIR_PROFILE = """
import json
import torch
from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.models.astaroth import FIELDS, MhdParams
from stencil_tpu_torch.ops import cuda_mhd_overlap as mo
from stencil_tpu_torch.utils.timers import kernel_profile

g = torch.Generator(device="cuda").manual_seed(5)
shards = [0.1 * torch.randn((8, 24, 24, 40), generator=g, device="cuda")
          for _ in range(4)]
f = [dict(zip(FIELDS, t.unbind(0))) for t in shards]
of = [dict(zip(FIELDS, torch.empty_like(t).unbind(0))) for t in shards]
ow = [dict(zip(FIELDS, torch.empty_like(t).unbind(0))) for t in shards]
counts, prm = Dim3(1, 2, 2), MhdParams(dt=1e-4)
recv = mo.MhdOverlapRecv(shards, counts)
b13 = lambda: mo.mhd_substep_overlap_cuda(f, None, 0, prm, 1e-4, counts,
                                          pair=True, out_f=of, out_w=ow,
                                          recv=recv)
b14 = lambda: mo.mhd_substep_fixup_cuda(f, None, of, ow, 0, prm, 1e-4,
                                        counts, recv, pair=True)
out = {}
for name, fn in (("b13", b13), ("b14", b14)):
    kernels, _ = kernel_profile(fn, 3)
    out[name] = {k: v["launches"] for k, v in kernels.items()}
print(json.dumps(out))
"""


def test_pair_forms_launch_the_ring_kernels_in_a_fresh_process(mo):
    """What one pair call launches on four 24 x 24 x 40 shards of (1,2,2)
    (``torch.profiler``, three calls, in a fresh process: many profiles
    in one process have dropped kernel records): B13's pair, per shard,
    ``send_rows_kernel`` and two ``mhd_substep_ring_kernel`` (substep 0
    over z, y in [R, n - R), substep 1 over [kT, n - kT)); B14's pair two
    ``mhd_shell_kernel`` (substep 0 at depth R, substep 1 at depth kT)
    and one ``mhd_margin_kernel``. Nothing else, so none of the fused 8^3
    tile kernels of the first design."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    got = subprocess.run([sys.executable, "-c", PAIR_PROFILE], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out == {"b13": {"send_rows_kernel": 4.0,
                           "mhd_substep_ring_kernel": 8.0},
                   "b14": {"mhd_shell_kernel": 8.0,
                           "mhd_margin_kernel": 4.0}}, out


def test_b14_pair_refuses_scratch_of_other_fields(mo):
    """B14's pair completes the substep 0 that the shard's last B13 pair
    left in its scratch, so it raises ``ValueError`` (and launches
    nothing) when no B13 pair ran on that recv, when the fields were
    written since or are other tensors, and when the constants differ;
    it runs, and runs again, on the state that B13's pair saw."""
    from stencil_tpu_torch.models.astaroth import FIELDS, MhdParams

    shards, _ = _mhd_mesh((48, 48, 24), (1, 2, 2), 83)
    counts, prm = Dim3(1, 2, 2), MhdParams(dt=1e-4)
    f = [_fields(t) for t in shards]
    of = [_fields(torch.empty_like(t)) for t in shards]
    ow = [_fields(torch.empty_like(t)) for t in shards]
    recv = mo.MhdOverlapRecv(shards, counts)

    def b14(fields=f, dt=1e-4):
        mo.mhd_substep_fixup_cuda(fields, None, of, ow, 0, prm, dt, counts,
                                  recv, pair=True)

    mo.reset_launch_counts()
    with pytest.raises(ValueError, match="scratch"):
        b14()
    assert all(recv.pair_scratch(i) is None for i in range(4))
    mo.mhd_substep_overlap_cuda(f, None, 0, prm, 1e-4, counts, pair=True,
                                out_f=of, out_w=ow, recv=recv)
    b14()
    first = [{q: t.clone() for q, t in g.items()} for g in of]
    b14()
    assert all(torch.equal(a[q], b[q]) for a, b in zip(first, of)
               for q in FIELDS)
    with pytest.raises(ValueError, match="scratch"):
        b14(dt=2e-4)
    with pytest.raises(ValueError, match="scratch"):
        b14([_fields(t.clone()) for t in shards])
    shards[2][3, 0, 0, 0] += 0.0      # written: a new version
    with pytest.raises(ValueError, match="scratch"):
        b14()
    assert mo.LAUNCHES == {"mhd_substep_overlap": 4,
                           "mhd_substep_fixup": 8}


@pytest.mark.parametrize("shard", [0, 3])
def test_mhd_overlap_substeps_with_a_delayed_shard_equal_the_halo_kernels(
        mo, cm, delayed_launches, shard):
    """Three substeps and a pair pass of ``mhd_substep_overlap`` in one
    session on (1,2,2), one shard's stream sleeping before each of its
    B13 and B14 launches (rule (a) guards the receive buffers it has not
    read, rule (b) the rows it has not sent, from its four face and four
    diagonal neighbours): bitwise equal to a slab round and B11 (B12) per
    substep."""
    from stencil_tpu_torch.models.astaroth import MhdParams

    mesh, counts = (1, 2, 2), Dim3(1, 2, 2)
    shards, _ = _mhd_mesh((32, 32, 24), mesh, 82)
    prm = MhdParams(dt=1e-4)

    def halo_chain(a):
        steps = [(0, False), (1, True), (2, True)]
        w = None
        for s, read_w in steps:
            sl = _mhd_slabs(a, mesh, rz=3, ry=3)
            out = [cm.mhd_substep_halo_cuda(_fields(t), w[i] if read_w else
                                            None, sl[i], s, prm, 1e-4)
                   for i, t in enumerate(a)]
            a = [torch.stack(list(o[0].values())) for o in out]
            w = [o[1] for o in out]
        sl = _mhd_slabs(a, mesh, rz=6, ry=6)
        out = [cm.mhd_substep01_halo_cuda(_fields(t), sl[i], prm, 1e-4)
               for i, t in enumerate(a)]
        return [torch.stack(list(o[0].values())) for o in out]

    want = halo_chain(shards)
    calls = delayed_launches(shard, 4, fns=MHD_OVERLAP_FNS)
    a = [t.clone() for t in shards]
    b = [torch.empty_like(t) for t in a]
    w1 = [torch.empty_like(t) for t in a]
    w2 = [torch.empty_like(t) for t in a]
    recv = mo.MhdOverlapRecv(a, counts)

    def v(ts):
        return None if ts is None else [_fields(t) for t in ts]

    with recv.session():
        for s, w_in, w_out in ((0, None, w1), (1, w1, w2), (2, w2, w1)):
            mo.mhd_substep_overlap(v(a), v(w_in), s, prm, 1e-4, counts,
                                   out_f=v(b), out_w=v(w_out), recv=recv)
            a, b = b, a
        mo.mhd_substep_overlap(v(a), None, 0, prm, 1e-4, counts, pair=True,
                               out_f=v(b), out_w=v(w2), recv=recv)
        a, b = b, a
    assert set(calls.values()) == {16}
    for g, t in zip(a, want):
        assert torch.equal(g, t)


@pytest.mark.parametrize("pair", ["0", "1"])
@pytest.mark.parametrize("mesh", [(1, 1, 1), (1, 2, 2)])
def test_astaroth_halo_overlap_path_equals_halo_path(mo, cm, monkeypatch,
                                                     delayed_launches, mesh,
                                                     pair):
    """24 x 32 x 48 (x, y, z), run(2) at dt = 1e-4: ``overlap=True``
    (``auto`` takes ``halo-overlap``) launches B13 and B14 once per shard
    and substep (pair pass) and nothing else, equals ``halo`` bitwise
    (fields and carried w), and equals itself with a delayed shard."""
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth, MhdParams

    monkeypatch.setenv("STENCIL_MHD_PAIR", pair)
    prm = MhdParams(dt=1e-4)
    n = mesh[1] * mesh[2]
    runs = []
    for label in ("halo", "overlap", "delayed"):
        m = Astaroth(24, 32, 48, params=prm, kernel="halo" if label == "halo"
                     else "auto", overlap=label != "halo", mesh_shape=mesh,
                     devices=["cuda:0"] * n)
        assert m.kernel_path == ("halo" if label == "halo"
                                 else "halo-overlap")
        m.init()
        if label == "delayed":
            delayed_launches(n - 1, n, fns=MHD_OVERLAP_FNS)
        cm.reset_launch_counts()
        mo.reset_launch_counts()
        m.run(2)
        if label != "halo":
            k = (2 if pair == "1" else 3) * 2 * n
            assert mo.LAUNCHES == {"mhd_substep_overlap": k,
                                   "mhd_substep_fixup": k}
            assert not any(cm.LAUNCHES.values())
        runs.append({q: (m.field(q), m.accumulator(q)) for q in FIELDS})
    for q in FIELDS:
        for r in runs[1:]:
            np.testing.assert_array_equal(r[q][0], runs[0][q][0])
            np.testing.assert_array_equal(r[q][1], runs[0][q][1])


def test_astaroth_halo_overlap_on_distinct_cards_equals_one_card(mo):
    """64 x 32 x 32 (x, y, z), run(3), ``halo-overlap`` (and the pair):
    four shards over distinct cards, B13 storing its rows into the other
    cards' receive buffers over the peer link, equal the same shards on
    one card bitwise. Runs only with two or more cards."""
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth, MhdParams

    devs = _distinct_cards()
    prm = MhdParams(dt=1e-4)
    for pair in (0, 2):
        runs = []
        for devices in (devs, ["cuda:0"] * 4):
            m = Astaroth(64, 32, 32, params=prm, kernel="halo", overlap=True,
                         mesh_shape=(1, 2, 2), devices=devices,
                         exchange_every=pair or None)
            assert m.kernel_path == "halo-overlap"
            m.init()
            m.run(3)
            runs.append({q: (m.field(q), m.accumulator(q)) for q in FIELDS})
        for q in FIELDS:
            np.testing.assert_array_equal(runs[0][q][0], runs[1][q][0])
            np.testing.assert_array_equal(runs[0][q][1], runs[1][q][1])


# ---------------------------------------------------------------------------
# bfloat16 storage on the MHD ring kernels (B9-B14): each launch family
# against its plain twin on the same bf16 inputs, within one bf16 ulp of
# the largest twin value a field, and against the float32 instance on the
# widened inputs, rounded once, bit for bit (the ring and the arithmetic
# are float32 in both)
# ---------------------------------------------------------------------------
BF16_SHAPES = [(16, 16, 24), (32, 16, 33), (256, 256, 256)]
BF16_MESHES = [((32, 32, 40), (1, 2, 2)), ((32, 64, 33), (1, 2, 2)),
               ((512, 512, 256), (1, 2, 2))]
BF16_ULP = 2.0 ** -7


def _bf(d):
    return None if d is None else {q: t.to(torch.bfloat16)
                                   for q, t in d.items()}


def _wide(d):
    return None if d is None else {q: t.float() for q, t in d.items()}


def _assert_bf16_close(got, want):
    assert set(got) == set(want)
    for q in want:
        assert got[q].dtype == torch.bfloat16, q
        assert bool(torch.isfinite(got[q]).all()), q
        err = float((got[q].float() - want[q].float()).abs().max())
        assert err <= BF16_ULP * float(want[q].float().abs().max()), (q, err)


def _assert_rounded_once(got, want32):
    """(f, w) of a bf16 launch equal the float32 instance's, rounded."""
    for g, w in zip(got, want32):
        assert (g is None) == (w is None)
        if w is not None:
            for q in w:
                assert torch.equal(g[q], w[q].to(torch.bfloat16)), q


@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_bf16_b9_b10_match_twins_and_the_float32_instance(cm, shape):
    from stencil_tpu_torch.models.astaroth import MhdParams

    prm = MhdParams(dt=1e-4)
    f32, w32 = _mhd_state(shape, 61)
    f, w = _bf(f32), _bf(w32)
    before = dict(cm.LAUNCHES)
    for s, read_w, write_w in [(0, False, True), (1, True, True),
                               (2, True, False), (0, True, True)]:
        wi = w if read_w else None
        got = cm.mhd_substep_wrap_cuda(f, wi, s, prm, 1e-4, write_w=write_w)
        tw = cm.mhd_substep_wrap_plain(f, wi, s, prm, 1e-4, write_w=write_w)
        _assert_bf16_close(got[0], tw[0])
        if write_w:
            _assert_bf16_close(got[1], tw[1])
        _assert_rounded_once(got, cm.mhd_substep_wrap_cuda(
            _wide(f), _wide(wi), s, prm, 1e-4, write_w=write_w))
    got = cm.mhd_substep01_wrap_cuda(f, prm, 1e-4)
    tw = cm.mhd_substep01_wrap_plain(f, prm, 1e-4)
    _assert_bf16_close(got[0], tw[0])
    _assert_bf16_close(got[1], tw[1])
    _assert_rounded_once(got, cm.mhd_substep01_wrap_cuda(_wide(f), prm,
                                                         1e-4))
    assert cm.LAUNCHES["mhd_substep_wrap"] == before["mhd_substep_wrap"] + 8
    assert (cm.LAUNCHES["mhd_substep01_wrap"]
            == before["mhd_substep01_wrap"] + 2)


@pytest.mark.parametrize("size,mesh", BF16_MESHES)
def test_bf16_b11_b12_match_twins_and_the_float32_instance(cm, size, mesh):
    """On the halo path's exact slabs (3 and 6 rows), every shard of the
    small meshes and shard 0 of the four 256^3 shards."""
    from stencil_tpu_torch.models.astaroth import MhdParams

    prm = MhdParams(dt=1e-4)
    f32, w32 = _mhd_mesh(size, mesh, 62)
    shards = [t.to(torch.bfloat16) for t in f32]
    ws = [t.to(torch.bfloat16) for t in w32]
    sl3 = _mhd_slabs(shards, mesh, rz=3, ry=3)
    sl6 = _mhd_slabs(shards, mesh, rz=6, ry=6)
    sl3w = _mhd_slabs([t.float() for t in shards], mesh, rz=3, ry=3)
    sl6w = _mhd_slabs([t.float() for t in shards], mesh, rz=6, ry=6)
    for i in range(1 if size[0] == 512 else len(shards)):
        f, w = _fields(shards[i]), _fields(ws[i])
        for s, read_w, write_w in [(0, False, True), (1, True, True),
                                   (2, True, False)]:
            wi = w if read_w else None
            got = cm.mhd_substep_halo_cuda(f, wi, sl3[i], s, prm, 1e-4,
                                           write_w=write_w)
            tw = cm.mhd_substep_halo_plain(f, wi, sl3[i], s, prm, 1e-4,
                                           write_w=write_w)
            _assert_bf16_close(got[0], tw[0])
            if write_w:
                _assert_bf16_close(got[1], tw[1])
            _assert_rounded_once(got, cm.mhd_substep_halo_cuda(
                _wide(f), _wide(wi), sl3w[i], s, prm, 1e-4, write_w=write_w))
        got = cm.mhd_substep01_halo_cuda(f, sl6[i], prm, 1e-4)
        tw = cm.mhd_substep01_halo_plain(f, sl6[i], prm, 1e-4)
        _assert_bf16_close(got[0], tw[0])
        _assert_bf16_close(got[1], tw[1])
        _assert_rounded_once(got, cm.mhd_substep01_halo_cuda(
            _wide(f), sl6w[i], prm, 1e-4))


@pytest.mark.parametrize("size,mesh", BF16_MESHES)
def test_bf16_b13_b14_match_twins_and_the_float32_instance(mo, cm, size,
                                                           mesh):
    """B13 then B14 (``mhd_substep_overlap``) for every variant, the pair
    among them, against the B11/B12 twin on the landed rows and against
    the float32 instance on the widened shards, rounded once."""
    from stencil_tpu_torch.models.astaroth import MhdParams

    prm = MhdParams(dt=1e-4)
    counts = Dim3(*mesh)
    f32, w32 = _mhd_mesh(size, mesh, 63)
    f = [_fields(t.to(torch.bfloat16)) for t in f32]
    w = [_fields(t.to(torch.bfloat16)) for t in w32]
    del f32, w32
    for s, read_w, write_w, pair in (_overlap_variants(False)
                                     + _overlap_variants(True)):
        wi = w if read_w else None
        gf, gw, _ = mo.mhd_substep_overlap(f, wi, s, prm, 1e-4, counts,
                                           pair=pair, write_w=write_w)
        kf, kw, _ = mo.mhd_substep_overlap(
            [_wide(x) for x in f], None if wi is None else
            [_wide(x) for x in wi], s, prm, 1e-4, counts, pair=pair,
            write_w=write_w)
        slabs = mo.landed_slabs(f, counts, mo.halo_rows(pair))
        for i in range(len(f)):
            if pair:
                tw = cm.mhd_substep01_halo_plain(f[i], slabs[i], prm, 1e-4)
            else:
                tw = cm.mhd_substep_halo_plain(
                    f[i], None if wi is None else wi[i], slabs[i], s, prm,
                    1e-4, write_w=write_w)
            _assert_bf16_close(gf[i], tw[0])
            if write_w:
                _assert_bf16_close(gw[i], tw[1])
            _assert_rounded_once((gf[i], None if gw is None else gw[i]),
                                 (kf[i], None if kw is None else kw[i]))
        del gf, gw, kf, kw, slabs
        torch.cuda.empty_cache()


def test_bf16_astaroth_kernel_paths_on_the_card(mo, cm):
    """Astaroth in bf16 on the card: auto takes the kernels (JAX's
    ``_fast_dtype_ok``); ``halo`` on a (1,1,1) mesh equals ``wrap`` and
    ``halo-overlap`` equals ``halo`` on (1,2,2), bit for bit (fields
    and carried w); the pair's f_1, w_1 stay float32, so a pair path is
    within one bf16 ulp of max a substep of its single-substep path."""
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth, MhdParams

    prm = MhdParams(dt=1e-4)

    def run(size, mesh, **kw):
        m = Astaroth(*size, params=prm, dtype=torch.bfloat16,
                     mesh_shape=mesh, devices=["cuda:0"] * (mesh[1] * mesh[2]),
                     **kw)
        m.init()
        m.run(2)
        return m.kernel_path, ({q: m.field(q) for q in FIELDS},
                               {q: m.accumulator(q) for q in FIELDS})

    def same(a, b):
        return all(np.array_equal(a[k][q], b[k][q]) for k in (0, 1)
                   for q in FIELDS)

    p_wrap, wrap = run((32, 32, 32), (1, 1, 1))
    p_halo1, halo1 = run((32, 32, 32), (1, 1, 1), kernel="halo")
    assert (p_wrap, p_halo1) == ("wrap", "halo")
    assert same(halo1, wrap)
    p_halo, halo = run((32, 64, 64), (1, 2, 2))
    p_ov, ov = run((32, 64, 64), (1, 2, 2), overlap=True)
    assert (p_halo, p_ov) == ("halo", "halo-overlap")
    assert same(ov, halo)
    _, hpair = run((32, 64, 64), (1, 2, 2), exchange_every=2)
    for q in FIELDS:
        err = np.abs(hpair[0][q] - halo[0][q]).max()
        assert err <= 6 * BF16_ULP * np.abs(halo[0][q]).max(), (q, err)


# ---------------------------------------------------------------------------
# bfloat16 on the Jacobi kernels: K1-K3 and B5-B7 against their twins
# ---------------------------------------------------------------------------
BF16 = torch.bfloat16
# y a multiple of bfloat16's sublane tile (16), which K2 keeps; odd x
# (single-cell loads), x % 4 == 0 (8-byte copies), several ring tiles
BF16_SHAPES = [(5, 16, 7), (9, 16, 13), (3, 32, 33), (1, 16, 1),
               (7, 48, 68), (23, 32, 132)]


def _misaligned(t):
    """``t``'s values in a tensor whose base is 2 bytes off 4-byte
    alignment."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    odd = buf[1:].view(t.shape)
    odd.copy_(t)
    assert odd.data_ptr() % 4 == 2
    return odd


@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_bf16_wrap_kernels_equal_twins(cs, shape):
    """K1 and K2 (N = 1, 2, 3, 8 in one launch, 9 and 16 in two) bitwise
    their twins in bfloat16, on aligned and misaligned fields."""
    Z, Y, X = shape
    hot, cold, r = (X // 3, Y // 2, Z // 2), (2 * X // 3, Y // 2, Z // 2), 2
    cs.reset_launch_counts()
    for t in (_rand(shape, 131).to(BF16),
              _misaligned(_rand(shape, 132).to(BF16))):
        assert torch.equal(cs.jacobi7_wrap_cuda(t, hot, cold, r),
                           cs.jacobi7_wrap_plain(t, hot, cold, r))
        for n in (1, 2, 3, 8, 9, 16):
            assert torch.equal(
                cs.jacobi7_wrapn_cuda(t, hot, cold, r, steps=n),
                cs.jacobi7_wrapn_plain(t, hot, cold, r, steps=n)), n
    assert cs.LAUNCHES["jacobi7_wrap"] == 2
    assert cs.LAUNCHES["jacobi7_wrapn"] == 12


@pytest.mark.parametrize("asym", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_padded_kernel_equals_twin(cs, shape, asym):
    r = Radius.constant(1)
    if asym:
        r.set_dir((1, 0, 0), 2)
        r.set_dir((0, 0, -1), 3)
    interior = Dim3(shape[2], shape[1], shape[0])
    p = _rand(zyx_shape(raw_size(interior, r)), 133).to(BF16)
    before = cs.LAUNCHES["jacobi7_padded"]
    assert torch.equal(cs.jacobi7_padded_cuda(p, r, interior),
                       cs.jacobi7_padded_plain(p, r, interior))
    assert cs.LAUNCHES["jacobi7_padded"] == before + 1


@pytest.mark.parametrize("size,mesh,kw", [
    ((7, 8, 5), (1, 1, 1), dict(rz=1, ry=8)),
    ((13, 17, 9), (1, 2, 2), dict(rz=1, ry=1)),        # uneven y and z
    ((32, 16, 11), (1, 2, 2), dict(rz=1, ry=8)),       # uneven z, x even
])
def test_bf16_halo_kernel_equals_twin(ch, size, mesh, kw):
    shards, slabs, meta, (hot, cold, r), _ = _halo_case(size, mesh, kw, 134,
                                                        BF16)
    before = ch.LAUNCHES["jacobi7_halo"]
    for t, sl, (org, lens) in zip(shards, slabs, meta):
        assert torch.equal(
            ch.jacobi7_halo_cuda(t, sl, org, hot, cold, r,
                                 interior_len_zy=lens),
            ch.jacobi7_halo_plain(t, sl, org, hot, cold, r, lens))
    assert ch.LAUNCHES["jacobi7_halo"] == before + len(shards)


@pytest.mark.parametrize("steps", [1, 2, 3, 8, 9, 16])
@pytest.mark.parametrize("size,mesh", [((20, 16, 20), (1, 1, 1)),
                                       ((33, 64, 48), (1, 2, 2)),
                                       ((64, 32, 36), (1, 2, 2))])
def test_bf16_halon_kernel_equals_twin(ch, size, mesh, steps):
    """B6 in bfloat16 (9 and 16 steps: two launches through a padded
    buffer) bitwise its twin on the halo path's own slabs (rz = ry = N);
    on (1,1,1) it also equals K2."""
    from stencil_tpu_torch.ops import cuda_stencil as cs

    kw = dict(rz=steps, ry=steps, radius_rows=steps, y_z_extended=True)
    shards, slabs, meta, (hot, cold, r), gsize = _halo_case(size, mesh, kw,
                                                            135, BF16)
    for t, sl, (org, _) in zip(shards, slabs, meta):
        got = ch.jacobi7_halon_cuda(t, sl, org, gsize, hot, cold, r,
                                    steps=steps)
        assert torch.equal(got, ch.jacobi7_halon_plain(
            t, sl, org, gsize, hot, cold, r, steps=steps))
        if mesh == (1, 1, 1):
            assert torch.equal(got, cs.jacobi7_wrapn_cuda(t, hot, cold, r,
                                                          steps=steps))


@pytest.mark.parametrize("size,mesh", [((24, 16, 16), (1, 2, 2)),
                                       ((33, 32, 32), (1, 2, 4)),
                                       ((17, 6, 9), (1, 1, 1))])
def test_bf16_overlap_kernel_equals_twin(co, size, mesh):
    shards, orgs, (hot, cold, r) = _overlap_case(size, mesh, 136)
    shards = [t.to(BF16) for t in shards]
    counts = Dim3(*mesh)
    co.reset_launch_counts()
    out, recv = co.jacobi7_overlap_cuda(shards, orgs, hot, cold, r, counts)
    assert co.LAUNCHES["jacobi7_overlap"] == len(shards)
    new, slabs = co.jacobi7_overlap_plain(shards, orgs, hot, cold, r, counts)
    for i in range(len(shards)):
        assert torch.equal(out[i], new[i]), i
        for k in co.SLAB_NAMES:
            assert torch.equal(recv.slabs[i][k], slabs[i][k]), (i, k)


@pytest.mark.parametrize("steps", range(1, 9))
def test_bf16_ring_plan_matches_the_card(cs, steps):
    ty, depth, bps = cs.ring_tile(steps, 2)
    assert cs.ring_occupancy(torch.device("cuda"), steps, ty, depth,
                             2) == bps


def test_bf16_jacobi_paths_take_the_kernels(cs, ch, co):
    """bfloat16 ``auto`` takes ``wrap`` on one shard and ``halo`` /
    ``overlap`` on (1,2,2), as float32 does, and launches the bfloat16
    kernels; ``halo`` on (1,1,1) equals ``wrap`` bitwise, also at
    exchange_every 16 (two ring launches a group); float64 still refuses
    the kernel paths."""
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    def run(n, **kw):
        for mod in (cs, ch, co):
            mod.reset_launch_counts()
        m = Jacobi3D(64, 64, 64, dtype=BF16, **kw)
        m.init()
        m.run(n)
        counts = {**cs.LAUNCHES, **ch.LAUNCHES, **co.LAUNCHES}
        return m, {k: v for k, v in counts.items() if v}

    w, got = run(5, device="cuda")
    assert w.kernel_path == "wrap"
    assert got == {"jacobi7_wrapn": 2, "jacobi7_wrap": 1}
    h, got = run(5, kernel="halo", device="cuda")
    assert got == {"jacobi7_halon": 2, "jacobi7_halo": 1}
    np.testing.assert_array_equal(h.temperature(), w.temperature())
    q, got = run(5, mesh_shape=(1, 2, 2), devices=["cuda:0"] * 4)
    assert q.kernel_path == "halo"
    assert got == {"jacobi7_halon": 8, "jacobi7_halo": 4}
    np.testing.assert_array_equal(q.temperature(), w.temperature())
    o, got = run(3, overlap=True, mesh_shape=(1, 2, 2),
                 devices=["cuda:0"] * 4)
    assert o.kernel_path == "overlap" and got == {"jacobi7_overlap": 12}
    w16, got = run(32, device="cuda", exchange_every=16)
    assert got == {"jacobi7_wrapn": 2}
    h16, got = run(32, kernel="halo", device="cuda", exchange_every=16)
    assert got == {"jacobi7_halon": 2}
    np.testing.assert_array_equal(h16.temperature(), w16.temperature())
    with pytest.raises(TypeError, match="float32"):
        Jacobi3D(64, 64, 64, dtype=torch.float64, kernel="wrap",
                 device="cuda")
    assert Jacobi3D(64, 64, 64, dtype=torch.float64,
                    device="cuda").kernel_path == "xla"


# -- meshes over processes (parallel/multihost.py) --------------------
CARD_CASES = (("jacobi", "halo", 9), ("jacobi", "xla", 9),
              ("jacobi", "pallas", 9), ("astaroth", "halo", 2),
              ("astaroth_pair", "halo", 2))


def _one_process(model, kernel, steps):
    from stencil_tpu_torch.models.astaroth import Astaroth
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    if model == "jacobi":
        m = Jacobi3D(128, 128, 128, kernel=kernel, mesh_shape=(1, 2, 2),
                     devices=["cuda:0"] * 4)
    else:
        m = Astaroth(32, 64, 64, kernel=kernel, mesh_shape=(1, 2, 2),
                     devices=["cuda:0"] * 4,
                     exchange_every=2 if "pair" in model else None)
    m.init()
    m.run(steps)
    return ({"temp": m.temperature()} if model == "jacobi"
            else {q: m.field(q) for q in ("lnrho", "uux", "ax", "ss")})


def _spawned(tmp_path, backend, cards):
    import torch_mp_workers
    from stencil_tpu_torch.parallel.multihost import spawn_ranks

    spawn_ranks(torch_mp_workers.card_paths, 2,
                args=(str(tmp_path), cards, CARD_CASES),
                backend_name=backend, rendezvous_dir=str(tmp_path),
                timeout_s=300)
    return {f"{m}_{k}": np.load(tmp_path / f"{m}_{k}.npz")
            for m, k, _ in CARD_CASES}


def _assert_same_as_one_process(got):
    for model, kernel, steps in CARD_CASES:
        want = _one_process(model, kernel, steps)
        for q, w in want.items():
            np.testing.assert_array_equal(got[f"{model}_{kernel}"][q], w,
                                          err_msg=f"{model} {kernel} {q}")


def test_two_ranks_on_one_card_equal_one_process(cs, tmp_path):
    """Two processes on the one card, gloo (every message staged through
    host memory), two shards each of (1,2,2): Jacobi halo (B6 + B5),
    xla and pallas (K3) at 128^3 and Astaroth halo (B11; B12 with the
    pair) at 32 x 64 x 64, each bitwise the same four shards in one
    process."""
    _assert_same_as_one_process(_spawned(tmp_path, "gloo",
                                         ["cuda:0", "cuda:0"]))


def test_nccl_ranks_on_two_cards_equal_one_card(cs, tmp_path):
    """One rank a card over nccl (CUDA tensors rank to rank), the same
    cases bitwise the one-card, one-process run."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA GPUs (one nccl rank a card)")
    if not torch.distributed.is_nccl_available():
        pytest.skip("this PyTorch build has no NCCL")
    _assert_same_as_one_process(_spawned(tmp_path, "nccl",
                                         ["cuda:0", "cuda:1"]))


def test_nccl_refuses_two_ranks_on_one_card(cs, tmp_path):
    """nccl asked for two ranks on one card raises on both, naming
    gloo's host staging, before any message is sent."""
    if not torch.distributed.is_nccl_available():
        pytest.skip("this PyTorch build has no NCCL")
    with pytest.raises(Exception, match="card per rank"):
        _spawned(tmp_path, "nccl", ["cuda:0", "cuda:0"])


# ---------------------------------------------------------------------------
# ensemble serving: B4 on the member views (serving/ensemble.py)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_members", [1, 3, 8])
def test_batched_sweeps_are_one_table_of_member_views(cx, n_members, dtype):
    """Batched (N, Zp, Yp, Xp) shards of a (1,2,2) mesh: one B4 launch
    per sweep whatever N is, every member bitwise the twin's sweeps of
    its view, the plan's rows N x the shards; writing the batched tensor
    in place keeps the cached plan, a new tensor gets a new one."""
    counts = Dim3(1, 2, 2)
    radius = Radius.constant(1)
    per = [_padded_shards((12, 10, 14), (1, 2, 2), radius, dtype,
                          300 + 10 * k) for k in range(n_members)]
    batched = [torch.stack([per[k][i] for k in range(n_members)])
               for i in range(4)]
    sweeps = [(0, 1, 1), (1, 1, 1), (2, 1, 1)]
    before = cx.LAUNCHES["exchange_axis"]
    cx.start_sweeps([batched], sweeps, counts).exit()
    assert cx.LAUNCHES["exchange_axis"] == before + 3
    for k in range(n_members):
        for a, lo, hi in sweeps:
            cx.exchange_axis_plain(per[k], a, lo, hi, counts)
        for i in range(4):
            assert torch.equal(batched[i][k], per[k][i]), (k, i)
    views = cx.member_views([batched])
    plan = cx.exchange_plan(views, sweeps, counts)
    assert all(len(pc) == 1 and len(pc[0].rows) == 4 * n_members
               for pc in plan.launches)
    batched[0].mul_(2.0)
    assert cx.exchange_plan(cx.member_views([batched]), sweeps,
                            counts) is plan
    batched[0] = batched[0].clone()
    assert cx.exchange_plan(cx.member_views([batched]), sweeps,
                            counts) is not plan


class _DmaPlan:
    """A stand-in tuning plan that names PallasDMA at depth 1."""

    class config:
        method = "PallasDMA"
        exchange_every = 1

    provenance = "cached"


def test_ensemble_pallas_dma_on_card_is_bitwise_and_sync_free(cx):
    """A width-4 Jacobi ensemble on (1,2,2) of the card with a PallasDMA
    plan: run(4) is 12 B4 launches (one per sweep and step, as one
    member's) and bitwise the default method; a segment with its probe
    rows runs under the hot-loop transfer guard (any host sync
    raises)."""
    from stencil_tpu_torch.analysis.transfer import hot_loop_transfer_guard
    from stencil_tpu_torch.serving import EnsembleJacobi

    devs = ["cuda:0"] * 4

    def make(plan):
        eng = EnsembleJacobi(4, 32, 32, 32, mesh_shape=(1, 2, 2),
                             devices=devs, plan=plan)
        eng.set_member_params(3, {"hot_temp": 2.0, "cold_temp": -1.0})
        eng.init()
        for k in range(4):
            eng.set_member_interior("temp", k,
                                    _rand((32, 32, 32), 400 + k).cpu())
        return eng

    dma, ref = make(_DmaPlan()), make(None)
    torch.cuda.synchronize()
    before = cx.LAUNCHES["exchange_axis"]
    dma.run(4)
    torch.cuda.synchronize()
    assert cx.LAUNCHES["exchange_axis"] == before + 12
    ref.run(4)
    with hot_loop_transfer_guard(dma.devices):
        tr = dma.run_segment(3, probe_every=1)
    ref.run(3)
    assert tr.array.shape == (3, 4, 2, 1) and tr.array.is_cuda
    for k in range(4):
        np.testing.assert_array_equal(dma.member_interior("temp", k),
                                      ref.member_interior("temp", k))


def test_service_worker_thread_on_card(cs, tmp_path):
    """The service's ``start()`` worker thread serves on the card (its
    current device set in the thread), bitwise the drained service."""
    from stencil_tpu_torch.serving import CampaignRequest, CampaignService

    def req():
        return CampaignRequest(tenant="t0", campaign="c", grid=(32, 32, 32),
                               n_steps=4, ckpt_every=2, init_seed=3,
                               mesh_shape=(1, 2, 2))

    devs = ["cuda:0"] * 4
    svc = CampaignService(str(tmp_path / "a"), devices=devs, width=2)
    svc.start()
    try:
        got = svc.submit(req()).result(timeout=300)
    finally:
        svc.stop()
    ref = CampaignService(str(tmp_path / "b"), devices=devs, width=2)
    h = ref.submit(req())
    ref.drain()
    np.testing.assert_array_equal(got.final["temp"],
                                  h.result(timeout=0).final["temp"])
