"""The pair forms of B13 and B14 as launches of the MHD ring kernel, on
the CPU.

On the card B13's pair (launch A, ``ops/cuda_mhd_overlap``) is the 2R
sends and two launches of the ring kernel that read the shard alone
(``interior_plan``): substep 0 over z, y in [R, n - R) into the shard's
scratch f1, w1, then substep 1 over [kT, n - kT) from them. B14's pair
(launch B) is three (``fixup_plan``): substep 0 over the depth-R shell
from the shard and the landed 2R rows into f1, w1, substep 0 over the R
rows around the shard (``cuda_mhd.margin_plan``), then substep 1 over
the depth-kT shell from f1, w1 and that margin. The kernels run only on
the card (``tests/test_torch_gpu.py``); what they rest on is held here:

* the plans, read as the kernels read them: substep 0's two launches
  write every point of a shard exactly once, and so do substep 1's;
* every row a launch reads, by the ring's row rule
  (``torch_port_support.ring_row``): launch A's from the shard alone
  (its substep 1 only rows its substep 0 wrote), launch B's substep 0
  the plain window's rows from the landed 2R rows, its substep 1 a
  point that substep 0 wrote or a row of the margin layout;
* the decomposition in plain PyTorch, each launch's points from the
  rows that launch reads, bitwise equal to B12's twin on (1,1,1),
  (1,2,2) and (1,2,4) meshes, in float32 and float64.
"""

import numpy as np
import pytest
import torch

from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.models.astaroth import FIELDS, MhdParams
from stencil_tpu_torch.ops import cuda_mhd as cm
from stencil_tpu_torch.ops import cuda_mhd_overlap as mo
from stencil_tpu_torch.parallel.exchange import exchange_interior_slabs
from torch_port_support import ring_row, shell_block

R = cm.R
KT = mo.PAIR_TILE
TY = cm.RING_TILE_Y
DT = 1e-4

# (Z, Y, X) of one shard: thinner than the pair's shell (8), no pair
# interior (16), a partial 16-row tile, the main path's shard
SHAPES = [(8, 8, 5), (16, 8, 20), (8, 16, 40), (24, 24, 33), (40, 24, 16),
          (104, 128, 96), (256, 256, 256)]
# (global (Z, Y, X), mesh (x, y, z)): one shard with a pair interior,
# (1,2,2) shards of 24 x 24 (interior [8, 16)), (1,2,4) shards of 8 x 8
MESHES = [((40, 24, 20), (1, 1, 1)), ((48, 48, 20), (1, 2, 2)),
          ((32, 16, 40), (1, 2, 4))]
DTYPES = [np.float32, np.float64]


def _interior_blocks(row):
    """The blocks of one ring launch over an ``interior_plan`` row (z0,
    nz, y0, ny, zrun): the z instance's slices [s0, s1) and tile rows
    [u0, u1) (``mhd_substep_ring_kernel``)."""
    z0, nz, y0, ny, zrun = (int(v) for v in row)
    for za in range(z0, z0 + nz, zrun):
        for ya in range(y0, y0 + ny, TY):
            yield "z", (za, min(za + zrun, z0 + nz)), (ya, y0 + ny)


def _shell_blocks(p, Z, Y):
    for b in range(p.grid[1]):
        yield shell_block(p, Z, Y, b, TY)


def _written(blocks, Z, Y):
    """How often a launch's blocks compute each (z, y) of the shard."""
    got = np.zeros((Z, Y), dtype=int)
    for axis, (s0, s1), (u0, u1) in blocks:
        for s in range(s0, s1):
            for u in range(u0, min(u0 + TY, u1)):
                got[(s, u) if axis == "z" else (u, s)] += 1
    return got


def _rows_read(blocks):
    """Every (axis, slice, row) a launch's blocks load: rows u0 - R up to
    u0 + 16 + R below u1 + R, slices s0 - R to s1 + R."""
    for axis, (s0, s1), (u0, u1) in blocks:
        for p in range(s0 - R, s1 + R):
            for u in range(u0 - R, min(u0 + TY + R, u1 + R)):
                yield axis, p, u


def _launches(Z, Y, X):
    """Launch A's ring rows (substep 0, substep 1 if any) and B14's plan
    with the pair."""
    rows = mo.interior_plan(Z, Y, X, True, 132)
    return rows, mo.fixup_plan(Z, Y, X, True)


@pytest.mark.parametrize("shape", SHAPES)
def test_each_substep_writes_every_point_once(shape):
    """Substep 0: launch A over [R, n - R) and launch B's depth-R shell;
    substep 1: launch A over [kT, n - kT) (none where n <= 2 kT) and
    launch B's depth-kT shell. Each pair of launches writes every point
    of the shard exactly once, and launch A's regions are
    ``interior_region``'s."""
    Z, Y, X = shape
    rows, plan = _launches(Z, Y, X)
    assert [tuple(r[:4]) for r in rows] == [
        r for r in (mo.interior_region(Z, Y, False),
                    mo.interior_region(Z, Y, True)) if r is not None]
    s0 = (_written(_interior_blocks(rows[0]), Z, Y)
          + _written(_shell_blocks(plan.shell0, Z, Y), Z, Y))
    assert (s0 == 1).all(), shape
    s1 = _written(_shell_blocks(plan.shell, Z, Y), Z, Y)
    if len(rows) > 1:
        s1 += _written(_interior_blocks(rows[1]), Z, Y)
    assert (s1 == 1).all(), shape
    assert (plan.shell0.e, plan.shell.e) == (R, KT)


def _codes(Z, Y, X):
    """A shard whose row (z, y) holds the code of (z, y) in every x, and
    an R-row margin buffer (``margin_slabs``) likewise, float64."""
    def code(z, y):
        return (z + 50) * 1000.0 + (y + 50)

    z = torch.arange(Z, dtype=torch.float64).view(-1, 1, 1)
    y = torch.arange(Y, dtype=torch.float64).view(1, -1, 1)
    shard = code(z, y).expand(Z, Y, X).contiguous()
    buf = torch.full((8, cm.margin_plan(Z, Y, X).floats), float("nan"),
                     dtype=torch.float64)
    sl = cm.margin_slabs(buf, Z, Y, X)[FIELDS[0]]
    zr = torch.arange(-R, Z + R, dtype=torch.float64).view(-1, 1, 1)
    rows = {"zlo": (torch.arange(-R, 0.0).view(-1, 1, 1), y),
            "zhi": (torch.arange(Z, Z + R + 0.0).view(-1, 1, 1), y),
            "ylo": (zr, torch.arange(-R, 0.0).view(1, -1, 1)),
            "yhi": (zr, torch.arange(Y, Y + R + 0.0).view(1, -1, 1))}
    for k, (zz, yy) in rows.items():
        sl[k].copy_(code(zz, yy).expand_as(sl[k]))
    assert not torch.isnan(buf[0]).any()
    return dict(sl, shard=shard), code


@pytest.mark.parametrize("shape", SHAPES[:-1])
def test_substep1_reads_what_substep0_wrote_or_the_margin(shape):
    """Launch A's substep 1 reads only rows that its substep 0 wrote (it
    runs before launch B); launch B's substep 1, by the ring's row rule
    on f1 and the margin's R-row slabs (rz = ry = R), reads every row at
    the (z, y) it stands for: a point of the shard, which substep 0 wrote
    (launch A or launch B's depth-R shell), or a row of the margin
    layout. Launch A's substep 0 reads the shard alone."""
    Z, Y, X = shape
    rows, plan = _launches(Z, Y, X)
    a0 = _written(_interior_blocks(rows[0]), Z, Y)
    s0 = a0 + _written(_shell_blocks(plan.shell0, Z, Y), Z, Y)
    for axis, p, u in _rows_read(_interior_blocks(rows[0])):
        assert 0 <= p < Z and 0 <= u < Y, (p, u)
    if len(rows) > 1:
        for axis, p, u in _rows_read(_interior_blocks(rows[1])):
            assert 0 <= p < Z and 0 <= u < Y and a0[p, u] == 1, (p, u)
    bufs, code = _codes(Z, Y, X)
    geo = (Z, Y, X, R, R)
    seen = 0
    for axis, p, u in _rows_read(_shell_blocks(plan.shell, Z, Y)):
        z, y = (p, u) if axis == "z" else (u, p)
        got = ring_row(bufs, geo, axis, u, p)
        assert (got == code(z, y)).all(), (axis, p, u)
        if 0 <= z < Z and 0 <= y < Y:
            assert s0[z, y] == 1, (z, y)
        else:
            assert -R <= z < Z + R and -R <= y < Y + R, (z, y)
        seen += 1
    assert seen > 0


@pytest.mark.parametrize("size,mesh", MESHES, ids=lambda v: str(v))
def test_substep0_shell_reads_the_plain_windows_rows(size, mesh):
    """Launch B's substep 0 over the depth-R shell, from the shard and its
    landed 2R rows (rz = ry = 2R) by the ring's row rule, loads at every
    (slice, row) the row of the plain radius-R window (``halo_window``)
    at the (z, y) it stands for, bitwise."""
    Z, Y, X = size
    lz, ly = Z // mesh[2], Y // mesh[1]
    shards = _shards(size, mesh, np.float32, 71)
    slabs = exchange_interior_slabs(shards, Dim3(*mesh), y_z_extended=True,
                                    rz=2 * R, ry=2 * R)
    p = mo.fixup_plan(lz, ly, X, True).shell0
    geo = (lz, ly, X, 2 * R, 2 * R)
    for i, t in enumerate(shards):
        bufs = {k: v[0] for k, v in slabs[i].items()}
        bufs["shard"] = t[0]
        win = cm.halo_window(t[0], bufs, R)     # row (z, y) at [z+R, y+R]
        for axis, s, u in _rows_read(_shell_blocks(p, lz, ly)):
            z, y = (s, u) if axis == "z" else (u, s)
            got = ring_row(bufs, geo, axis, u, s)
            assert torch.equal(got, win[z + R, y + R]), (axis, s, u)


# ---------------------------------------------------------------------------
# the decomposition in plain PyTorch
# ---------------------------------------------------------------------------
def _shards(size, mesh, dtype, seed):
    Z, Y, X = size
    g = np.random.default_rng(seed)
    n = mesh[1] * mesh[2]
    return [torch.from_numpy(g.normal(0.0, 0.1, (8, Z // mesh[2],
                                                 Y // mesh[1], X))
                             .astype(dtype)) for _ in range(n)]


def _per_field(t):
    return dict(zip(FIELDS, t.unbind(0)))


def _substep(win, w, s, prm, za, zb, ya, yb, rr):
    """The plain substep at z in [za, zb), y in [ya, yb) from ``win``,
    whose row (z, y) is at [z + rr, y + rr]: only the rows those points
    read; w (substep 1) at those points."""
    sub = {q: win[q][za + rr - R:zb + rr + R, ya + rr - R:yb + rr + R]
           for q in FIELDS}
    wq = None if w is None else {q: w[q][za:zb, ya:yb] for q in FIELDS}
    return cm._substep_on_windows(sub, wq, s, prm, DT, write_w=True)


def _put(dst, got, z0, nz, y0, ny):
    for q in FIELDS:
        dst[q][z0:z0 + nz, y0:y0 + ny] = got[q]


def _pair_decomposed(f, slabs, prm):
    """B13's and B14's pair launch by launch: substep 0 over [R, n - R)
    from the shard alone, over the depth-R shell from the shard and the
    landed 2R rows, over the R rows around the shard (the margin, in the
    R-row slab layout); substep 1 over [kT, n - kT) from f1 and w1
    alone, and over the depth-kT shell from f1, w1 and the margin."""
    Z, Y, X = f[FIELDS[0]].shape
    nan = {q: torch.full_like(f[q], float("nan")) for q in FIELDS}
    f1, w1 = ({q: t.clone() for q, t in nan.items()} for _ in range(2))
    shard = {q: f[q] for q in FIELDS}             # row (z, y) at [z, y]
    z0, nz, y0, ny = mo.interior_region(Z, Y, False)
    got_f, got_w = _substep(shard, None, 0, prm, z0, z0 + nz, y0, y0 + ny,
                            0)
    _put(f1, got_f, z0, nz, y0, ny)
    _put(w1, got_w, z0, nz, y0, ny)
    win = {q: cm.halo_window(f[q], slabs[q], 2 * R) for q in FIELDS}
    for z0, nz, y0, ny in mo.shell_regions(Z, Y, False):
        got_f, got_w = _substep(win, None, 0, prm, z0, z0 + nz, y0,
                                y0 + ny, 2 * R)
        _put(f1, got_f, z0, nz, y0, ny)
        _put(w1, got_w, z0, nz, y0, ny)
    buf = torch.full((8, cm.margin_plan(Z, Y, X).floats), float("nan"),
                     dtype=f[FIELDS[0]].dtype)
    margin = cm.margin_slabs(buf, Z, Y, X)
    for k, (za, zb, ya, yb) in {"zlo": (-R, 0, 0, Y), "zhi": (Z, Z + R, 0, Y),
                                "ylo": (-R, Z + R, -R, 0),
                                "yhi": (-R, Z + R, Y, Y + R)}.items():
        got_f, _ = _substep(win, None, 0, prm, za, zb, ya, yb, 2 * R)
        for q in FIELDS:
            margin[q][k].copy_(got_f[q])
    assert not torch.isnan(buf).any()
    assert not any(torch.isnan(f1[q]).any() for q in FIELDS)
    out_f, out_w = ({q: t.clone() for q, t in nan.items()} for _ in range(2))
    inner = mo.interior_region(Z, Y, True)
    if inner is not None:
        z0, nz, y0, ny = inner
        got_f, got_w = _substep(f1, w1, 1, prm, z0, z0 + nz, y0, y0 + ny, 0)
        _put(out_f, got_f, z0, nz, y0, ny)
        _put(out_w, got_w, z0, nz, y0, ny)
    win1 = {q: cm.halo_window(f1[q], margin[q], R) for q in FIELDS}
    for z0, nz, y0, ny in mo.shell_regions(Z, Y, True):
        got_f, got_w = _substep(win1, w1, 1, prm, z0, z0 + nz, y0, y0 + ny,
                                R)
        _put(out_f, got_f, z0, nz, y0, ny)
        _put(out_w, got_w, z0, nz, y0, ny)
    return out_f, out_w


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("size,mesh", MESHES, ids=lambda v: str(v))
def test_decomposition_equals_b12_twin_bitwise(size, mesh, dtype):
    shards = _shards(size, mesh, dtype, 59)
    prm = MhdParams(dt=DT)
    sl = [{q: {k: v[j] for k, v in s.items()} for j, q in enumerate(FIELDS)}
          for s in exchange_interior_slabs(shards, Dim3(*mesh),
                                           y_z_extended=True, rz=2 * R,
                                           ry=2 * R)]
    for i, t in enumerate(shards):
        f = _per_field(t)
        df, dw = _pair_decomposed(f, sl[i], prm)
        pf, pw = cm.mhd_substep01_halo_plain(f, sl[i], prm, DT)
        for q in FIELDS:
            assert torch.equal(df[q], pf[q]), (i, q)
            assert torch.equal(dw[q], pw[q]), (i, q)
