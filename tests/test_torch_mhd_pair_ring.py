"""B12 (and B10) as launches of the MHD ring kernel, on the CPU.

On the card B12 (``ops/cuda_mhd.mhd_substep01_halo_cuda``) is three
launches of the ring kernel: B11 s=0 over the shard, substep 0 over the
R rows around the shard (``margin_plan``, ``csrc/mhd_margin.cuh``
mhd_margin_kernel) from its slabs of 2R rows, written in the R-row slab
layout, then B11 s=1 from those rows. The kernels run only on the card
(``tests/test_torch_gpu.py``); what they rest on is held here:

* B12's twin equals B11's twin s=0, a radius-R slab round
  (``exchange_interior_slabs``) and B11's twin s=1, bitwise, on (1,1,1),
  (1,2,2) and (1,2,4) meshes, with JAX's slab layout and exact rows, in
  float32 and float64 (the wrap counterpart is in
  tests/test_torch_mhd_pair.py);
* the margin plan, read as the kernel reads it (modelled below): its
  blocks write every float of the R-row slab layout exactly once, each
  at the slab position of its point; every row a block reads, by the
  ring's row rule, lies in the 2R slabs and is the plain window's row;
  shards thinner than a tile included;
* the decomposition in plain PyTorch — substep 0 on the shard and on
  each of the plan's blocks from the radius-2R window, then substep 1
  from the R-row slabs so made — equals B12's twin bitwise.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.models.astaroth import FIELDS, MhdParams
from stencil_tpu_torch.ops import cuda_mhd as cm
from stencil_tpu_torch.parallel.exchange import exchange_interior_slabs
from torch_port_support import ring_row

R = cm.R
TY = cm.RING_TILE_Y
DT = 1e-4

# (global (Z, Y, X), mesh (x, y, z)): x not a multiple of 32; the (1,2,4)
# shards (8, 8, 40) are thinner in y than a tile's 16 rows
MESHES = [((16, 8, 20), (1, 1, 1)), ((32, 32, 20), (1, 2, 2)),
          ((32, 16, 40), (1, 2, 4))]
LAYOUTS = {"exact": dict(rz=2 * R, ry=2 * R),
           "jax": dict(rz=8, ry=8, radius_rows=2 * R)}
DTYPES = [np.float32, np.float64]
# (Z, Y, X) of one shard for the plan: Z and Y below a tile, X below 32
# columns, the main path's shard
SHAPES = [(8, 8, 5), (8, 16, 40), (16, 8, 20), (24, 32, 33), (40, 24, 16),
          (104, 128, 96), (256, 256, 256)]


def _shards(size, mesh, dtype, seed):
    Z, Y, X = size
    g = np.random.default_rng(seed)
    n = mesh[1] * mesh[2]
    return [torch.from_numpy(g.normal(0.0, 0.1, (8, Z // mesh[2],
                                                 Y // mesh[1], X))
                             .astype(dtype)) for _ in range(n)]


def _per_field(t):
    return dict(zip(FIELDS, t.unbind(0)))


def _slabs(shards, mesh, **kw):
    return [{q: {k: v[j] for k, v in sl.items()} for j, q in enumerate(FIELDS)}
            for sl in exchange_interior_slabs(shards, Dim3(*mesh),
                                              y_z_extended=True, **kw)]


def _equal(got, want):
    return all(torch.equal(got[q], want[q]) for q in FIELDS)


# ---------------------------------------------------------------------------
# (a) the twin: B12 = B11 s=0 -> a radius-R slab round -> B11 s=1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("size,mesh", MESHES, ids=lambda v: str(v))
def test_b12_twin_equals_b11_round_b11_bitwise(size, mesh, layout, dtype):
    shards = _shards(size, mesh, dtype, 31)
    prm = MhdParams(dt=DT)
    sl0 = _slabs(shards, mesh, rz=R, ry=R)
    one = [cm.mhd_substep_halo_plain(_per_field(t), None, sl, 0, prm, DT)
           for t, sl in zip(shards, sl0)]
    f1 = [torch.stack([f[q] for q in FIELDS]) for f, _ in one]
    sl1 = _slabs(f1, mesh, rz=R, ry=R)
    sl12 = _slabs(shards, mesh, **LAYOUTS[layout])
    for i, t in enumerate(shards):
        f2, w2 = cm.mhd_substep_halo_plain(_per_field(f1[i]), one[i][1],
                                           sl1[i], 1, prm, DT)
        pf, pw = cm.mhd_substep01_halo_plain(_per_field(t), sl12[i], prm, DT)
        assert _equal(pf, f2) and _equal(pw, w2), i
        moved = max(float((pf[q] - t[j]).abs().max())
                    for j, q in enumerate(FIELDS))
        assert moved > 0.0


# ---------------------------------------------------------------------------
# (b) the margin plan, read as the kernel reads it
# ---------------------------------------------------------------------------
def _kernel_block(p, Z, Y, b):
    """csrc/mhd_margin.cuh mhd_margin_kernel reading MarginPlan p: the
    instance, the slices [s0, s1), the tile rows (u0, u1: rows u0 to
    min(u0 + 16, u1) computed) and the output map (off, zs) of block row
    b."""
    assert b < 2 * (p.tz + p.ty)
    if b < 2 * p.tz:
        far = b >= p.tz
        b -= p.tz if far else 0
        s0 = Z if far else -R
        return ("z", (s0, s0 + R), (b * TY, Y),
                (p.zhi if far else p.zlo, p.zs))
    b -= 2 * p.tz
    far = b >= p.ty
    b -= p.ty if far else 0
    s0 = Y if far else -R
    return ("y", (s0, s0 + R), (-R + b * TY, Z + R),
            (p.yhi if far else p.ylo, p.ys))


def _blocks(Z, Y, X):
    p = cm.margin_plan(Z, Y, X)
    return p, [_kernel_block(p, Z, Y, b) for b in range(p.grid[1])]


def _points(block):
    """(z, y) of every point a block computes (ring_run's live points)."""
    axis, (s0, s1), (u0, u1), _ = block
    for s in range(s0, s1):
        for u in range(u0, min(u0 + TY, u1)):
            yield (s, u) if axis == "z" else (u, s)


@pytest.mark.parametrize("shape", SHAPES)
def test_margin_blocks_write_the_r_slab_layout_once(shape):
    """Every float of a field's margin buffer is written by exactly one
    block's point, through its strip's output map, and the point is the
    one the R-row slab (``margin_slabs``, ``exchange_interior_slabs``'
    layout) holds there."""
    Z, Y, X = shape
    p, blocks = _blocks(Z, Y, X)
    assert p.grid[0] == -(-X // 32)
    hits = np.zeros(p.floats, dtype=int)
    zval = np.full(p.floats, 10 ** 6)
    yval = np.full(p.floats, 10 ** 6)
    for blk in blocks:
        off, zs = blk[3]
        for z, y in _points(blk):
            og = off + z * zs + y * X + np.arange(X)
            assert og.min() >= 0 and og.max() < p.floats, (blk, z, y)
            hits[og] += 1
            zval[og], yval[og] = z, y
    assert (hits == 1).all(), shape
    z_of, y_of = (cm.margin_slabs(torch.from_numpy(v).expand(8, -1), Z, Y,
                                  X)[FIELDS[0]] for v in (zval, yval))
    assert z_of["zlo"].shape == (R, Y, X)
    assert z_of["ylo"].shape == (Z + 2 * R, R, X)
    zr = torch.arange(Z + 2 * R).view(-1, 1, 1) - R
    want = {"zlo": (torch.arange(R).view(-1, 1, 1) - R,
                    torch.arange(Y).view(1, -1, 1)),
            "zhi": (torch.arange(R).view(-1, 1, 1) + Z,
                    torch.arange(Y).view(1, -1, 1)),
            "ylo": (zr, torch.arange(R).view(1, -1, 1) - R),
            "yhi": (zr, torch.arange(R).view(1, -1, 1) + Y)}
    for k, (wz, wy) in want.items():
        assert (z_of[k] == wz).all() and (y_of[k] == wy).all(), k


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("size,mesh", [((16, 8, 20), (1, 1, 1)),
                                       ((16, 16, 5), (1, 2, 2)),
                                       ((32, 16, 40), (1, 2, 4))],
                         ids=lambda v: str(v))
def test_margin_blocks_read_rows_of_the_2r_slabs(size, mesh, layout):
    """Every row a block of the margin loads — rows u0 - R to u0 + 16 + R
    of the tile below u1 + R, slices s0 - R to s1 + R — assembled from
    the shard and its slabs of 2R rows by the ring's row rule, lies in
    its buffer and equals, bitwise, the row of the radius-2R plain window
    at (z, y)."""
    shards = _shards(size, mesh, np.float32, 41)
    kw = LAYOUTS[layout]
    slabs = exchange_interior_slabs(shards, Dim3(*mesh), y_z_extended=True,
                                    **kw)
    Z, Y, X = shards[0].shape[1:]
    _, blocks = _blocks(Z, Y, X)
    geo = (Z, Y, X, kw["rz"], kw["ry"])
    for i, t in enumerate(shards):
        bufs = {k: v[0] for k, v in slabs[i].items()}
        bufs["shard"] = t[0]
        win = cm.halo_window(t[0], bufs, 2 * R)    # row (z, y) at [z+2R, y+2R]
        for axis, (s0, s1), (u0, u1), _ in blocks:
            for p in range(s0 - R, s1 + R):
                for u in range(u0 - R, min(u0 + TY + R, u1 + R)):
                    z, y = (p, u) if axis == "z" else (u, p)
                    got = ring_row(bufs, geo, axis, u, p)
                    assert torch.equal(got, win[z + 2 * R, y + 2 * R]), (
                        axis, p, u)


def test_margin_ints_follow_the_kernels_plan_struct():
    """``MarginPlan.ints()`` is copied byte for byte into the kernel's
    MarginPlan: the same fields in the same order."""
    src = (Path(cm.__file__).resolve().parents[1] / "csrc"
           / "mhd_margin.cuh").read_text()
    body = re.search(r"struct MarginPlan \{(.*?)\};", src, re.S).group(1)
    fields = [n.strip() for decl in re.findall(r"int ([\w, ]+);", body)
              for n in decl.split(",")]
    assert fields == list(cm.MarginPlan._fields[:8])
    assert "constexpr int kMarginPlanInts = 8;" in src


def test_main_path_margin_plan():
    """A 256^3 shard: z strips of 16 row tiles, z-extended y strips of
    17, 8 column tiles: 528 blocks of one an SM (4 waves on 132 SMs)."""
    p = cm.margin_plan(256, 256, 256)
    assert (p.tz, p.ty) == (16, 17) and p.grid == (8, 66)
    assert p.floats == 2 * R * 256 * 256 + 2 * 262 * R * 256


# ---------------------------------------------------------------------------
# (c) the decomposition in plain PyTorch
# ---------------------------------------------------------------------------
def _decomposed(f, slabs, prm):
    """Substep 0 on the shard (B11's twin) and on every block of the
    margin plan (the plain substep on the block's radius-R window, cut
    from the radius-2R window of the shard and its slabs), written
    through the blocks' output maps into a margin buffer; then B11's
    twin s=1 from the R-row slabs of that buffer."""
    Z, Y, X = f[FIELDS[0]].shape
    f1, w1 = cm.mhd_substep_halo_plain(f, None, slabs, 0, prm, DT)
    p, blocks = _blocks(Z, Y, X)
    dtype = f[FIELDS[0]].dtype
    buf = torch.full((8, p.floats), float("nan"), dtype=dtype)
    win = {q: cm.halo_window(f[q], slabs[q], 2 * R) for q in FIELDS}
    for axis, (s0, s1), (u0, u1), (off, zs) in blocks:
        u1 = min(u0 + TY, u1)
        if u1 <= u0:
            continue
        (za, zb), (ya, yb) = (((s0, s1), (u0, u1)) if axis == "z"
                              else ((u0, u1), (s0, s1)))
        sub = {q: win[q][za + R:zb + 3 * R, ya + R:yb + 3 * R] for q in FIELDS}
        got, _ = cm._substep_on_windows(sub, None, 0, prm, DT, write_w=False)
        z = torch.arange(za, zb).view(-1, 1, 1)
        y = torch.arange(ya, yb).view(1, -1, 1)
        og = (off + z * zs + y * X + torch.arange(X).view(1, 1, -1)).reshape(-1)
        for j, q in enumerate(FIELDS):
            buf[j, og] = got[q].reshape(-1)
    assert not torch.isnan(buf).any()
    return cm.mhd_substep_halo_plain(f1, w1, cm.margin_slabs(buf, Z, Y, X),
                                     1, prm, DT)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("size,mesh", MESHES, ids=lambda v: str(v))
def test_decomposition_equals_b12_twin_bitwise(size, mesh, dtype):
    shards = _shards(size, mesh, dtype, 53)
    prm = MhdParams(dt=DT)
    sl = _slabs(shards, mesh, **LAYOUTS["exact"])
    for i, t in enumerate(shards):
        f = _per_field(t)
        df, dw = _decomposed(f, sl[i], prm)
        pf, pw = cm.mhd_substep01_halo_plain(f, sl[i], prm, DT)
        assert _equal(df, pf) and _equal(dw, pw), i
