"""B14's plan on the CPU (``ops/cuda_mhd_overlap.fixup_plan``) and a
model of the rows its ring kernel reads.

The kernel (``csrc/mhd_overlap.cu`` mhd_shell_kernel on
``csrc/mhd_ring.cuh`` ring_run) runs only on the card
(``tests/test_torch_gpu.py``). What surrounds it is pure integers and
tensor indexing, and is held here: the plan's strips, with
``interior_region``, cover every point of a shard exactly once (with
one substep and with the pair, whose three launches
``tests/test_torch_overlap_pair_ring.py`` holds); the ints the plan
hands the kernel, read as the kernel reads them (modelled below), walk
exactly the plan's strips, in the field order of the kernel's ShellPlan
and PairPlan; and the margin rows of the z and the y instance,
assembled from the shard and the landed slabs by the kernel's row rule
(a base at slice -1, 0 or N plus a stride), are the rows of the plain
window (``ops/cuda_mhd.halo_window``, which ``mhd_substep_fixup_plain``
reads), bit for bit.
"""

import numpy as np
import pytest
import torch

from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.ops import cuda_mhd as cm
from stencil_tpu_torch.ops import cuda_mhd_overlap as mo
from stencil_tpu_torch.parallel.exchange import exchange_interior_slabs
from torch_port_support import ring_row, shell_block

R = cm.R
TY = cm.RING_TILE_Y

# (Z, Y, X): Z - 2R not a multiple of 16 (250, 18, 1), Y = 8, Z = 7 (one
# y-strip row of z), X below a 32-column tile, and the main path's shard
SHAPES = [(256, 256, 256), (24, 24, 16), (24, 8, 24), (40, 32, 40),
          (7, 16, 5), (8, 8, 5), (5, 8, 12), (104, 128, 96), (16, 200, 33)]


def _shell_points(Z, Y, pair):
    hits = np.zeros((Z, Y), dtype=int)
    plan = mo.fixup_plan(Z, Y, 8, pair)
    for st in plan.strips:
        z0, nz, y0, ny = st.region
        assert nz > 0 and ny > 0
        hits[z0:z0 + nz, y0:y0 + ny] += 1
    return hits, plan


def _pair_shape(Z, Y, X):
    """The pair takes shards of whole kT = 8 tiles (Z and Y multiples of
    8, as every MHD shard is)."""
    return Z % mo.PAIR_TILE == 0 and Y % mo.PAIR_TILE == 0


@pytest.mark.parametrize("shape,pair", [(s, False) for s in SHAPES]
                         + [(s, True) for s in SHAPES if _pair_shape(*s)])
def test_plan_and_interior_cover_the_shard_once(shape, pair):
    """The plan's strips and ``interior_region`` cover the shard once;
    with the pair the strips are the depth-kT shell of substep 1 (three
    launches: the depth-R shell of substep 0, the margin, that shell),
    the plan walked by the shell launch, and substep 0's depth-R shell
    with the one-substep interior covers the shard once too."""
    Z, Y, X = shape
    hits, plan = _shell_points(Z, Y, pair)
    inner = mo.interior_region(Z, Y, pair)
    if inner is not None:
        z0, nz, y0, ny = inner
        hits[z0:z0 + nz, y0:y0 + ny] += 1
    assert (hits == 1).all(), shape
    assert [st.region for st in plan.strips] == mo.shell_regions(Z, Y, pair)
    assert plan.launches == (3 if pair else 1)
    assert plan.shell.e == mo.shell_width(pair)
    assert {st.axis for st in plan.strips} <= {"z", "y"}
    if not pair:
        assert plan.shell0 is None and plan.margin is None
        return
    plan = mo.fixup_plan(Z, Y, X, True)
    assert plan.shell0 == mo.fixup_plan(Z, Y, X, False).shell
    assert plan.margin == cm.margin_plan(Z, Y, X)
    hits = _walked(plan.shell0, Z, Y)
    z0, nz, y0, ny = mo.interior_region(Z, Y, False)
    hits[z0:z0 + nz, y0:y0 + ny] += 1
    assert (hits == 1).all(), shape


@pytest.mark.parametrize("shape", SHAPES)
def test_one_substep_plan_is_one_launch_of_strip_tiles(shape):
    """One launch a shard, no scratch; the z strips (every y) come first
    and are walked in z, the y strips in y; each strip's tiles just cover
    its broad axis, and the grid holds every strip's tiles."""
    Z, Y, X = shape
    plan = mo.fixup_plan(Z, Y, X, False)
    assert plan.launches == 1
    tiles = 0
    for st in plan.strips:
        z0, nz, y0, ny = st.region
        if st.axis == "z":
            assert (y0, ny) == (0, Y) and nz <= R
            broad = Y
        else:
            assert st.axis == "y" and (z0, nz) == (R, Z - 2 * R) and ny <= R
            broad = nz
        assert (st.tiles - 1) * TY < broad <= st.tiles * TY
        tiles += st.tiles
    assert plan.shell.grid == (-(-X // 32), tiles)
    assert len(plan.shell.ints()) == 7 and plan.shell.e == R
    assert (plan.ints() == plan.shell.ints()).all()


@pytest.mark.parametrize("pair", [False, True])
def test_main_path_plan(pair):
    """A 256^3 shard: four strips of 16 row tiles, 8 column tiles, 512
    blocks of one an SM (3.9 waves on 132 SMs); with the pair that launch
    (substep 0, into the scratch), the margin's 528 blocks and the
    depth-8 shell's 496 (its y strips span 240 rows of z, 15 tiles)."""
    plan = mo.fixup_plan(256, 256, 256, pair)
    shell = plan.shell0 if pair else plan.shell
    assert [st.axis for st in plan.strips] == ["z", "z", "y", "y"]
    assert shell.grid == (8, 64)
    assert mo.FIXUP_BLOCKS_PER_SM == 1
    if not pair:
        assert [st.tiles for st in plan.strips] == [16, 16, 16, 16]
        return
    assert [st.tiles for st in plan.strips] == [16, 16, 15, 15]
    assert plan.shell.grid == (8, 62) and plan.margin.grid == (8, 66)
    assert plan.ints().size == 22


def test_shell_ints_follow_the_kernels_plan_struct():
    """``ShellLaunch.ints()`` is copied byte for byte into the kernel's
    ShellPlan: the same fields in the same order; the pair's
    ``FixupPlan.ints()`` into PairPlan: substep 0's shell, the margin,
    substep 1's shell."""
    import re
    from pathlib import Path

    src = (Path(mo.__file__).resolve().parents[1] / "csrc"
           / "mhd_overlap.cu").read_text()
    body = re.search(r"struct ShellPlan \{(.*?)\};", src, re.S).group(1)
    fields = [n.strip() for decl in re.findall(r"int ([\w, ]+);", body)
              for n in decl.split(",")]
    assert fields == list(mo.ShellLaunch._fields[:7])
    assert "constexpr int kShellPlanInts = 7;" in src
    body = re.search(r"struct PairPlan \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"(\w+) (\w+);", body) == [
        ("ShellPlan", "shell0"), ("MarginPlan", "margin"),
        ("ShellPlan", "shell1")]
    assert ("constexpr int kPairPlanInts = 2 * kShellPlanInts + "
            "kMarginPlanInts;") in src
    plan = mo.fixup_plan(40, 32, 40, True)
    assert plan.ints().tolist() == (list(plan.shell0.ints())
                                    + list(plan.margin.ints())
                                    + list(plan.shell.ints()))


def _walked(p, Z, Y):
    """How often the blocks of ShellPlan p compute each (z, y)."""
    got = np.zeros((Z, Y), dtype=int)
    for b in range(p.grid[1]):
        axis, (s0, s1), (u0, u1) = shell_block(p, Z, Y, b, TY)
        rows = slice(u0, min(u0 + TY, u1))
        if axis == "z":
            got[s0:s1, rows] += 1
        else:
            got[rows, s0:s1] += 1
    return got


@pytest.mark.parametrize("shape,pair", [(s, False) for s in SHAPES]
                         + [(s, True) for s in SHAPES if _pair_shape(*s)])
def test_kernel_blocks_walk_the_plans_strips(shape, pair):
    """The plan's ints, read as the kernel reads them, block row by block
    row, compute exactly the points of the plan's strips, each once, in
    the strips' order and orientation (with the pair, the shell launch
    of substep 1, depth kT)."""
    Z, Y, X = shape
    plan = mo.fixup_plan(Z, Y, X, pair)
    want, _ = _shell_points(Z, Y, pair)
    got = np.zeros((Z, Y), dtype=int)
    b = 0
    for st in plan.strips:
        for _ in range(st.tiles):
            axis, (s0, s1), (u0, u1) = shell_block(plan.shell, Z, Y, b, TY)
            assert axis == st.axis
            rows = slice(u0, min(u0 + TY, u1))
            if axis == "z":
                got[s0:s1, rows] += 1
            else:
                got[rows, s0:s1] += 1
            b += 1
    assert b == plan.shell.grid[1]
    assert (got == want).all(), shape


# ---------------------------------------------------------------------------
# the margin rows: the kernel's row rule against the plain window
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", [dict(rz=3, ry=3), dict(rz=8, ry=8)])
@pytest.mark.parametrize("size,mesh", [((48, 48, 16), (1, 2, 2)),
                                       ((48, 16, 24), (1, 2, 2)),
                                       ((16, 8, 20), (1, 1, 1))])
def test_ring_rows_are_the_plain_windows_rows(size, mesh, layout):
    """For every strip and every slice its blocks load, each margin row
    the z instance (z strips: rows y at plane z) or the y instance (y
    strips: rows z at slice y) assembles from the shard and the landed
    slabs equals, bitwise, the row of ``halo_window`` at (z, y): exact
    rows (rz = ry = 3, the path's) and JAX's wider layout (8)."""
    Z, Y, X = size
    counts = Dim3(*mesh)
    g = np.random.default_rng(11)
    n = mesh[1] * mesh[2]
    lz, ly = Z // mesh[2], Y // mesh[1]
    shards = [torch.from_numpy(g.normal(0, 1, (1, lz, ly, X))
                               .astype(np.float32)) for _ in range(n)]
    slabs = exchange_interior_slabs(shards, counts, y_z_extended=True,
                                    **layout)
    plan = mo.fixup_plan(lz, ly, X, False)
    for i in range(n):
        bufs = {k: v[0] for k, v in slabs[i].items()}
        bufs["shard"] = shards[i][0]
        geo = (lz, ly, X, layout["rz"], layout["ry"])
        win = cm.halo_window(shards[i][0], bufs, R)   # row (z, y) at [z+R, y+R]
        checked = 0
        for st in plan.strips:
            z0, nz, y0, ny = st.region
            if st.axis == "z":
                slices, rows = range(z0 - R, z0 + nz + R), range(-R, ly + R)
            else:
                slices, rows = range(y0 - R, y0 + ny + R), range(z0 - R,
                                                                 z0 + nz + R)
            for p in slices:
                for u in rows:
                    z, y = (p, u) if st.axis == "z" else (u, p)
                    got = ring_row(bufs, geo, st.axis, u, p)
                    assert torch.equal(got, win[z + R, y + R]), (st, p, u)
                    checked += 1
        assert checked > 0
