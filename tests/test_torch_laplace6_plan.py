"""The launch planner of B8's ring kernel (laplace6).

``ops/cuda_stencil.laplace6_plan`` picks the z run of
``csrc/laplace6.cu`` from the shape and the card's SM count. These
tests hold its z run against a brute-force minimum of waves x planes
loaded over every run 1..Z, check that its shared memory fits the
blocks an SM it counts, pin the 256^3 plan on an H100 (132 SMs), and
model the kernel's indexing: its output stores (every output written
once, odd z runs walking down) and its copy of a window plane (every
shared-memory cell of every window row written once). Pure Python: no
card, no JAX.
"""

import numpy as np
import pytest

from stencil_tpu_torch.ops import cuda_stencil as cs

# (Z, Y, X): Astaroth's per-rank grid, the ragged shape of the timing
# app, the small shapes of the card tests, a z run with a shorter last
# one, shapes wider than one tile in every axis, and the card tests'
# layout shape
SHAPES = [(256, 256, 256), (136, 128, 96), (5, 7, 33), (1, 8, 1),
          (131, 64, 128), (8, 8, 8), (16, 8, 24), (37, 70, 130),
          (29, 37, 70)]
SMS = (132, 114, 8)


def brute_force(Z, Y, X, n_sms, bps):
    """The least waves x planes loaded over every z run 1..Z."""
    return min(cs.ring_cost(Z, Y, X, cs.LAPLACE6_R, n_sms, cs.LAPLACE6_TY,
                            bps, zrun) for zrun in range(1, Z + 1))


@pytest.mark.parametrize("n_sms", SMS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_reaches_the_brute_force_minimum(shape, n_sms):
    Z, Y, X = shape
    p = cs.laplace6_plan(Z, Y, X, n_sms)
    assert p.blocks_per_sm == cs.laplace6_blocks_per_sm() >= 1
    assert 1 <= p.zrun <= Z
    got = cs.ring_cost(Z, Y, X, cs.LAPLACE6_R, n_sms, cs.LAPLACE6_TY,
                       p.blocks_per_sm, p.zrun)
    assert got == brute_force(Z, Y, X, n_sms, p.blocks_per_sm)
    # the run is one of ceil(Z / k): no shorter run gives as many blocks
    assert p.zrun == -(-Z // -(-Z // p.zrun))


def stored_outputs(Z, Y, X, zrun):
    """How often the kernel stores each output, as csrc/laplace6.cu
    indexes them: block (bx, by, bz) of the grid (ceil(X / 64), ceil(Y /
    32), ceil(Z / zrun)) streams planes z0 - 3 .. z1 + 2 of its run [z0,
    z1), upwards from zs = z0 - 3 or, in odd runs, downwards from zs = z1
    + 2; its output pointer starts at plane zs + 3 dz and moves dz a
    plane in each of the passes 6 .. nload - 1 (nload = z1 - z0 + 6);
    thread (tx, ty) stores columns x0 + 4 tx + e, e < 4, of rows y0 + 2
    ty + r, r < 2, where they lie inside the interior. A plane outside
    the interior is not masked: it fails here."""
    R, ty_rows = cs.LAPLACE6_R, cs.LAPLACE6_TY
    hits = np.zeros((Z, Y, X), dtype=np.int32)
    lanes = np.arange(16)
    cols = (4 * lanes[:, None] + np.arange(4)).ravel()
    rows = (2 * lanes[:, None] + np.arange(2)).ravel()
    for bz in range(-(-Z // zrun)):
        z0 = bz * zrun
        z1 = min(z0 + zrun, Z)
        dz = -1 if bz & 1 else 1
        zs = z1 - 1 + R if dz < 0 else z0 - R
        nload = z1 - z0 + 2 * R
        planes = np.array([zs + dz * R + dz * (i - 2 * R)
                           for i in range(2 * R, nload)])
        assert ((planes >= 0) & (planes < Z)).all(), planes
        for by in range(-(-Y // ty_rows)):
            ys = by * ty_rows + rows
            ys = ys[ys < Y]
            for bx in range(-(-X // cs.RING_TILE_X)):
                xs = bx * cs.RING_TILE_X + cols
                xs = xs[xs < X]
                hits[np.ix_(planes, ys, xs)] += 1
    return hits


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_stores_every_output_once(shape):
    Z, Y, X = shape
    p = cs.laplace6_plan(Z, Y, X, 132)
    assert (stored_outputs(Z, Y, X, p.zrun) == 1).all()


def test_ring_fits_the_blocks_an_sm_it_counts():
    need = cs.LAPLACE6_SMEM_BYTES
    assert need == 4 * 6 * 72 * 40 <= cs.BLOCK_SMEM_BYTES
    bps = cs.laplace6_blocks_per_sm()
    # two blocks an SM, which the registers cap
    assert bps == 2
    assert bps * (need + cs.BLOCK_RESERVED_BYTES) <= cs.SM_SMEM_BYTES
    assert bps * cs.LAPLACE6_THREADS * cs.LAPLACE6_REGISTERS \
        <= cs.SM_REGISTERS


def test_astaroth_plan_on_an_h100():
    """256^3 on 132 SMs: 4 x 8 tiles of 64 x 32 in 8 runs of 32 planes,
    256 blocks: one wave of two blocks an SM."""
    p = cs.laplace6_plan(256, 256, 256, 132)
    assert p == cs.Laplace6Plan(zrun=32, blocks_per_sm=2)
    blocks = 4 * (256 // cs.LAPLACE6_TY) * (256 // p.zrun)
    assert blocks == 256 <= 132 * p.blocks_per_sm
    # the ragged shape of the timing app: 2 x 4 tiles in 28 runs, 27 of
    # 5 planes and the last of 1: 224 blocks, one wave
    q = cs.laplace6_plan(136, 128, 96, 132)
    assert q == cs.Laplace6Plan(zrun=5, blocks_per_sm=2)
    assert 136 % q.zrun == 1 and 2 * 4 * 28 <= 132 * q.blocks_per_sm


def copied_cells(chunk):
    """Which shared-memory cells of one window plane the kernel's copy
    writes, as csrc/laplace6.cu lays it out: warp w copies full rows w +
    8 m, a lane ``chunk`` floats at column chunk * lane (and 32 further
    for 4-byte copies), and leftover group q = w + 8 u of (8 / chunk)
    cells a row for 32 / (8 / chunk) rows at columns 64 + chunk * (lane
    % cells) of rows q * rows_a_group + lane / cells."""
    rows = cs.LAPLACE6_WINDOW_ROWS
    pitch = cs.LAPLACE6_PITCH
    hits = np.zeros((rows, pitch), dtype=np.int32)
    full = 2 // chunk
    cells = 8 // chunk
    per_group = 32 // cells
    groups = rows // per_group
    assert rows % 8 == 0 and rows % per_group == 0
    for warp in range(8):
        for lane in range(32):
            for m in range(rows // 8):
                for f in range(full):
                    c = chunk * lane + 32 * f
                    hits[warp + 8 * m, c:c + chunk] += 1
            for u in range(-(-groups // 8)):
                q = warp + 8 * u
                if q < groups:
                    c = 64 + chunk * (lane % cells)
                    hits[q * per_group + lane // cells, c:c + chunk] += 1
    return hits


@pytest.mark.parametrize("chunk", [1, 2])
def test_copy_writes_every_window_cell_once(chunk):
    assert (copied_cells(chunk) == 1).all()
    # the window: the tile's rows and 3 on each side, 64 columns and 4
    # on each side
    assert cs.LAPLACE6_WINDOW_ROWS >= cs.LAPLACE6_TY + 2 * cs.LAPLACE6_R
    assert cs.LAPLACE6_PITCH == cs.RING_TILE_X + 8


def test_jacobi_ring_plans_are_unchanged():
    """B8 reuses ``ring_cost``; K2's and B6's plans stay as they were."""
    assert cs.jacobi_ring_plan(512, 512, 512, 2, 132) == cs.RingPlan(
        ty=32, depth=3, zrun=256, blocks_per_sm=2)
    assert cs.jacobi_ring_plan(256, 256, 512, 2, 132) == cs.RingPlan(
        ty=32, depth=3, zrun=64, blocks_per_sm=2)
