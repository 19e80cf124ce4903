"""The launch planner of the N-step Jacobi ring kernel (K2 and B6).

``ops/cuda_stencil.jacobi_ring_plan`` picks the tile, the prefetch depth
and the z run of ``csrc/jacobi_ring.cuh`` from the shape, N and the
card's SM count. Its z run is searched among ceil(Z / k) only; these
tests hold it against a brute-force minimum of waves x planes loaded
over every run 1..Z, pin the choices of the main path's shapes on an
H100 (132 SMs), and check the tile rule against the shared-memory
limits. Pure Python: no card, no JAX.
"""

import pytest

from stencil_tpu_torch.ops import cuda_stencil as cs

# (Z, Y, X): 512^3, a quarter shard of it over (1,2,2) (x is never
# split), the other orientation, the capacity shard of 512 x 511 x 509
# over (1,2,2) and that grid whole, and the small shapes of the card
# tests
SHAPES = [(512, 512, 512), (256, 256, 512), (512, 256, 256),
          (255, 256, 512), (509, 511, 512), (5, 8, 7), (9, 16, 13),
          (3, 8, 33), (1, 8, 1), (131, 64, 128), (16, 24, 20)]
SMS = (132, 114, 8)


def brute_force(Z, Y, X, steps, n_sms, ty, bps):
    """The least waves x planes loaded over every z run 1..Z."""
    return min(cs.ring_cost(Z, Y, X, steps, n_sms, ty, bps, zrun)
               for zrun in range(1, Z + 1))


@pytest.mark.parametrize("steps", range(1, 9))
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_reaches_the_brute_force_minimum(shape, steps):
    Z, Y, X = shape
    for n_sms in SMS:
        p = cs.jacobi_ring_plan(Z, Y, X, steps, n_sms)
        assert 1 <= p.zrun <= Z
        got = cs.ring_cost(Z, Y, X, steps, n_sms, p.ty, p.blocks_per_sm,
                           p.zrun)
        assert got == brute_force(Z, Y, X, steps, n_sms, p.ty,
                                  p.blocks_per_sm), (shape, steps, n_sms, p)
        # the run is one of ceil(Z / k): no shorter run gives as many blocks
        runs = -(-Z // p.zrun)
        assert p.zrun == -(-Z // runs)


def test_main_path_plans_on_an_h100():
    """The quarter shard of the (1,2,2) halo path (512 x 256 x 256,
    x y z) no longer ends on a near-empty wave: 4 runs of 64 planes of 8
    x 8 tiles are 256 blocks, one wave of two blocks on each of 132 SMs;
    512^3 is 2 runs of 256 planes of 8 x 16 tiles, also one wave."""
    q = cs.jacobi_ring_plan(256, 256, 512, 2, 132)
    assert q == cs.RingPlan(ty=32, depth=3, zrun=64, blocks_per_sm=2)
    assert 8 * 8 * (256 // q.zrun) <= 132 * q.blocks_per_sm
    f = cs.jacobi_ring_plan(512, 512, 512, 2, 132)
    assert f == cs.RingPlan(ty=32, depth=3, zrun=256, blocks_per_sm=2)
    assert 8 * 16 * (512 // f.zrun) <= 132 * f.blocks_per_sm


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("steps", range(1, 9))
def test_tile_has_the_most_rows_that_fit(steps, itemsize):
    """float32 (4-byte) and bfloat16 (2-byte) cells: the bfloat16
    instances are built for four blocks an SM (64 registers), float32's
    for three (80)."""
    ty, depth, bps = cs.ring_tile(steps, itemsize)
    assert ty in cs.RING_TILE_ROWS
    need = cs.ring_smem_bytes(steps, ty, depth, itemsize) \
        + cs.RING_STATIC_BYTES
    assert need <= cs.BLOCK_SMEM_BYTES
    assert bps * (need + cs.BLOCK_RESERVED_BYTES) <= cs.SM_SMEM_BYTES
    assert 2 <= depth <= 4
    assert 1 <= bps <= cs.SM_REGISTERS // (
        cs.RING_THREADS * cs.ring_registers(itemsize)) \
        == {4: 3, 2: 4}[itemsize]
    # every taller tile misses a block's shared memory at depth 2
    for more in cs.RING_TILE_ROWS[:cs.RING_TILE_ROWS.index(ty)]:
        assert cs.ring_blocks_per_sm(steps, more, 2, itemsize) == 0
    # the window: a margin of N rounded up to 4 columns (16-byte rows),
    # N rows; the row and sphere tables hold it
    assert cs.ring_margin(steps) % 4 == 0 and cs.ring_margin(steps) >= steps
    assert ty + 2 * steps <= cs.RING_MAX_WINDOW_ROWS
    assert cs.RING_TILE_X + 2 * cs.ring_margin(steps) \
        <= cs.RING_MAX_WINDOW_COLS


@pytest.mark.parametrize("steps,tile", [
    (1, (32, 3, 4)), (2, (32, 3, 4)), (3, (32, 2, 3)), (4, (32, 3, 2)),
    (5, (32, 4, 1)), (6, (32, 4, 1)), (7, (32, 4, 1)), (8, (16, 4, 1))])
def test_bf16_tiles_on_an_h100(steps, tile):
    """bfloat16 cells: the 64 registers of the packed instances let four
    blocks share an SM at N = 1, 2; shared memory caps N = 3, 4 at three
    and two, and N = 5..8 at one, as for float32 at N >= 3."""
    assert cs.ring_registers(2) == cs.RING_REGISTERS_BF16 == 64
    assert cs.ring_tile(steps, 2) == tile
    assert cs.ring_blocks_per_sm(steps, tile[0], tile[1], 2) == tile[2]


def test_bf16_main_path_plans_on_an_h100():
    """bfloat16 at N = 2: 512^3 is 4 runs of 128 planes of 8 x 16
    tiles, 512 blocks, one wave of four blocks on 132 SMs; the quarter
    shard 8 runs of 32 planes of 8 x 8 tiles, also 512 blocks."""
    f = cs.jacobi_ring_plan(512, 512, 512, 2, 132, 2)
    assert f == cs.RingPlan(ty=32, depth=3, zrun=128, blocks_per_sm=4)
    assert 8 * 16 * (512 // f.zrun) <= 132 * f.blocks_per_sm
    q = cs.jacobi_ring_plan(256, 256, 512, 2, 132, 2)
    assert q == cs.RingPlan(ty=32, depth=3, zrun=32, blocks_per_sm=4)
    assert 8 * 8 * (256 // q.zrun) <= 132 * q.blocks_per_sm


def test_main_path_tile_keeps_two_blocks_an_sm():
    assert cs.ring_tile(2) == (32, 3, 2)
    assert cs.ring_smem_bytes(2, 32, 3) == 4 * 10 * 72 * 36


def test_one_step_tile_is_bound_by_registers():
    """At N = 1 three blocks fit an SM by shared memory and by the
    registers the card allots (80 a thread), as the card counts; four
    would by shared memory alone."""
    assert cs.ring_tile(1) == (32, 3, 3)
    per = cs.ring_smem_bytes(1, 32, 3) + cs.RING_STATIC_BYTES \
        + cs.BLOCK_RESERVED_BYTES
    assert cs.SM_SMEM_BYTES // per == 3
    assert cs.SM_SMEM_BYTES // (cs.ring_smem_bytes(1, 32, 2)
                                + cs.RING_STATIC_BYTES
                                + cs.BLOCK_RESERVED_BYTES) == 4
    assert cs.ring_blocks_per_sm(1, 32, 2) == 3


# two kernels of a build log, as ``_build.build_all`` prints it: each
# library's lines headed ``nvcc <name>.cu:``
PTXAS_LOG = """nvcc jacobi7.cu:
ptxas info    : Compiling entry function '_Z5k2' for 'sm_90a'
ptxas info    : Function properties for _Z5k2
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 78 registers, used 1 barriers, 2560 bytes smem
nvcc mhd.cu:
ptxas info    : Compiling entry function '_Z3b9' for 'sm_90a'
ptxas info    : Function properties for _Z3b9
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 5632 bytes smem
"""


def test_ptxas_usage_reads_each_kernel_of_each_library():
    from stencil_tpu_torch.ops import _build

    assert _build.ptxas_usage(PTXAS_LOG) == {
        ("jacobi7", "_Z5k2"): dict(registers=78, spill_stores=0,
                                   spill_loads=0, static_smem=2560),
        ("mhd", "_Z3b9"): dict(registers=128, spill_stores=4,
                               spill_loads=12, static_smem=5632)}
    # a bare nvcc log carries no library line: the caller names it
    bare = PTXAS_LOG.split("nvcc mhd.cu:\n")[1]
    assert list(_build.ptxas_usage(bare, "mhd")) == [("mhd", "_Z3b9")]


@pytest.mark.parametrize("bad", [0, 9])
def test_plan_refuses_steps_outside_the_kernels_limit(bad):
    with pytest.raises(ValueError):
        cs.jacobi_ring_plan(8, 8, 8, bad, 132)
