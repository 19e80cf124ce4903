"""The port's halo-kernel twins (B5, B6) and halo plan against the JAX
package's interpreted Pallas kernels and block planner.

Each case runs the JAX kernel under ``shard_map`` on the fake CPU mesh,
as ``tests/test_halo.py`` does, and returns its slabs with its output;
the port's twin then runs per shard on those same slabs (and, for B6, on
the port's own ``rz = N`` slabs). Tolerance: bitwise on every cell —
each twin adds in its kernel's order, and Jacobi has no
``a*b+c`` for XLA to contract.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from stencil_tpu.geometry import Dim3 as JDim3
from stencil_tpu.parallel.exchange import (exchange_interior_slabs as jex,
                                           shard_interior_len as j_len,
                                           shard_origin as j_origin)
from stencil_tpu.parallel.mesh import make_mesh as j_make_mesh
from stencil_tpu_torch import Dim3
from stencil_tpu_torch.ops import cuda_halo as ch
from stencil_tpu_torch.ops.halo_plan import pair_halo_refusal
from stencil_tpu_torch.parallel.exchange import (exchange_interior_slabs,
                                                 shard_interior_len,
                                                 shard_origin)
from torch_port_support import reference_block_planner

jax.config.update("jax_platforms", "cpu")

SLABS = ("zlo", "zhi", "ylo", "yhi")


def _spheres(gzyx):
    gz, gy, gx = gzyx
    return (gx // 3, gy // 2, gz // 2), (gx * 2 // 3, gy // 2, gz // 2), \
        gx // 10 + 1


def _blocks(host, mesh, shape):
    pz, py, px = shape
    return [host[z * pz:(z + 1) * pz, y * py:(y + 1) * py,
                 x * px:(x + 1) * px]
            for z in range(mesh[2]) for y in range(mesh[1])
            for x in range(mesh[0])]


def _run_jax(g, mesh, kernel_fn):
    """``kernel_fn(p) -> (out, slabs)`` under shard_map; returns per
    shard (out, {slab: array}) as numpy."""
    counts = JDim3(*mesh)
    jm = j_make_mesh(mesh, jax.devices()[:counts.flatten()])
    spec = P("z", "y", "x")

    def shard_fn(p):
        out, s = kernel_fn(p, counts)
        return (out,) + tuple(s[k] for k in SLABS)

    fn = jax.jit(jax.shard_map(shard_fn, mesh=jm, in_specs=spec,
                               out_specs=(spec,) * 5, check_vma=False))
    res = [np.asarray(o) for o in fn(jax.device_put(
        jnp.asarray(g), NamedSharding(jm, spec)))]
    per = [_blocks(o, mesh, (o.shape[0] // mesh[2], o.shape[1] // mesh[1],
                             o.shape[2])) for o in res]
    return [(blocks[0], dict(zip(SLABS, blocks[1:])))
            for blocks in zip(*per)]


def _torch(slabs):
    return {k: torch.from_numpy(np.array(v))
            for k, v in slabs.items()}


@pytest.mark.parametrize("gzyx,mesh,blocks", [
    ((16, 16, 30), (1, 1, 1), None),
    ((9, 16, 16), (1, 1, 2), (1, 8)),    # bz=1: row Lz-1 in block nzb-2
    ((9, 17, 16), (1, 2, 2), (1, 8)),    # + uneven y
    ((10, 15, 16), (1, 2, 2), (2, 8)),   # uneven y only, small blocks
])
def test_halo_twin_matches_interpreted_kernel(gzyx, mesh, blocks):
    """B5's twin against ``jacobi7_halo_pallas`` (the cases of
    tests/test_halo.py:72-76 and a one-shard case), per shard, on live
    cells and on the dead cells of short shards, fed JAX's slabs and the
    halo path's own one-row ones (rz = ry = 1); and the port's slabs of
    JAX's shape equal JAX's."""
    gz, gy, gx = gzyx
    local = (-(-gz // mesh[2]), -(-gy // mesh[1]), gx)
    rem = (0, gy % mesh[1], gz % mesh[2])   # (x, y, z)
    esub = 8 if local[1] % 8 == 0 else 1
    hot, cold, r = _spheres(gzyx)
    jlocal = JDim3(local[2], local[1], local[0])
    jrem = JDim3(*rem)
    bkw = {} if blocks is None else dict(block_z=blocks[0],
                                         block_y=blocks[1])

    def kern(p, counts):
        ox, oy, oz = j_origin(jlocal, jrem)
        org = jnp.stack([oz, oy, ox]).astype(jnp.int32)
        lens = jnp.stack([jnp.asarray(j_len(2, jlocal.z, jrem)),
                          jnp.asarray(j_len(1, jlocal.y, jrem))]
                         ).astype(jnp.int32)
        s = jex(p, counts, rz=1, ry=esub, rem=jrem)
        return jacobi7_halo_pallas(p, s, org, hot, cold, r,
                                   interior_len_zy=lens, **bkw), s

    g = np.random.default_rng(51).random(
        (local[0] * mesh[2], local[1] * mesh[1], gx)).astype(np.float32)
    with reference_block_planner():
        from stencil_tpu.ops.pallas_halo import jacobi7_halo_pallas

        want = _run_jax(g, mesh, kern)
    shards = [torch.from_numpy(b.copy()) for b in _blocks(g, mesh, local)]
    own = exchange_interior_slabs(shards, Dim3(*mesh), rz=1, ry=esub,
                                  rem=Dim3(*rem))
    thin = exchange_interior_slabs(shards, Dim3(*mesh), rz=1, ry=1,
                                   rem=Dim3(*rem))
    for i, (wout, wslabs) in enumerate(want):
        idx = Dim3(0, i % mesh[1], i // mesh[1])
        ox, oy, oz = shard_origin(Dim3(gx, local[1], local[0]), Dim3(*rem),
                                  idx)
        lz = shard_interior_len(2, local[0], Dim3(*rem), idx.z)
        ly = shard_interior_len(1, local[1], Dim3(*rem), idx.y)
        for k in SLABS:
            np.testing.assert_array_equal(own[i][k].numpy(), wslabs[k])
        for slabs in (_torch(wslabs), thin[i]):
            got = ch.jacobi7_halo_cuda(shards[i], slabs, (oz, oy, ox), hot,
                                       cold, r, interior_len_zy=(lz, ly))
            # live cells, then every cell: the dead capacity row and
            # column of a short shard follow the JAX kernel's rule too
            np.testing.assert_array_equal(got.numpy()[:lz, :ly],
                                          wout[:lz, :ly], err_msg=f"shard {i}")
            np.testing.assert_array_equal(got.numpy(), wout,
                                          err_msg=f"shard {i}, dead cells")


@pytest.mark.parametrize("mesh,blocks,steps", [
    ((1, 1, 1), (4, 8), 2),   # nzg=4, nyg=2 on one shard (wrapped slabs)
    ((1, 2, 2), (4, 8), 2),   # sharded + interior blocks both axes
    ((1, 2, 2), (2, 8), 2),   # bz=2 == steps: thinnest legal z block
    ((1, 2, 2), (4, 8), 3),   # depth 3: radius-3 exchange, deeper rings
    ((1, 1, 2), (8, 8), 4),   # depth 4 on a z-split mesh
])
def test_halon_twin_matches_interpreted_kernel(mesh, blocks, steps):
    """B6's twin against ``jacobi7_halon_pallas`` on the cases of
    tests/test_halo.py:146-152, fed JAX's ``rz = block_z``, ``ry = 8``
    slabs; the halo path's own ``rz = ry = N`` slabs give the same
    output."""
    gzyx = (16, 16, 30)
    gz, gy, gx = gzyx
    local = (gz // mesh[2], gy // mesh[1], gx)
    hot, cold, r = _spheres(gzyx)
    bz, by = blocks
    jlocal = JDim3(gx, local[1], local[0])

    def kern(p, counts):
        ox, oy, oz = j_origin(jlocal, JDim3(0, 0, 0))
        org = jnp.stack([oz, oy, ox]).astype(jnp.int32)
        s = jex(p, counts, rz=bz, ry=8, radius_rows=steps, y_z_extended=True)
        return jacobi7_halon_pallas(p, s, org, gzyx, hot, cold, r,
                                    steps=steps, block_z=bz,
                                    block_y=by), s

    g = np.random.default_rng(52).random(gzyx).astype(np.float32)
    with reference_block_planner():
        from stencil_tpu.ops.pallas_halo import jacobi7_halon_pallas

        want = _run_jax(g, mesh, kern)
    shards = [torch.from_numpy(b.copy()) for b in _blocks(g, mesh, local)]
    own = exchange_interior_slabs(shards, Dim3(*mesh), rz=steps, ry=steps,
                                  y_z_extended=True)
    for i, (wout, wslabs) in enumerate(want):
        idx = Dim3(0, i % mesh[1], i // mesh[1])
        ox, oy, oz = shard_origin(Dim3(gx, local[1], local[0]),
                                  Dim3(0, 0, 0), idx)
        for slabs in (_torch(wslabs), own[i]):
            got = ch.jacobi7_halon_cuda(shards[i], slabs, (oz, oy, ox), gzyx,
                                        hot, cold, r, steps=steps)
            np.testing.assert_array_equal(got.numpy(), wout,
                                          err_msg=f"shard {i}")


def test_halon_wraps_sphere_coordinates_across_the_mesh_edge():
    """A sphere on the shard edge at global z = 0: the ring below it
    wraps to the top of the global grid (floor modulo); shards of a
    (1,1,4) mesh against the one-shard run, bitwise."""
    gzyx = (16, 8, 16)
    hot, cold = (4, 4, 0), (12, 4, 15)
    g = np.random.default_rng(53).random(gzyx).astype(np.float32)
    one = ch.jacobi7_halon_cuda(
        torch.from_numpy(g), exchange_interior_slabs(
            [torch.from_numpy(g)], Dim3(1, 1, 1), rz=2, ry=8,
            radius_rows=2, y_z_extended=True)[0],
        (0, 0, 0), gzyx, hot, cold, 3, steps=2)
    shards = [torch.from_numpy(g[4 * k:4 * k + 4].copy()) for k in range(4)]
    slabs = exchange_interior_slabs(shards, Dim3(1, 1, 4), rz=2, ry=8,
                                    radius_rows=2, y_z_extended=True)
    got = torch.cat([ch.jacobi7_halon_cuda(s, sl, (4 * k, 0, 0), gzyx, hot,
                                           cold, 3, steps=2)
                     for k, (s, sl) in enumerate(zip(shards, slabs))])
    assert torch.equal(got, one)


def test_wrappers_check_their_inputs():
    t = torch.rand(4, 8, 6)
    s = exchange_interior_slabs([t], Dim3(1, 1, 1), rz=1, ry=8)[0]
    with pytest.raises(TypeError, match="float32"):
        ch.jacobi7_halo_cuda(t.double(), {k: v.double() for k, v in s.items()},
                             (0, 0, 0), (1, 4, 2), (3, 4, 2), 1)
    with pytest.raises(ValueError, match="z-extended|shape"):
        ch.jacobi7_halon_cuda(t, s, (0, 0, 0), (4, 8, 6), (1, 4, 2),
                              (3, 4, 2), 1, steps=1)
    s2 = exchange_interior_slabs([t], Dim3(1, 1, 1), rz=2, ry=8,
                                 radius_rows=2, y_z_extended=True)[0]
    with pytest.raises(ValueError, match="cannot feed 3 step"):
        ch.jacobi7_halon_cuda(t, s2, (0, 0, 0), (4, 8, 6), (1, 4, 2),
                              (3, 4, 2), 1, steps=3)
    with pytest.raises(ValueError, match="interior lengths"):
        ch.jacobi7_halo_cuda(t, s, (0, 0, 0), (1, 4, 2), (3, 4, 2), 1,
                             interior_len_zy=(2, 8))
    ch.reset_launch_counts()
    ch.jacobi7_halo_cuda(t, s, (0, 0, 0), (1, 4, 2), (3, 4, 2), 1)
    assert ch.LAUNCHES == {"jacobi7_halo": 0, "jacobi7_halon": 0}


PLAN_SWEEP = list(itertools.product(
    (1, 2, 3, 4, 6, 16, 17, 32, 48),   # Z
    (8, 9, 16, 24, 256),               # Y
    (16, 512, 4096, 8192),             # X
    (1, 2, 3, 8)))                     # steps


def test_halo_plan_agrees_with_the_jax_planner():
    """``pair_halo_refusal`` is None exactly where
    ``fit_pair_halo_blocks`` returns a blocking, over a sweep of shard
    shapes and step counts."""
    with reference_block_planner():
        from stencil_tpu.analysis.tiling import TilingInfeasibleError
        from stencil_tpu.ops.pallas_halo import fit_pair_halo_blocks

        seen = {True: 0, False: 0}
        for Z, Y, X, N in PLAN_SWEEP:
            try:
                fit_pair_halo_blocks(Z, Y, X, 4, N)
                legal = True
            except TilingInfeasibleError:
                legal = False
            assert (pair_halo_refusal(Z, Y, X, 4, N) is None) == legal, \
                (Z, Y, X, N)
            seen[legal] += 1
    assert seen[True] and seen[False]
