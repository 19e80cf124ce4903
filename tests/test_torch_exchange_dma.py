"""The port's remote-write exchange (``Method.PallasDMA``, B4) against the
JAX package's.

JAX runs ``make_exchange(mesh, radius, Method.PallasDMA)`` over its fake
CPU devices, where ``_exchange_axis_pallas`` runs under the distributed
Pallas TPU interpreter; the port runs ``exchange_shard_cuda`` on the
same values with ``devices=["cpu"] * n``, where B4's wrapper routes to
its plain twin. Tolerance: bitwise, halos included (an exchange only
copies), and bitwise against the port's own slab method.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from stencil_tpu.geometry import Radius as JRadius
from stencil_tpu.parallel.exchange import make_exchange
from stencil_tpu.parallel.mesh import make_mesh as j_make_mesh
from stencil_tpu.parallel.methods import Method as JMethod
from stencil_tpu_torch import Boundary, Dim3, DistributedDomain, Method, Radius
from stencil_tpu_torch.ops import cuda_exchange as cx
from stencil_tpu_torch.parallel.cuda_exchange import exchange_shard_cuda
from stencil_tpu_torch.parallel.exchange import (dispatch_exchange,
                                                 exchange_shard)
from stencil_tpu_torch.parallel.methods import pick_method

jax.config.update("jax_platforms", "cpu")


def _radius(kind, pkg):
    R = JRadius if pkg == "jax" else Radius
    if kind == "asym":                   # +x 2, -x 1, nothing else
        r = R.constant(0)
        r.set_dir((1, 0, 0), 2)
        r.set_dir((-1, 0, 0), 1)
        return r
    return R.constant(kind)


def _blocks(host, counts, shard_shape):
    """The padded shards of a global padded array, x fastest."""
    pz, py, px = shard_shape
    return [host[z * pz:(z + 1) * pz, y * py:(y + 1) * py,
                 x * px:(x + 1) * px].copy()
            for z in range(counts[2]) for y in range(counts[1])
            for x in range(counts[0])]


@pytest.mark.parametrize("mesh,local,kind", [
    ((2, 2, 2), (4, 4, 4), 1),
    ((2, 2, 2), (4, 4, 4), 2),
    ((8, 1, 1), (2, 4, 4), "asym"),
], ids=["r1-222", "r2-222", "asym-811"])
def test_pallas_dma_exchange_matches_jax_bitwise(mesh, local, kind):
    """Random values in every cell (halos too): after one exchange every
    cell of every shard equals JAX's interpreted RDMA exchange and the
    port's slab method; each remote axis launches nothing on the CPU."""
    counts = Dim3(*mesh)
    jr, pr = _radius(kind, "jax"), _radius(kind, "port")
    lo, hi = pr.pad_lo(), pr.pad_hi()
    shard = (local[2] + lo.z + hi.z, local[1] + lo.y + hi.y,
             local[0] + lo.x + hi.x)
    gshape = (shard[0] * mesh[2], shard[1] * mesh[1], shard[2] * mesh[0])
    vals = np.random.default_rng(51).standard_normal(gshape).astype(
        np.float32)
    jmesh = j_make_mesh(mesh, jax.devices()[:counts.flatten()])
    ex = make_exchange(jmesh, jr, JMethod.PallasDMA)
    got = ex({"q": jax.device_put(vals, NamedSharding(jmesh,
                                                       P("z", "y", "x")))})
    want = _blocks(np.asarray(got["q"]), mesh, shard)
    port = [torch.from_numpy(b) for b in _blocks(vals, mesh, shard)]
    slab = [t.clone() for t in port]
    cx.reset_launch_counts()
    exchange_shard_cuda(port, pr, counts)
    exchange_shard(slab, pr, counts)
    assert cx.LAUNCHES["exchange_axis"] == 0
    for i, (t, s, w) in enumerate(zip(port, slab, want)):
        np.testing.assert_array_equal(t.numpy(), w, err_msg=f"shard {i}")
        assert torch.equal(t, s), i


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 3])
def test_exchange_axis_twin_writes_both_neighbours(axis, n):
    """One sweep: the right neighbour's lo halo holds my interior's last
    r_lo rows, the left neighbour's hi halo my first r_hi rows; nothing
    else changes. With two shards on the axis both halos of the one
    neighbour are written, and stay distinct."""
    r_lo, r_hi = 2, 1
    counts = [1, 1, 1]
    counts[axis] = n
    counts = Dim3(*counts)
    dim = {0: 2, 1: 1, 2: 0}[axis]
    shape = [5, 6, 7]
    shape[dim] = r_lo + 4 + r_hi
    g = np.random.default_rng(52 + axis)
    shards = [torch.from_numpy(g.standard_normal(shape).astype(np.float64))
              for _ in range(n)]
    before = [t.clone() for t in shards]
    cx.exchange_axis_cuda(shards, axis, r_lo, r_hi, counts)
    for i in range(n):
        # shard i is the right neighbour of i-1 and the left one of i+1
        prev, nxt = before[(i - 1) % n], before[(i + 1) % n]
        t = shards[i]
        assert torch.equal(t.narrow(dim, 0, r_lo), prev.narrow(dim, 4, r_lo))
        assert torch.equal(t.narrow(dim, r_lo + 4, r_hi),
                           nxt.narrow(dim, r_lo, r_hi))
        assert torch.equal(t.narrow(dim, r_lo, 4),
                           before[i].narrow(dim, r_lo, 4))


@pytest.mark.parametrize("shape,itemsize,axis,r,ptrs,unit", [
    ((514, 258, 258), 4, 2, 1, (), 16),      # z sweep of a padded 512 x 256^2
    ((514, 258, 258), 4, 1, 1, (), 8),
    ((514, 258, 258), 4, 0, 1, (), 4),       # x: one float per run
    ((10, 10, 10), 8, 0, 1, (), 8),
    ((6, 6, 8), 2, 1, 1, (), 16),
    ((6, 6, 8), 2, 1, 1, (6,), 2),           # a pointer 2 bytes off
    ((6, 6, 7), 1, 0, 1, (), 1),
])
def test_sweep_geometry_counts_in_the_widest_unit(shape, itemsize, axis, r,
                                                  ptrs, unit):
    """The planner's row for one shard at pointer ``ptrs`` (0 if none)."""
    p = ptrs[0] if ptrs else 0
    (sweep,) = cx.plan_card_sweeps([[p]], [shape], [itemsize], ["c"], axis,
                                   r, r, Dim3(1, 1, 1))
    assert sweep.unit == unit
    geo = dict(zip(cx.ENTRY_FIELDS, sweep.rows[0]))
    assert geo["src"] == geo["right"] == geo["left"] == p
    dim = {0: 2, 1: 1, 2: 0}[axis]
    inner = int(np.prod(shape[dim + 1:])) * itemsize // unit
    assert geo["runs"] == int(np.prod(shape[:dim]))
    assert geo["stride"] == shape[dim] * inner
    assert geo["lo_run"] == geo["hi_run"] == r * inner
    assert geo["lo_src_off"] == (shape[dim] - 2 * r) * inner
    assert geo["hi_dst_off"] == (shape[dim] - r) * inner


def _domain(size, mesh, method, boundary=Boundary.PERIODIC, radius=1):
    d = DistributedDomain(*size, devices=["cpu"] * (mesh[0] * mesh[1]
                                                    * mesh[2]))
    d.set_radius(radius)
    d.set_mesh_shape(mesh)
    d.set_methods(method)
    d.set_boundary(boundary)
    d.add_data("a", torch.float32)
    d.add_data("b", torch.float64)
    return d


@pytest.mark.parametrize("mesh", [(2, 2, 2), (1, 2, 2), (1, 1, 1)])
@pytest.mark.parametrize("radius", [1, 2])
def test_domain_exchange_by_pallas_dma_equals_slab(mesh, radius):
    """``set_methods(Method.PallasDMA)`` then ``exchange()``: every cell
    of every shard of both quantities equals the slab method's."""
    doms = [_domain((8, 8, 8), mesh, m, radius=radius)
            for m in (Method.PallasDMA, Method.PpermuteSlab)]
    for d in doms:
        d.realize()
    g = np.random.default_rng(53)
    for q in ("a", "b"):
        for s0, s1 in zip(doms[0].curr[q], doms[1].curr[q]):
            s0.copy_(torch.from_numpy(g.standard_normal(tuple(s0.shape))))
            s1.copy_(s0)
    for d in doms:
        d.exchange()
    for q in ("a", "b"):
        for i, (s0, s1) in enumerate(zip(doms[0].curr[q], doms[1].curr[q])):
            assert torch.equal(s0, s1), (q, i)


def test_pallas_dma_declines_what_jax_declines():
    """Uneven (+-1) grids and the zero-Dirichlet exterior raise for the
    remote-write method at realize() and in dispatch_exchange, as in
    JAX; the slab method takes both."""
    with pytest.raises(NotImplementedError, match="uneven"):
        _domain((9, 8, 8), (2, 2, 2), Method.PallasDMA).realize()
    with pytest.raises(NotImplementedError):
        _domain((8, 8, 8), (2, 2, 2), Method.PallasDMA,
                Boundary.NONE).realize()
    _domain((9, 8, 8), (2, 2, 2), Method.PpermuteSlab).realize()
    shards = [torch.zeros((6, 6, 6)) for _ in range(8)]
    with pytest.raises(NotImplementedError, match="uneven"):
        dispatch_exchange({"q": shards}, Radius.constant(1), Dim3(2, 2, 2),
                          Method.PallasDMA, rem=Dim3(1, 0, 0))
    with pytest.raises(NotImplementedError, match="non-periodic"):
        dispatch_exchange({"q": shards}, Radius.constant(1), Dim3(2, 2, 2),
                          Method.PallasDMA, nonperiodic=True)


@pytest.mark.parametrize("requested,picked", [
    (Method.PallasDMA, Method.PallasDMA),
    (Method.PallasDMA | Method.PpermuteSlab, Method.PallasDMA),
    (Method.PpermutePacked | Method.PpermuteSlab, Method.PpermutePacked),
    (Method.AllGather, Method.AllGather),
    (Method.Auto | Method.PpermuteSlab, Method.PpermuteSlab),
])
def test_pick_method_keeps_jax_priority_and_replaces_nothing(requested,
                                                             picked):
    assert pick_method(requested) == picked


def test_pick_method_auto_alone_raises():
    with pytest.raises(ValueError, match="autotuner"):
        pick_method(Method.Auto)
    with pytest.raises(ValueError):
        pick_method(Method.NONE)
