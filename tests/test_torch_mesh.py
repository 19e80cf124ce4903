"""The port's mesh, partition and exchanges against the JAX package's.

JAX runs its ``DistributedDomain`` and ``exchange_interior_slabs`` over
the 8 fake CPU devices; the port runs the same mesh shape with
``devices=["cpu"] * n``. Shard i of the port (x fastest) is block
(z, y, x) = mesh position of the JAX global array. Tolerance: bitwise,
halos included — an exchange only copies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from stencil_tpu.distributed import DistributedDomain as JDomain
from stencil_tpu.geometry import Dim3 as JDim3, Radius as JRadius
from stencil_tpu.numerics import div_ceil
from stencil_tpu.parallel.exchange import (
    exchange_interior_slabs as j_exchange_interior_slabs,
    interior_slab_bytes as j_interior_slab_bytes)
from stencil_tpu.parallel.mesh import (default_mesh_shape as j_default,
                                       default_mesh_shape_xfree as j_xfree,
                                       make_mesh as j_make_mesh)
from stencil_tpu.partition import RankPartition as JRankPartition
from stencil_tpu.topology import Boundary as JBoundary
from stencil_tpu_torch import Boundary, Dim3, Radius
from stencil_tpu_torch.distributed import DistributedDomain
from stencil_tpu_torch.parallel.exchange import (exchange_interior_slabs,
                                                 interior_slab_bytes)
from stencil_tpu_torch.parallel.mesh import (Mesh, default_mesh_shape,
                                             default_mesh_shape_xfree,
                                             make_mesh, mesh_index,
                                             mesh_linear, mesh_neighbor,
                                             resolve_devices)
from stencil_tpu_torch.partition import RankPartition
from stencil_tpu_torch.placement import make_placement

jax.config.update("jax_platforms", "cpu")

BOUNDARIES = {"periodic": (JBoundary.PERIODIC, Boundary.PERIODIC),
              "none": (JBoundary.NONE, Boundary.NONE)}


def _domains(size, n, radius=1, mesh=None, boundary="periodic",
             realize=True):
    jr, pr = JRadius.constant(radius), Radius.constant(radius)
    jb, pb = BOUNDARIES[boundary]
    jd = JDomain(*size, devices=jax.devices()[:n])
    pd = DistributedDomain(*size, devices=["cpu"] * n)
    for d, r, b in ((jd, jr, jb), (pd, pr, pb)):
        d.set_radius(r)
        d.set_boundary(b)
        if mesh is not None:
            d.set_mesh_shape(mesh)
    jd.add_data("q", np.float32)
    pd.add_data("q", torch.float32)
    if realize:
        jd.realize()
        pd.realize()
    return jd, pd


@pytest.mark.parametrize("size", [(30, 16, 16), (30, 17, 9), (17, 17, 17)])
@pytest.mark.parametrize("n", range(1, 9))
def test_partition_matches_jax(size, n):
    jd, pd = _domains(size, n)
    assert tuple(pd.mesh_counts) == tuple(jd.placement.dim())
    assert tuple(pd.local_size) == tuple(jd.local_size)
    assert tuple(pd.rem) == tuple(jd.rem)
    for i in range(n):
        idx = jd.placement.part.dimensionize(i)
        assert tuple(pd.shard_index(i)) == tuple(idx)
        assert tuple(pd.shard_size(i)) == tuple(
            jd.placement.subdomain_size(idx))
        assert tuple(pd.shard_origin(i)) == tuple(
            jd.placement.subdomain_origin(idx))
    assert pd.exchange_bytes_per_axis() == jd.exchange_bytes_per_axis()
    assert pd.exchange_bytes_total() == jd.exchange_bytes_total()


@pytest.mark.parametrize("n", range(1, 9))
def test_partition_at_512_matches_jax(n):
    """512^3 without allocating it: the chosen subdomain grid and every
    subdomain's size and origin."""
    size = (512, 512, 512)
    jd, pd = _domains(size, n, realize=False)
    dim = pd._choose_partition_dim()
    assert tuple(dim) == tuple(jd._choose_partition_dim())
    jp = JRankPartition.from_dim(JDim3(*size), JDim3(*dim))
    pp = RankPartition.from_dim(Dim3(*size), dim)
    for i in range(n):
        assert tuple(pp.dimensionize(i)) == tuple(jp.dimensionize(i))
        idx = pp.dimensionize(i)
        assert tuple(pp.subdomain_size(idx)) == tuple(
            jp.subdomain_size(JDim3(*idx)))
        assert tuple(pp.subdomain_origin(idx)) == tuple(
            jp.subdomain_origin(JDim3(*idx)))
    assert all(div_ceil(size[a], dim[a]) == -(-size[a] // dim[a])
               for a in range(3))


@pytest.mark.parametrize("n", range(1, 13))
def test_default_mesh_shapes_match_jax(n):
    assert tuple(default_mesh_shape(n)) == tuple(j_default(n))
    assert tuple(default_mesh_shape_xfree(n)) == tuple(j_xfree(n))


def test_mesh_orders_devices_x_fastest_like_jax():
    """Device i of the list sits at mesh position (x, y, z) with i = x +
    X (y + Y z), as in the JAX mesh built from the same list."""
    devs = jax.devices()[:8]
    jm = j_make_mesh((2, 2, 2), devs)
    pm = make_mesh((2, 2, 2), [f"cpu:{i}" for i in range(8)])
    for i in range(8):
        x, y, z = mesh_index(i, pm.shape)
        assert jm.devices[x, y, z] == devs[i]
        assert pm.devices[i] == torch.device("cpu", i)
        assert mesh_linear((x, y, z), pm.shape) == i
    assert mesh_neighbor(0, pm.shape, 1, -1) == mesh_linear((0, 1, 0),
                                                             pm.shape)
    assert mesh_neighbor(1, pm.shape, 0, 1) == 0
    with pytest.raises(ValueError):
        Mesh((1, 2, 2), ["cpu"] * 3)


def test_devices_resolve_like_the_port_requires(monkeypatch):
    assert resolve_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert resolve_devices(None, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError):
        resolve_devices(["cpu"], "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_devices()
    with pytest.raises(RuntimeError):
        resolve_devices(["cuda:0"])


def test_placement_is_trivial_and_qap_is_not_ported():
    part = RankPartition.from_dim(Dim3(8, 8, 8), Dim3(1, 2, 2))
    pl = make_placement(part, ["cpu"] * 4)
    assert [g.device for g in pl.slot_order_for_mesh()] == \
        [torch.device("cpu")] * 4
    with pytest.raises(NotImplementedError, match="A5"):
        make_placement(part, ["cpu"] * 4, mode="qap")
    with pytest.raises(ValueError):
        make_placement(part, ["cpu"] * 4, mode="bogus")
    pd = DistributedDomain(8, 8, 8, devices=["cpu"] * 4)
    pd.set_radius(1)
    pd.add_data("q")
    pd.set_placement("qap")
    with pytest.raises(NotImplementedError, match="A5"):
        pd.realize()


def _padded_blocks(host, counts, shard_shape):
    pz, py, px = shard_shape
    return [host[z * pz:(z + 1) * pz, y * py:(y + 1) * py,
                 x * px:(x + 1) * px]
            for z in range(counts[2]) for y in range(counts[1])
            for x in range(counts[0])]


@pytest.mark.parametrize("boundary", ["periodic", "none"])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("mesh,size", [
    ((2, 2, 2), (8, 8, 8)), ((2, 2, 2), (9, 7, 5)),     # even, uneven
    ((1, 2, 2), (6, 8, 8)), ((1, 2, 2), (6, 9, 7)),
])
def test_exchange_fills_every_shard_like_jax(mesh, size, radius, boundary):
    """Random values everywhere (halos and dead capacity rows too); after
    one exchange every cell of every shard equals JAX's."""
    n = mesh[0] * mesh[1] * mesh[2]
    jd, pd = _domains(size, n, radius, mesh, boundary)
    gshape = tuple(jd.curr["q"].shape)
    vals = np.random.default_rng(41).standard_normal(gshape).astype(
        np.float32)
    jd.curr["q"] = jax.device_put(vals, NamedSharding(jd.mesh,
                                                      P("z", "y", "x")))
    shard_shape = tuple(pd.curr["q"][0].shape)
    for t, blk in zip(pd.curr["q"], _padded_blocks(vals, mesh, shard_shape)):
        t.copy_(torch.from_numpy(blk.copy()))
    jd.exchange()
    pd.exchange()
    want = _padded_blocks(np.asarray(jd.curr["q"]), mesh, shard_shape)
    for i, (t, w) in enumerate(zip(pd.curr["q"], want)):
        np.testing.assert_array_equal(t.numpy(), w, err_msg=f"shard {i}")
    assert pd.exchange_bytes_per_axis() == jd.exchange_bytes_per_axis()


def test_set_interior_and_gather_match_jax_on_uneven_mesh():
    jd, pd = _domains((9, 7, 5), 8, 1, (2, 2, 2))
    vals = np.random.default_rng(42).random((5, 7, 9)).astype(np.float32)
    jd.set_interior("q", vals)
    pd.set_interior("q", vals)
    np.testing.assert_array_equal(pd.interior_to_host("q"), vals)
    shard_shape = tuple(pd.curr["q"][0].shape)
    for t, w in zip(pd.curr["q"], _padded_blocks(np.asarray(jd.curr["q"]),
                                                 (2, 2, 2), shard_shape)):
        np.testing.assert_array_equal(t.numpy(), w)


def _jax_slabs(vals, mesh, kw):
    """JAX's per-shard slabs of a global interior-resident field."""
    counts = JDim3(*mesh)
    jm = j_make_mesh(mesh, jax.devices()[:counts.flatten()])

    def shard_fn(p):
        s = j_exchange_interior_slabs(p, counts, **kw)
        return s["zlo"], s["zhi"], s["ylo"], s["yhi"]

    spec = P("z", "y", "x")
    fn = jax.jit(jax.shard_map(shard_fn, mesh=jm, in_specs=spec,
                               out_specs=(spec,) * 4, check_vma=False))
    outs = [np.asarray(o) for o in fn(jax.device_put(
        jnp.asarray(vals), NamedSharding(jm, spec)))]
    per = []
    for o in outs:
        shape = (o.shape[0] // mesh[2], o.shape[1] // mesh[1], o.shape[2])
        per.append(_padded_blocks(o, mesh, shape))
    return [dict(zip(("zlo", "zhi", "ylo", "yhi"), blk))
            for blk in zip(*per)]


def _jax_rem(size, mesh):
    return JDim3(*(size[a] % mesh[a] for a in range(3)))


@pytest.mark.parametrize("mesh,size,kw", [
    # the single-step configuration: rz=1, ry=esub (8, or 1 on y extents
    # that are no multiple of 8), even and uneven
    ((1, 2, 2), (12, 16, 10), dict(rz=1, ry=8)),
    ((1, 2, 2), (12, 17, 9), dict(rz=1, ry=1, rem=True)),
    ((1, 1, 2), (10, 16, 9), dict(rz=1, ry=8, rem=True)),
    ((1, 1, 1), (12, 16, 10), dict(rz=1, ry=8)),
    # the N-step configuration: z-extended y slabs, JAX's rz = block_z
    # and the port's rz = N
    ((1, 2, 2), (12, 16, 16), dict(rz=4, ry=8, radius_rows=2,
                                   y_z_extended=True)),
    ((1, 2, 2), (12, 16, 16), dict(rz=2, ry=8, radius_rows=2,
                                   y_z_extended=True)),
    ((1, 2, 2), (12, 16, 16), dict(rz=4, ry=8, radius_rows=3,
                                   y_z_extended=True)),
    ((1, 1, 1), (12, 16, 16), dict(rz=8, ry=8, radius_rows=4,
                                   y_z_extended=True)),
])
def test_interior_slabs_match_jax(mesh, size, kw):
    x, y, z = size
    counts = Dim3(*mesh)
    n = counts.flatten()
    rem = tuple(size[a] % mesh[a] for a in range(3))
    kw = dict(kw)
    uneven = kw.pop("rem", False)
    assert uneven == (rem != (0, 0, 0))
    cap = tuple(-(-size[a] // mesh[a]) for a in range(3))
    # a capacity-laid-out global: every shard full of random values (the
    # dead rows of short shards too — the sends must skip them)
    g = np.random.default_rng(43).random(
        (cap[2] * mesh[2], cap[1] * mesh[1], cap[0] * mesh[0])).astype(
            np.float32)
    jkw = dict(kw, rem=_jax_rem(size, mesh)) if uneven else kw
    want = _jax_slabs(g, mesh, jkw)
    shards = [torch.from_numpy(b.copy())
              for b in _padded_blocks(g, mesh, (cap[2], cap[1], cap[0]))]
    pkw = dict(kw, rem=Dim3(*rem)) if uneven else kw
    got = exchange_interior_slabs(shards, counts, **pkw)
    assert len(got) == n
    for i in range(n):
        for k in ("zlo", "zhi", "ylo", "yhi"):
            np.testing.assert_array_equal(got[i][k].numpy(), want[i][k],
                                          err_msg=f"shard {i} {k}")
    r = kw.get("radius_rows", 1)
    ext = kw.get("y_z_extended", False)
    assert interior_slab_bytes((cap[2], cap[1], cap[0]), counts, r, 4,
                               ext) == j_interior_slab_bytes(
        (cap[2], cap[1], cap[0]), JDim3(*mesh), r, 4, ext)
