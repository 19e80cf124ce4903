"""bfloat16 on the port's Jacobi kernels against the JAX package's.

The JAX kernels compute a bfloat16 field in bfloat16: every add and the
multiply by bf16(1/6) round to bfloat16 at once, each kernel in its own
order. The port's twins (and, on the card, its kernels) do the same, so
they are held against the interpreted Pallas kernels and against JAX's
``Jacobi3D(dtype=bfloat16)`` paths BITWISE: every cell compared as its
``uint16`` bits. Inputs come from a seeded numpy generator, rounded once
to bfloat16 on the JAX side (ml_dtypes) and handed to the port as those
bits. The JAX side runs under ``reference_block_planner()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from stencil_tpu.geometry import Dim3 as JDim3
from stencil_tpu.geometry import Radius as JRadius
from stencil_tpu.local_domain import raw_size as j_raw_size
from stencil_tpu.local_domain import zyx_shape as j_zyx_shape
from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.ops import pallas_stencil as jps
from stencil_tpu.parallel.exchange import (exchange_interior_slabs as jex,
                                           shard_interior_len as j_len,
                                           shard_origin as j_origin)
from stencil_tpu.parallel.mesh import make_mesh as j_make_mesh
from stencil_tpu_torch import Dim3, Jacobi3D, Radius
from stencil_tpu_torch.convert import field_from_jax, interior_from_jax
from stencil_tpu_torch.ops import cuda_halo as ch
from stencil_tpu_torch.ops import cuda_overlap as co
from stencil_tpu_torch.ops import cuda_stencil as cs
from stencil_tpu_torch.parallel.exchange import (exchange_interior_slabs,
                                                 shard_interior_len,
                                                 shard_origin)
from stencil_tpu_torch.parallel.mesh import mesh_index
from torch_port_support import reference_block_planner, sphere_args

jax.config.update("jax_platforms", "cpu")

JBF16 = jnp.bfloat16
SLABS = ("zlo", "zhi", "ylo", "yhi")


def _bf16(shape, seed):
    """Seeded values in [0, 1) rounded once to bfloat16 (ml_dtypes)."""
    return np.random.default_rng(seed).random(shape).astype(np.float32) \
        .astype(JBF16)


def _port(a):
    """A JAX-side bfloat16 array as the port's bfloat16 tensor, by bits."""
    return interior_from_jax(np.asarray(a).view(np.uint16), torch.bfloat16)


def _bits(a):
    """The uint16 bits of a bfloat16 value array: a torch bfloat16 tensor,
    a JAX / ml_dtypes array, or the port's float32 copy of bfloat16
    values (``temperature()``)."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == torch.bfloat16
        return a.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(a)
    if a.dtype == np.float32:
        return _bits(torch.from_numpy(a).to(torch.bfloat16))
    assert a.dtype == JBF16
    return a.view(np.uint16)


def _equal(got, want, msg=""):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=msg)


@pytest.fixture
def planner():
    with reference_block_planner():
        yield


# ---------------------------------------------------------------------------
# K1, K2, K3: the twins against the interpreted kernels
# ---------------------------------------------------------------------------
def test_sixth_is_bf16_of_one_sixth():
    """The twins multiply by bf16(1/6) (0x3E2B), JAX's ``dt.type(1.0 /
    6.0)``, not by float32's 1/6."""
    six = cs.sixth(torch.bfloat16, "cpu")
    assert int(six.view(torch.int16)) == 0x3E2B
    assert float(six) == float(np.asarray(JBF16(1.0 / 6.0),
                                          dtype=np.float32))


@pytest.mark.parametrize("kernel,steps", [("wrap", 1), ("wrapn", 2),
                                          ("wrapn", 16)])
def test_wrap_twins_match_pallas_bitwise(planner, kernel, steps):
    """K1, and K2 at N = 2 and 16 (bfloat16's sublane tile: 16 rows of y,
    up to 16 steps), on a 16 x 32 x 24 field."""
    shape = (16, 32, 24)
    t = _bf16(shape, 71)
    hot, cold, r = sphere_args(shape)
    if kernel == "wrap":
        want = jps.jacobi7_wrap_pallas(jnp.asarray(t), hot, cold, r,
                                       interpret=True)
        got = cs.jacobi7_wrap_cuda(_port(t), hot, cold, r)
    else:
        want = jps.jacobi7_wrapn_pallas(jnp.asarray(t), hot, cold, r,
                                        steps=steps, interpret=True)
        got = cs.jacobi7_wrapn_cuda(_port(t), hot, cold, r, steps=steps)
    _equal(got, want)


def test_wrapn_keeps_the_bf16_rules(planner):
    """K2 in bfloat16 takes 16 steps and refuses 17, and needs y a
    multiple of 16, as JAX's kernel does."""
    hot, cold, r = sphere_args((16, 16, 16))
    for shape, steps in (((16, 16, 16), 17), ((16, 24, 16), 2)):
        t = _bf16(shape, 72)
        with pytest.raises(ValueError):
            jps.jacobi7_wrapn_pallas(jnp.asarray(t), hot, cold, r,
                                     steps=steps, interpret=True)
        with pytest.raises(ValueError):
            cs.jacobi7_wrapn_cuda(_port(t), hot, cold, r, steps=steps)


@pytest.mark.parametrize("radius", ["constant1", "asymmetric"])
def test_padded_twin_matches_pallas_bitwise(radius):
    """K3 on a 6 x 7 x 8 interior, with radius 1 and the asymmetric
    radius of tests/test_pallas.py:33-44."""
    def rad(cls):
        r = cls.constant(1)
        if radius == "asymmetric":
            r.set_dir((1, 0, 0), 2)
            r.set_dir((0, 0, -1), 3)
        return r

    jin, pin = JDim3(6, 7, 8), Dim3(6, 7, 8)
    p = _bf16(j_zyx_shape(j_raw_size(jin, rad(JRadius))), 73)
    want = jps.jacobi7_pallas(jnp.asarray(p), rad(JRadius), jin,
                              interpret=True)
    _equal(cs.jacobi7_padded_cuda(_port(p), rad(Radius), pin), want)


# ---------------------------------------------------------------------------
# B5, B6, B7: the twins against the interpreted kernels on the fake mesh
# ---------------------------------------------------------------------------
def _blocks(host, mesh, shape):
    pz, py, px = shape
    return [host[z * pz:(z + 1) * pz, y * py:(y + 1) * py,
                 x * px:(x + 1) * px]
            for z in range(mesh[2]) for y in range(mesh[1])
            for x in range(mesh[0])]


def _run_jax(g, mesh, kernel_fn):
    """``kernel_fn(p, counts) -> out`` under shard_map; per shard as
    numpy."""
    counts = JDim3(*mesh)
    jm = j_make_mesh(mesh, jax.devices()[:counts.flatten()])
    spec = P("z", "y", "x")
    fn = jax.jit(jax.shard_map(lambda p: kernel_fn(p, counts), mesh=jm,
                               in_specs=spec, out_specs=spec,
                               check_vma=False))
    out = np.asarray(fn(jax.device_put(jnp.asarray(g),
                                       NamedSharding(jm, spec))))
    return _blocks(out, mesh, (out.shape[0] // mesh[2],
                               out.shape[1] // mesh[1], out.shape[2]))


def _spheres(gzyx):
    gz, gy, gx = gzyx
    return (gx // 3, gy // 2, gz // 2), (gx * 2 // 3, gy // 2, gz // 2), \
        gx // 10 + 1


def test_halo_twin_matches_interpreted_kernel():
    """B5 on an uneven 9 x 17 x 16 grid over (1,2,2) (short shards in y
    and z), fed the halo path's own one-row slabs, live and dead cells."""
    gzyx, mesh = (9, 17, 16), (1, 2, 2)
    gz, gy, gx = gzyx
    local = (-(-gz // mesh[2]), -(-gy // mesh[1]), gx)
    rem = (0, gy % mesh[1], gz % mesh[2])
    hot, cold, r = _spheres(gzyx)
    jlocal, jrem = JDim3(local[2], local[1], local[0]), JDim3(*rem)

    def kern(p, counts):
        ox, oy, oz = j_origin(jlocal, jrem)
        org = jnp.stack([oz, oy, ox]).astype(jnp.int32)
        lens = jnp.stack([jnp.asarray(j_len(2, jlocal.z, jrem)),
                          jnp.asarray(j_len(1, jlocal.y, jrem))]
                         ).astype(jnp.int32)
        s = jex(p, counts, rz=1, ry=1, rem=jrem)
        return jacobi7_halo_pallas(p, s, org, hot, cold, r,
                                   interior_len_zy=lens, block_z=1,
                                   block_y=1)

    g = _bf16((local[0] * mesh[2], local[1] * mesh[1], gx), 74)
    with reference_block_planner():
        from stencil_tpu.ops.pallas_halo import jacobi7_halo_pallas

        want = _run_jax(g, mesh, kern)
    shards = [_port(b.copy()) for b in _blocks(g, mesh, local)]
    slabs = exchange_interior_slabs(shards, Dim3(*mesh), rz=1, ry=1,
                                    rem=Dim3(*rem))
    for i, w in enumerate(want):
        idx = Dim3(0, i % mesh[1], i // mesh[1])
        ox, oy, oz = shard_origin(Dim3(gx, local[1], local[0]), Dim3(*rem),
                                  idx)
        lens = (shard_interior_len(2, local[0], Dim3(*rem), idx.z),
                shard_interior_len(1, local[1], Dim3(*rem), idx.y))
        got = ch.jacobi7_halo_cuda(shards[i], slabs[i], (oz, oy, ox), hot,
                                   cold, r, interior_len_zy=lens)
        _equal(got, w, f"shard {i}")


@pytest.mark.parametrize("gzyx,mesh,blocks,steps", [
    ((16, 32, 30), (1, 2, 2), (4, 16), 2),
    ((32, 32, 20), (1, 1, 2), (16, 16), 16),  # two ring launches
])
def test_halon_twin_matches_interpreted_kernel(gzyx, mesh, blocks, steps):
    """B6 at N = 2 and 16 (bfloat16's limit), fed the halo path's own
    ``rz = ry = N`` slabs."""
    gz, gy, gx = gzyx
    local = (gz // mesh[2], gy // mesh[1], gx)
    hot, cold, r = _spheres(gzyx)
    bz, by = blocks
    jlocal = JDim3(gx, local[1], local[0])

    def kern(p, counts):
        ox, oy, oz = j_origin(jlocal, JDim3(0, 0, 0))
        org = jnp.stack([oz, oy, ox]).astype(jnp.int32)
        s = jex(p, counts, rz=bz, ry=16, radius_rows=steps,
                y_z_extended=True)
        return jacobi7_halon_pallas(p, s, org, gzyx, hot, cold, r,
                                    steps=steps, block_z=bz, block_y=by)

    g = _bf16(gzyx, 75)
    with reference_block_planner():
        from stencil_tpu.ops.pallas_halo import jacobi7_halon_pallas

        want = _run_jax(g, mesh, kern)
    shards = [_port(b.copy()) for b in _blocks(g, mesh, local)]
    own = exchange_interior_slabs(shards, Dim3(*mesh), rz=steps, ry=steps,
                                  y_z_extended=True)
    for i, w in enumerate(want):
        idx = Dim3(0, i % mesh[1], i // mesh[1])
        ox, oy, oz = shard_origin(Dim3(gx, local[1], local[0]),
                                  Dim3(0, 0, 0), idx)
        got = ch.jacobi7_halon_cuda(shards[i], own[i], (oz, oy, ox), gzyx,
                                    hot, cold, r, steps=steps)
        _equal(got, w, f"shard {i}")


def test_overlap_twin_matches_interpreted_kernel(monkeypatch):
    """B7 on (1,2,2), 8 x 16 x 16 shards: the new field and the four
    landed slabs, read from the kernel's ``pallas_call``."""
    import jax.experimental.pallas as pl

    from stencil_tpu.ops import pallas_overlap

    mesh, local = (1, 2, 2), (8, 16, 16)
    counts = Dim3(*mesh)
    Z, Y, X = local
    G = (Z * mesh[2], Y * mesh[1], X)
    vals = _bf16(G, 76)
    spheres = ((X // 3, G[1] // 2, G[0] // 2),
               (2 * X // 3, G[1] // 2, G[0] // 2), max(X, G[1]) // 5)
    jmesh = j_make_mesh(mesh, jax.devices()[:counts.flatten()])
    captured = []
    real = pl.pallas_call

    def spy(*args, **kw):
        call = real(*args, **kw)

        def run(*a):
            outs = call(*a)
            captured.append(outs)
            return outs
        return run

    monkeypatch.setattr(pallas_overlap.pl, "pallas_call", spy)

    def shard(q):
        ox, oy, oz = j_origin(JDim3(X, Y, Z), JDim3(0, 0, 0))
        org = jnp.stack([oz, oy, ox]).astype(jnp.int32)
        pallas_overlap.jacobi7_overlap_pallas(q, org, *spheres,
                                              JDim3(*mesh))
        return tuple(captured[-1])

    spec = P("z", "y", "x")
    sm = jax.shard_map(shard, mesh=jmesh, in_specs=spec,
                       out_specs=(spec,) * 5, check_vma=False)
    want = [np.asarray(o) for o in sm(jax.device_put(
        jnp.asarray(vals), NamedSharding(jmesh, spec)))]
    idx = [mesh_index(i, counts) for i in range(counts.flatten())]

    def block(host, m, shape):
        bz, by, bx = shape
        return host[m.z * bz:(m.z + 1) * bz, m.y * by:(m.y + 1) * by,
                    m.x * bx:(m.x + 1) * bx]

    shards = [_port(block(vals, m, local).copy()) for m in idx]
    origins = [(m.z * Z, m.y * Y, 0) for m in idx]
    out, recv = co.jacobi7_overlap_cuda(shards, origins, *spheres, counts)
    shapes = {"zlo": (1, Y, X), "zhi": (1, Y, X), "ylo": (Z, 1, X),
              "yhi": (Z, 1, X)}
    for i, m in enumerate(idx):
        _equal(out[i], block(want[0], m, local), f"shard {i}")
        for k, wk in zip(SLABS, want[1:]):
            _equal(recv.slabs[i][k], block(wk, m, shapes[k]),
                   f"shard {i} {k}")


# ---------------------------------------------------------------------------
# Jacobi3D(dtype=bfloat16): every path against JAX's same path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel,size,mesh,overlap,iters", [
    ("wrap", (24, 32, 16), (1, 1, 1), False, 3),   # one K2 pair + a K1 tail
    ("halo", (16, 32, 32), (1, 2, 2), False, 5),   # B6 pairs + a B5 tail
    ("halo", (16, 17, 18), (1, 2, 2), False, 2),   # uneven: B5 every step
    ("halo", (16, 32, 32), (1, 2, 2), True, 3),    # overlap: B7
    ("pallas", (16, 16, 16), (1, 1, 1), False, 2),
    ("xla", (16, 16, 16), (1, 2, 2), False, 2),
])
def test_model_matches_jax_bitwise(kernel, size, mesh, overlap, iters):
    n = mesh[0] * mesh[1] * mesh[2]
    with reference_block_planner():
        jj = JJacobi3D(*size, mesh_shape=mesh, dtype=JBF16,
                       devices=jax.devices()[:n], kernel=kernel,
                       overlap=overlap)
        pj = Jacobi3D(*size, dtype=torch.bfloat16, kernel=kernel,
                      overlap=overlap, mesh_shape=mesh, devices=["cpu"] * n)
        assert pj.kernel_path == jj.kernel_path
        x, y, z = size
        vals = _bf16((z, y, x), 77)
        jj.dd.set_interior("temp", vals)
        pj.load_interior(np.asarray(jj.temperature()).view(np.uint16))
        _equal(pj.temperature(), vals)
        cs.reset_launch_counts()
        jj.run(iters)
        pj.run(iters)
        _equal(pj.temperature(), jj.temperature())
    assert set(cs.LAUNCHES.values()) == {0}   # CPU: twins, no launches


def test_exchange_every_16_groups_like_jax():
    """exchange_every=16 on ``wrap``: one 16-step K2 group (bfloat16's
    tile) and a K1 tail, as JAX groups them."""
    with reference_block_planner():
        jj = JJacobi3D(16, 16, 16, mesh_shape=(1, 1, 1), dtype=JBF16,
                       devices=jax.devices()[:1], kernel="wrap",
                       exchange_every=16)
        pj = Jacobi3D(16, 16, 16, dtype=torch.bfloat16, kernel="wrap",
                      exchange_every=16, device="cpu")
        assert pj._wrap_n == 16 and pj._pair_ok
        jj.init()
        pj.init()
        jj.run(17)
        pj.run(17)
        _equal(pj.temperature(), jj.temperature())


def test_kernel_paths_take_bf16_and_refuse_f64():
    """The kernel paths take bfloat16 now; float64 keeps its refusal."""
    for kernel in ("wrap", "halo", "pallas"):
        assert Jacobi3D(16, 16, 16, dtype=torch.bfloat16, kernel=kernel,
                        device="cpu").kernel_path == kernel
        with pytest.raises(TypeError, match="float32"):
            Jacobi3D(16, 16, 16, dtype=torch.float64, kernel=kernel,
                     device="cpu")


def test_field_from_jax_takes_bf16_bits_or_values():
    a = _bf16((4, 5, 6), 78)
    r = Radius.constant(1)
    by_bits = field_from_jax(a.view(np.uint16), r, layout="interior",
                             device="cpu", dtype=torch.bfloat16)
    by_vals = field_from_jax(a.astype(np.float32), r, layout="interior",
                             device="cpu", dtype=torch.bfloat16)
    assert by_bits.dtype == torch.bfloat16 and by_bits.shape == (6, 7, 8)
    assert torch.equal(by_bits, by_vals)
    _equal(by_bits[1:-1, 1:-1, 1:-1], a)
    with pytest.raises(TypeError):
        field_from_jax((a.astype(np.float32) + np.float32(1e-4)), r,
                       device="cpu", dtype=torch.bfloat16)


def test_launcher_signatures_match_the_sources():
    """Each Jacobi launcher's ctypes signature has as many arguments as
    its extern "C" definition in ``csrc/`` (``is_bf16`` included): a
    missing one would only show on the card."""
    import re
    from pathlib import Path

    src = Path(cs.__file__).resolve().parent.parent / "csrc"
    text = "".join((src / f).read_text() for f in
                   ("jacobi7.cu", "jacobi_halo.cu", "jacobi_overlap.cu"))
    sigs = {**{k: v for k, v in cs._SIGNATURES.items()
               if not k.startswith("laplace6")},
            **ch._SIGNATURES,
            "jacobi7_overlap_inner_launch": co._SIGNATURE,
            "jacobi7_overlap_faces_launch": co._SIGNATURE}
    for name, argtypes in sigs.items():
        m = re.search(r"cudaError_t " + name + r"\(([^)]*)\)", text)
        assert m, name
        params = [p for p in m.group(1).split(",") if p.strip()]
        assert len(params) == len(argtypes), (name, len(params),
                                              len(argtypes))
        assert "is_bf16" in m.group(1), name
