"""The port's Jacobi overlap paths against the JAX package's.

* B7's twin (``jacobi7_overlap_plain``, and ``jacobi7_overlap_cuda`` on
  CPU shards) against ``jacobi7_overlap_pallas`` run interpreted under
  ``jax.shard_map`` over the fake CPU devices: the new field and the four
  landed slabs, which the JAX function computes as outputs of its
  ``pallas_call`` but does not return, so the test reads them from the
  call itself.
* ``split_regions`` and the path selection against JAX's.

The models' overlap paths are held against JAX's in
``tests/test_torch_overlap_model.py``. Tolerance: bitwise — the twin
keeps each region's order of additions, and Jacobi has no ``a*b+c`` for
XLA to contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from stencil_tpu.geometry import Dim3 as JDim3, Radius as JRadius
from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.parallel.exchange import shard_origin as j_shard_origin
from stencil_tpu.parallel.mesh import make_mesh as j_make_mesh
from stencil_tpu.parallel.overlap import split_regions as j_split_regions
from stencil_tpu_torch import Dim3, Jacobi3D, Radius
from stencil_tpu_torch.models.jacobi import select_kernel_path
from stencil_tpu_torch.ops import cuda_overlap as co
from stencil_tpu_torch.parallel.mesh import mesh_index
from stencil_tpu_torch.parallel.overlap import split_regions
from torch_port_support import reference_block_planner

jax.config.update("jax_platforms", "cpu")

SLABS = ("zlo", "zhi", "ylo", "yhi")


def _jax_overlap_kernel(monkeypatch, vals, mesh, local_zyx, spheres):
    """The field and the four slab buffers ``jacobi7_overlap_pallas``
    produces on every shard, as global arrays (the slabs' blocks laid
    out like the field's)."""
    import jax.experimental.pallas as pl

    from stencil_tpu.ops import pallas_overlap

    hot, cold, r = spheres
    counts = JDim3(*mesh)
    Z, Y, X = local_zyx
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
        ox, oy, oz = j_shard_origin(JDim3(X, Y, Z), JDim3(0, 0, 0))
        org = jnp.stack([oz, oy, ox]).astype(jnp.int32)
        pallas_overlap.jacobi7_overlap_pallas(q, org, hot, cold, r, counts)
        return tuple(captured[-1])

    spec = P("z", "y", "x")
    sm = jax.shard_map(shard, mesh=jmesh, in_specs=spec,
                       out_specs=(spec,) * 5, check_vma=False)
    outs = sm(jax.device_put(vals, NamedSharding(jmesh, spec)))
    return [np.asarray(o) for o in outs]


def _block(host, idx, shape):
    bz, by, bx = shape
    return host[idx.z * bz:(idx.z + 1) * bz, idx.y * by:(idx.y + 1) * by,
                idx.x * bx:(idx.x + 1) * bx]


@pytest.mark.parametrize("mesh,local", [
    ((1, 2, 2), (8, 16, 16)),
    ((1, 2, 4), (8, 16, 16)),
    ((1, 1, 1), (8, 16, 16)),
    ((1, 4, 1), (4, 2, 24)),          # the smallest shard the kernel takes
], ids=["122", "124", "111", "141-thin"])
def test_overlap_twin_matches_jax_kernel_bitwise(monkeypatch, mesh, local):
    counts = Dim3(*mesh)
    Z, Y, X = local
    G = (Z * mesh[2], Y * mesh[1], X)
    vals = np.random.default_rng(61).random(G).astype(np.float32)
    spheres = ((X // 3, G[1] // 2, G[0] // 2),
               (2 * X // 3, G[1] // 2, G[0] // 2), max(X, G[1]) // 5)
    want = _jax_overlap_kernel(monkeypatch, vals, mesh, local, spheres)
    idx = [mesh_index(i, counts) for i in range(counts.flatten())]
    shards = [torch.from_numpy(_block(vals, m, local).copy()) for m in idx]
    origins = [(m.z * Z, m.y * Y, 0) for m in idx]
    new, slabs = co.jacobi7_overlap_plain(shards, origins, *spheres, counts)
    co.reset_launch_counts()
    out, recv = co.jacobi7_overlap_cuda(shards, origins, *spheres, counts)
    assert co.LAUNCHES["jacobi7_overlap"] == 0       # CPU: the twin
    shapes = {"zlo": (1, Y, X), "zhi": (1, Y, X), "ylo": (Z, 1, X),
              "yhi": (Z, 1, X)}
    for i, m in enumerate(idx):
        w = _block(want[0], m, local)
        np.testing.assert_array_equal(new[i].numpy(), w, err_msg=f"shard {i}")
        np.testing.assert_array_equal(out[i].numpy(), w)
        for k, wk in zip(SLABS, want[1:]):
            ws = _block(wk, m, shapes[k])
            np.testing.assert_array_equal(slabs[i][k].numpy(), ws,
                                          err_msg=f"shard {i} {k}")
            np.testing.assert_array_equal(recv.slabs[i][k].numpy(), ws)


@pytest.mark.parametrize("r", [0, 1, 2, 3])
@pytest.mark.parametrize("local", [(8, 6, 5), (4, 4, 4), (9, 3, 7),
                                   (1, 8, 8)])
def test_split_regions_matches_jax(r, local):
    jr, pr = JRadius.constant(r), Radius.constant(r)
    if r == 3:                           # an asymmetric radius
        for R in (jr, pr):
            R.set_dir((1, 0, 0), 2)
            R.set_dir((0, -1, 0), 0)
    ji, je = j_split_regions(jr, JDim3(*local))
    pi, pe = split_regions(pr, Dim3(*local))
    assert [(tuple(o), tuple(d)) for o, d in pi] == \
        [(tuple(o), tuple(d)) for o, d in ji]
    assert [(tuple(o), tuple(d)) for o, d in pe] == \
        [(tuple(o), tuple(d)) for o, d in je]


COMBOS = [(overlap, kernel, mesh, size)
          for overlap in (False, True)
          for kernel in ("auto", "halo", "xla", "pallas", "wrap")
          for mesh, size in (((1, 1, 1), (16, 16, 16)),
                             ((1, 2, 2), (16, 16, 16)),
                             ((2, 2, 1), (16, 16, 16)),
                             ((1, 2, 2), (16, 16, 6)))]   # local z = 3


@pytest.mark.parametrize("overlap,kernel,mesh,size", COMBOS)
def test_kernel_path_matches_jax(monkeypatch, overlap, kernel, mesh, size):
    """The path both packages build for each overlap flag, kernel and
    mesh: the port on the CPU against JAX off the TPU, and the port's
    on-CUDA choice against JAX's on-TPU choice (``on_tpu`` patched for the
    JAX model's selection; nothing is compiled for a TPU). A kernel a
    package refuses raises the same error class in both."""
    from stencil_tpu.ops import pallas_stencil

    n = mesh[0] * mesh[1] * mesh[2]
    for accel in (False, True):
        monkeypatch.setattr(pallas_stencil, "on_tpu", lambda a=accel: a)
        with reference_block_planner():
            try:
                jj = JJacobi3D(*size, mesh_shape=mesh, dtype=np.float32,
                               devices=jax.devices()[:n], kernel=kernel,
                               overlap=overlap)
                want = jj.kernel_path
            except (ValueError, NotImplementedError) as e:
                want = type(e)
        pd = Jacobi3D(*size, kernel="xla", mesh_shape=mesh,
                      devices=["cpu"] * n).dd
        try:
            got = select_kernel_path(kernel, overlap, pd.mesh_counts, pd.rem,
                                     pd.local_size, True, False, accel, True)
        except (ValueError, NotImplementedError) as e:
            got = type(e)
        assert got == want, (accel, got, want)
        if not accel and isinstance(want, str):
            pj = Jacobi3D(*size, kernel=kernel, overlap=overlap,
                          mesh_shape=mesh, devices=["cpu"] * n)
            assert pj.kernel_path == want


@pytest.mark.parametrize("flags,method", [([], "PpermuteSlab"),
                                          (["--pallas-dma"], "PallasDMA"),
                                          (["--packed", "--slab"],
                                           "PpermutePacked")])
def test_jacobi3d_app_names_the_method_that_ran(capsys, flags, method):
    from stencil_tpu_torch.apps import jacobi3d

    jacobi3d.main(["--x", "6", "--y", "6", "--z", "6", "--mesh-shape",
                   "2,2,2", "--device", "cpu", "--kernel", "xla", "--iters",
                   "1", "--batch", "1", *flags])
    line = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert line[:3] == ["jacobi3d", method, "8"]
    assert line[11] == "xla"


def test_measure_overlap_app_line_and_mhd_refusal(capsys):
    from stencil_tpu_torch.apps import measure_overlap

    measure_overlap.main(["--x", "8", "--y", "8", "--z", "8", "--iters", "2",
                          "--mesh-shape", "1,2,2", "--devices",
                          "cpu,cpu,cpu,cpu"])
    line = capsys.readouterr().out.strip().split(",")
    assert line[:5] == ["measure_overlap", "4", "8", "16", "16"]
    t_ex, t_fused, t_over, eff = map(float, line[5:])
    assert min(t_ex, t_fused, t_over) > 0
    assert eff == pytest.approx((t_fused - t_over) / t_ex, abs=1e-3)
    res = measure_overlap.measure(8, 8, 8, iters=1, mesh_shape=(1, 2, 2),
                                  devices=["cpu"])
    assert (res["fused_path"], res["overlap_path"]) == ("halo", "overlap")
    # --model mhd, once refused, runs B13/B14's path (their twins here)
    res = measure_overlap.measure_mhd(16, 8, 8, iters=1,
                                      mesh_shape=(1, 2, 2), devices=["cpu"])
    assert (res["fused_path"], res["overlap_path"]) == ("halo",
                                                        "halo-overlap")
