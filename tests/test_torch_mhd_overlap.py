"""B13's and B14's plain twins against the JAX package's MHD overlap
kernels.

``mhd_substep_overlap_plain`` (B13), ``mhd_substep_fixup_plain`` (B14)
and the composed substep ``mhd_substep_overlap`` of
``stencil_tpu_torch/ops/cuda_mhd_overlap.py`` — and the CUDA wrappers on
CPU shards, which run those twins — are held against
``mhd_substep_overlap_pallas`` and ``mhd_substep_overlap`` of
``stencil_tpu/ops/pallas_mhd_overlap.py``, run interpreted under
``jax.shard_map`` over the fake CPU devices (inside
``reference_block_planner``, which their block planner needs). The JAX
composed substep returns only the new f and w; B13's outputs (f and w with
placeholder edge blocks, and the landed slabs) are read from its
``pallas_call``, the first of its calls.

Local shards (Z, Y, X) = (24, 24, 16) with ``block_z = block_y = 8``:
JAX's grid is 3 x 3 blocks, so both of its fix-up strips run. Compared:

* B13's f and w on JAX's non-edge blocks, z in [8, 16), y in [8, 16)
  (its edge blocks hold placeholders; the port's interior is wider);
* the landed slabs on their valid rows (JAX's layout has rz = 8 and 8-row
  y slabs, the port's exact rows): bitwise, since they are copies;
* the composed substep on the whole shard;
* the port's composed substep against the port's B11 (B12 with the pair)
  twin on the same shards and slabs: bitwise.

Tolerance (``torch_port_support.assert_mhd_fields_match``, the B11
rule): float32 per field 64 eps(f32) x max |jax|; float64 rtol 1e-11,
atol 1e-13 — jax 0.9's CPU compiler contracts a*b+c into FMAs.
"""

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from stencil_tpu.geometry import Dim3 as JDim3
from stencil_tpu.models.astaroth import MhdParams as JParams
from stencil_tpu.parallel.mesh import make_mesh as j_make_mesh
from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.models.astaroth import FIELDS, MhdParams
from stencil_tpu_torch.ops import cuda_mhd as cm
from stencil_tpu_torch.ops import cuda_mhd_overlap as mo
from stencil_tpu_torch.parallel.mesh import mesh_index
from torch_port_support import (assert_mhd_fields_match,
                                reference_block_planner)

jax.config.update("jax_platforms", "cpu")

LOCAL = (24, 24, 16)     # (Z, Y, X) per shard
BLK = 8                  # JAX's block_z = block_y, and its slab rows
DT = 1e-4


def _block(host, idx, shape):
    bz, by, bx = shape
    return host[idx.z * bz:(idx.z + 1) * bz, idx.y * by:(idx.y + 1) * by,
                idx.x * bx:(idx.x + 1) * bx]


def _jax_overlap(monkeypatch, f, w, s, mesh, pair, write_w):
    """(B13's outputs per shard, keyed by its (y, z) mesh position, the
    composed substep's (f, w) as global arrays): B13's are ``nf`` f, ``nwo`` w,
    then the zlo, zhi, ylo and yhi slabs of each field."""
    import jax.experimental.pallas as pl

    counts = JDim3(*mesh)
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

    b13 = {}

    def keep(iy, iz, *arrs):
        b13[(int(iy), int(iz))] = [np.asarray(a) for a in arrs]

    spec = P("z", "y", "x")
    fspec = {q: spec for q in FIELDS}
    with reference_block_planner():
        from stencil_tpu.ops import pallas_mhd_overlap as pmo

        monkeypatch.setattr(pmo.pl, "pallas_call", spy)

        def shard(fd, *wd):
            f1, w1 = pmo.mhd_substep_overlap(
                fd, wd[0] if wd else None, s, JParams(dt=DT), DT, counts,
                block_z=BLK, block_y=BLK, pair=pair, write_w=write_w)
            # B13's outputs leave through a host callback: returned from
            # shard_map beside the final ones, the interpreted kernels of
            # this jax never finish
            jax.debug.callback(keep, lax.axis_index("y"),
                               lax.axis_index("z"), *captured[0])
            return (f1,) + ((w1,) if write_w else ())

        sm = jax.shard_map(
            shard, mesh=jmesh, in_specs=(fspec,) * (1 if w is None else 2),
            out_specs=(fspec,) + ((fspec,) if write_w else ()),
            check_vma=False)

        def put(d):
            return {q: jax.device_put(jnp.asarray(v),
                                      NamedSharding(jmesh, spec))
                    for q, v in d.items()}

        outs = jax.block_until_ready(
            sm(put(f), *([] if w is None else [put(w)])))
        f1 = outs[0]
        w1 = outs[1] if write_w else None
        monkeypatch.undo()
    np_ = lambda d: None if d is None else {   # noqa: E731
        q: np.asarray(v) for q, v in d.items()}
    return b13, np_(f1), np_(w1)


def _shards(g, mesh):
    counts = Dim3(*mesh)
    idx = [mesh_index(i, counts) for i in range(counts.flatten())]
    if g is None:
        return None
    return [{q: torch.from_numpy(_block(g[q], m, LOCAL).copy())
             for q in FIELDS} for m in idx]


CASES = [((1, 2, 2), np.float32, 0, False, True, False),
         ((1, 2, 2), np.float64, 1, True, True, False),
         ((1, 2, 2), np.float32, 2, True, False, False),
         ((1, 2, 2), np.float32, 0, False, True, True),
         ((1, 1, 2), np.float64, 1, True, True, False),
         ((1, 1, 2), np.float32, 2, True, False, False),
         ((1, 1, 2), np.float64, 0, False, True, True),
         ((1, 2, 2), np.float64, 0, False, True, True)]
CASE_IDS = [f"{''.join(map(str, m))}-{np.dtype(d).name}-"
            + ("pair" if pr else f"s{s}{'' if rw else '-w_none'}"
               f"{'' if ww else '-no_w_out'}")
            for m, d, s, rw, ww, pr in CASES]


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def case(request):
    """One variant run through JAX's interpreted kernels and the port's
    twins on the same seeded shards."""
    mesh, dtype, s, read_w, write_w, pair = request.param
    G = (LOCAL[0] * mesh[2], LOCAL[1] * mesh[1], LOCAL[2])
    rng = np.random.default_rng(6100 + 7 * s + mesh[1])
    f = {q: (0.1 * rng.normal(size=G)).astype(dtype) for q in FIELDS}
    w = ({q: (1e-4 * rng.normal(size=G)).astype(dtype) for q in FIELDS}
         if read_w else None)
    mp = pytest.MonkeyPatch()
    try:
        b13, jf, jw = _jax_overlap(mp, f, w, s, mesh, pair, write_w)
    finally:
        mp.undo()
    return dict(mesh=mesh, dtype=dtype, s=s, write_w=write_w, pair=pair,
                f=_shards(f, mesh), w=_shards(w, mesh),
                b13=b13, jf=jf, jw=jw)


def _jax_shard(g, i, mesh):
    m = mesh_index(i, Dim3(*mesh))
    return {q: _block(g[q], m, LOCAL) for q in FIELDS}


def test_b13_twin_matches_jax_interior_and_slabs(case):
    mesh, dt = case["mesh"], case["dtype"]
    counts = Dim3(*mesh)
    prm = MhdParams(dt=DT)
    nf, nw, slabs = mo.mhd_substep_overlap_plain(
        case["f"], case["w"], case["s"], prm, DT, counts, pair=case["pair"],
        write_w=case["write_w"])
    nfo = len(FIELDS)
    base = nfo * (2 if case["write_w"] else 1)
    hr = mo.halo_rows(case["pair"])
    Z, Y, X = LOCAL
    inner = (slice(BLK, Z - BLK), slice(BLK, Y - BLK))
    zs = slice(BLK - hr, BLK + Z + hr)
    for i in range(counts.flatten()):
        m = mesh_index(i, counts)
        b13 = case["b13"][(m.y, m.z)]
        assert_mhd_fields_match(
            {q: nf[i][q].numpy()[inner] for q in FIELDS},
            {q: b13[k][inner] for k, q in enumerate(FIELDS)}, dt)
        if case["write_w"]:
            assert_mhd_fields_match(
                {q: nw[i][q].numpy()[inner] for q in FIELDS},
                {q: b13[nfo + k][inner] for k, q in enumerate(FIELDS)}, dt)
        else:
            assert nw is None
        for k, q in enumerate(FIELDS):
            zlo, zhi, ylo, yhi = (b13[base + j * nfo + k] for j in range(4))
            assert zlo.shape == (BLK, Y, X) and ylo.shape == (Z + 2 * BLK,
                                                              BLK, X)
            want = {"zlo": zlo[BLK - hr:], "zhi": zhi[:hr],
                    "ylo": ylo[zs, BLK - hr:], "yhi": yhi[zs, :hr]}
            for name, v in want.items():
                np.testing.assert_array_equal(slabs[i][q][name].numpy(), v,
                                              err_msg=f"shard {i} {q} {name}")


def test_composed_substep_matches_jax_and_the_halo_twin(case):
    """The port's composed substep (the CUDA wrappers on CPU shards: the twins)
    against JAX's whole shard, and bitwise against the port's B11 (B12)
    twin on the same landed rows."""
    mesh, dt = case["mesh"], case["dtype"]
    counts = Dim3(*mesh)
    prm = MhdParams(dt=DT)
    mo.reset_launch_counts()
    f1, w1, recv = mo.mhd_substep_overlap(
        case["f"], case["w"], case["s"], prm, DT, counts, pair=case["pair"],
        write_w=case["write_w"])
    assert mo.LAUNCHES == {"mhd_substep_overlap": 0, "mhd_substep_fixup": 0}
    hr = mo.halo_rows(case["pair"])
    slabs = mo.landed_slabs(case["f"], counts, hr)
    for i in range(counts.flatten()):
        assert_mhd_fields_match({q: f1[i][q].numpy() for q in FIELDS},
                                _jax_shard(case["jf"], i, mesh), dt)
        if case["write_w"]:
            assert_mhd_fields_match({q: w1[i][q].numpy() for q in FIELDS},
                                    _jax_shard(case["jw"], i, mesh), dt)
        else:
            assert w1 is None and case["jw"] is None
        if case["pair"]:
            hf, hw = cm.mhd_substep01_halo_plain(case["f"][i], slabs[i], prm,
                                                 DT)
        else:
            hf, hw = cm.mhd_substep_halo_plain(
                case["f"][i], None if case["w"] is None else case["w"][i],
                slabs[i], case["s"], prm, DT, write_w=case["write_w"])
        for q in FIELDS:
            assert torch.equal(f1[i][q], hf[q]), (i, q)
            if case["write_w"]:
                assert torch.equal(w1[i][q], hw[q]), (i, q)
            for k in cm.SLAB_NAMES:
                assert torch.equal(recv.landed(hr)[i][q][k], slabs[i][q][k])


@pytest.mark.parametrize("mesh,local", [((1, 1, 1), (8, 8, 16)),
                                        ((1, 2, 4), (8, 16, 8)),
                                        ((1, 4, 1), (24, 8, 8))],
                         ids=["111", "124", "141"])
@pytest.mark.parametrize("pair", [False, True], ids=["s1", "pair"])
def test_b14_after_b13_is_the_halo_twin_bitwise(mesh, local, pair):
    """B13's then B14's twin, called one by one as the wrappers do on
    CPU shards, equal B11's (B12's) twin bitwise on meshes and shards the
    JAX comparison does not reach, thin ones included (with the pair an
    8-row shard is all shell)."""
    counts = Dim3(*mesh)
    gen = torch.Generator().manual_seed(77)
    f = [{q: 0.1 * torch.randn(local, generator=gen, dtype=torch.float64)
          for q in FIELDS} for _ in range(counts.flatten())]
    w = (None if pair else
         [{q: 1e-4 * torch.randn(local, generator=gen, dtype=torch.float64)
           for q in FIELDS} for _ in range(counts.flatten())])
    prm = MhdParams(dt=DT)
    s = 0 if pair else 1
    pf, pw, recv = mo.mhd_substep_overlap_cuda(f, w, s, prm, DT, counts,
                                               pair=pair)
    pf, pw = mo.mhd_substep_fixup_cuda(f, w, pf, pw, s, prm, DT, counts,
                                       recv, pair=pair)
    slabs = mo.landed_slabs(f, counts, mo.halo_rows(pair))
    for i in range(counts.flatten()):
        if pair:
            hf, hw = cm.mhd_substep01_halo_plain(f[i], slabs[i], prm, DT)
        else:
            hf, hw = cm.mhd_substep_halo_plain(f[i], w[i], slabs[i], s, prm,
                                               DT)
        for q in FIELDS:
            assert torch.equal(pf[i][q], hf[q]) and torch.equal(pw[i][q],
                                                                hw[q])


def test_regions_tile_the_shard():
    """``interior_region`` and ``shell_regions`` cover every point of a
    shard exactly once, for one substep and for the pair, down to the
    smallest shards."""
    for Z in (8, 16, 24, 40):
        for Y in (8, 16, 32):
            for pair in (False, True):
                hits = np.zeros((Z, Y), dtype=int)
                regions = mo.shell_regions(Z, Y, pair)
                inner = mo.interior_region(Z, Y, pair)
                if inner is not None:
                    regions = regions + [inner]
                for z0, nz, y0, ny in regions:
                    assert nz > 0 and ny > 0
                    hits[z0:z0 + nz, y0:y0 + ny] += 1
                assert (hits == 1).all(), (Z, Y, pair)
                e = mo.shell_width(pair)
                if inner is not None:
                    assert inner == (e, Z - 2 * e, e, Y - 2 * e)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    counts = Dim3(1, 2, 1)
    f = [{q: torch.zeros((8, 8, 8)) for q in FIELDS} for _ in range(2)]
    prm = MhdParams()
    with pytest.raises(ValueError, match="alpha_s == 0"):
        mo.mhd_substep_overlap_cuda(f, None, 1, prm, DT, counts)
    with pytest.raises(ValueError, match="pair reads no w"):
        mo.mhd_substep_overlap_cuda(f, f, 0, prm, DT, counts, pair=True)
    with pytest.raises(ValueError, match="x must not be sharded"):
        mo.mhd_substep_overlap_cuda(f, None, 0, prm, DT, Dim3(2, 1, 1))
    with pytest.raises(ValueError, match="shards for a"):
        mo.mhd_substep_overlap_cuda(f[:1], None, 0, prm, DT, counts)
    _, _, recv = mo.mhd_substep_overlap_cuda(f, None, 0, prm, DT, counts)
    g = [{q: torch.zeros((16, 8, 8)) for q in FIELDS} for _ in range(2)]
    with pytest.raises(ValueError, match="another mesh"):
        mo.mhd_substep_overlap_cuda(g, None, 0, prm, DT, counts, recv=recv)
