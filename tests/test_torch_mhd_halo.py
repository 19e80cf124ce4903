"""B11's plain twin against the JAX package's MHD halo substep kernel,
and the batched slab exchange that feeds it.

``mhd_substep_halo_plain`` (``stencil_tpu_torch/ops/cuda_mhd.py``) is
held against ``mhd_substep_halo_pallas`` run in interpret mode on the
CPU (inside ``reference_block_planner``, which its block planner and its
module import need). The shard is (16, 8, 16) (Z, Y, X): JAX blocks it
as (8, 8), so its grid has two z blocks and each window takes in-shard
rows and slab rows both. Both packages get the same slabs, made by
JAX's ``exchange_interior_slabs`` (rz = block_z = 8, ry = 8, 3 valid
rows, z-extended y slabs) from a second seeded field, so that no slab
row equals the shard row it stands beside. One chain per (dtype, dt):
substep 0 with ``w=None``, substep 1 on JAX's (f1, w1), substep 2 with
``write_w=False`` on JAX's (f2, w2), each with new slabs; and the
unelided variants.

Tolerances (``torch_port_support.assert_mhd_fields_match``): float32
per field ``max |port - jax| <= 64 * eps(f32) * max |jax|``; float64
``rtol=1e-11, atol=1e-13``, as for B9 (tests/test_torch_mhd.py). The
exact-row slabs the port's halo path uses (rz = ry = 3) give the twin
the same result bitwise, and the batched exchange (8 fields in one
tensor) equals 8 per-field exchanges bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.geometry import Dim3 as JDim3
from stencil_tpu.models.astaroth import MhdParams as JParams
from stencil_tpu.parallel.exchange import exchange_interior_slabs as jex
from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.models.astaroth import FIELDS, MhdParams
from stencil_tpu_torch.ops import cuda_mhd as cm
from stencil_tpu_torch.parallel.exchange import exchange_interior_slabs
from torch_port_support import (MHD_CASE_IDS, MHD_CASES,
                                assert_mhd_fields_match as assert_fields_match,
                                reference_block_planner)

jax.config.update("jax_platforms", "cpu")

SHAPE = (16, 8, 16)          # (Z, Y, X): two (8, 8) JAX blocks in z
BZ = 8                       # JAX's block_z at this shard, the z slab rows


def _fields(dtype, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return {q: (rng.normal(0.0, 0.1, SHAPE) * scale / 0.1).astype(dtype)
            for q in FIELDS}


def jax_slabs(dtype, seed, rows):
    """JAX's slabs of one shard on a (1,1,1) mesh — the wrapped edges of a
    second seeded field — as numpy: JAX's layout, rz = 8, ry = 8."""
    g = _fields(dtype, seed)
    return {q: {k: np.asarray(v) for k, v in
                jex(jnp.asarray(g[q]), JDim3(1, 1, 1), rz=BZ, ry=8,
                    radius_rows=rows, y_z_extended=True).items()}
            for q in FIELDS}


def exact_rows(slabs, rr):
    """The same slabs cut to the ``rr`` rows that cross (rz = ry = rr)."""
    z = SHAPE[0]
    return {q: {"zlo": s["zlo"][BZ - rr:], "zhi": s["zhi"][:rr],
                "ylo": s["ylo"][BZ - rr:BZ + z + rr, 8 - rr:],
                "yhi": s["yhi"][BZ - rr:BZ + z + rr, :rr]}
            for q, s in slabs.items()}


def _t(d):
    if d is None:
        return None
    return {q: (_t(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)))
            for q, v in d.items()}


def _j(d):
    if d is None:
        return None
    return {q: (_j(v) if isinstance(v, dict) else jnp.asarray(v))
            for q, v in d.items()}


@pytest.fixture(scope="module", params=MHD_CASES, ids=MHD_CASE_IDS)
def chain(request):
    """JAX's three substeps of one iteration, each on JAX's own inputs
    and new slabs."""
    dtype, dt = request.param
    f0 = _fields(dtype, 21)
    prm = JParams(dt=dt)
    with reference_block_planner():
        from stencil_tpu.ops.pallas_halo import mhd_substep_halo_pallas

        sl = [jax_slabs(dtype, 22 + s, 3) for s in range(3)]
        f1, w1 = mhd_substep_halo_pallas(_j(f0), None, _j(sl[0]), 0, prm, dt,
                                         interpret=True)
        f2, w2 = mhd_substep_halo_pallas(f1, w1, _j(sl[1]), 1, prm, dt,
                                         interpret=True)
        f3, w3 = mhd_substep_halo_pallas(f2, w2, _j(sl[2]), 2, prm, dt,
                                         write_w=False, interpret=True)
    assert w3 is None
    np_ = lambda d: {q: np.asarray(v) for q, v in d.items()}   # noqa: E731
    return dict(dtype=dtype, dt=dt, sl=sl, f0=f0, f1=np_(f1), w1=np_(w1),
                f2=np_(f2), w2=np_(w2), f3=np_(f3))


def _twin(c, s, f, w, write_w=True):
    prm = MhdParams(dt=c["dt"])
    got = cm.mhd_substep_halo_plain(_t(f), _t(w), _t(c["sl"][s]), s, prm,
                                    c["dt"], write_w=write_w)
    # the halo path's own slabs: exactly the 3 rows that cross
    own = cm.mhd_substep_halo_plain(_t(f), _t(w), _t(exact_rows(c["sl"][s], 3)),
                                    s, prm, c["dt"], write_w=write_w)
    for a, b in zip(got, own):
        if a is None:
            assert b is None
            continue
        for q in FIELDS:
            assert torch.equal(a[q], b[q]), q
    return got


def test_substep0_without_w_matches_jax(chain):
    f, w = _twin(chain, 0, chain["f0"], None)
    assert_fields_match(f, chain["f1"], chain["dtype"])
    assert_fields_match(w, chain["w1"], chain["dtype"])


def test_substep1_matches_jax(chain):
    f, w = _twin(chain, 1, chain["f1"], chain["w1"])
    assert_fields_match(f, chain["f2"], chain["dtype"])
    assert_fields_match(w, chain["w2"], chain["dtype"])


def test_substep2_without_w_out_matches_jax(chain):
    f, w = _twin(chain, 2, chain["f2"], chain["w2"], write_w=False)
    assert w is None
    assert_fields_match(f, chain["f3"], chain["dtype"])


@pytest.fixture(scope="module")
def unelided():
    """The variants the model does not run, float32 at dt = 1e-4:
    substep 0 reading an explicit w, substep 2 writing its w."""
    dt = 1e-4
    f = _fields(np.float32, 31)
    w = _fields(np.float32, 32, scale=1e-4)
    sl = jax_slabs(np.float32, 33, 3)
    prm = JParams(dt=dt)
    with reference_block_planner():
        from stencil_tpu.ops.pallas_halo import mhd_substep_halo_pallas

        s0 = mhd_substep_halo_pallas(_j(f), _j(w), _j(sl), 0, prm, dt,
                                     interpret=True)
        s2 = mhd_substep_halo_pallas(_j(f), _j(w), _j(sl), 2, prm, dt,
                                     write_w=True, interpret=True)
    return dict(f=f, w=w, sl=sl, dt=dt, s0=s0, s2=s2)


@pytest.mark.parametrize("s", [0, 2])
def test_unelided_variants_match_jax_and_elision(unelided, s):
    u = unelided
    prm = MhdParams(dt=u["dt"])
    f, w = cm.mhd_substep_halo_plain(_t(u["f"]), _t(u["w"]), _t(u["sl"]), s,
                                     prm, u["dt"])
    want = u[f"s{s}"]
    assert_fields_match(f, want[0], np.float32)
    assert_fields_match(w, want[1], np.float32)
    # alpha_0 == 0: reading w changes nothing; write_w elision is exact
    f_el, w_el = cm.mhd_substep_halo_plain(
        _t(u["f"]), None if s == 0 else _t(u["w"]), _t(u["sl"]), s, prm,
        u["dt"], write_w=s == 0)
    for q in FIELDS:
        assert torch.equal(f[q], f_el[q])
        if s == 0:
            assert torch.equal(w[q], w_el[q])
    assert (w_el is None) == (s == 2)


# -- the twin against the wrap twin and on a mesh ---------------------------
def _mesh_state(shape_zyx, mesh, seed, dtype=torch.float64):
    """A global (8, Z, Y, X) state cut into the shards of an x-unsharded
    mesh (x fastest, as the port orders them)."""
    g = torch.from_numpy(np.random.default_rng(seed).normal(
        0.0, 0.1, (8,) + tuple(shape_zyx))).to(dtype)
    lz, ly = shape_zyx[0] // mesh[2], shape_zyx[1] // mesh[1]
    return g, [g[:, z * lz:(z + 1) * lz, y * ly:(y + 1) * ly].contiguous()
               for z in range(mesh[2]) for y in range(mesh[1])]


def _per_field(t):
    return dict(zip(FIELDS, t.unbind(0)))


def _slabs_per_field(sl):
    return {q: {k: v[j] for k, v in sl.items()} for j, q in enumerate(FIELDS)}


def test_twin_on_one_shard_equals_the_wrap_twin_bitwise():
    """On a (1,1,1) mesh the slabs are the shard's own wrapped rows, so
    B11's twin computes B9's, and B12's twin B10's."""
    _, (a,) = _mesh_state((16, 8, 16), (1, 1, 1), 41)
    f, prm = _per_field(a), MhdParams(dt=1e-4)
    sl3 = exchange_interior_slabs([a], Dim3(1, 1, 1), rz=3, ry=3,
                                  y_z_extended=True)[0]
    sl6 = exchange_interior_slabs([a], Dim3(1, 1, 1), rz=6, ry=6,
                                  y_z_extended=True)[0]
    got = cm.mhd_substep_halo_plain(f, None, _slabs_per_field(sl3), 0, prm,
                                    1e-4)
    want = cm.mhd_substep_wrap_plain(f, None, 0, prm, 1e-4)
    got2 = cm.mhd_substep01_halo_plain(f, _slabs_per_field(sl6), prm, 1e-4)
    want2 = cm.mhd_substep01_wrap_plain(f, prm, 1e-4)
    for g, w in ((got, want), (got2, want2)):
        for q in FIELDS:
            assert torch.equal(g[0][q], w[0][q]) and torch.equal(g[1][q],
                                                                 w[1][q]), q


@pytest.mark.parametrize("mesh", [(1, 2, 2), (1, 1, 2)])
def test_pair_twin_equals_two_substeps_with_an_exchange_between(mesh):
    """B12's twin on radius-2R slabs equals B11's twin for substep 0, a
    radius-R slab round of its results, and B11's twin for substep 1, on
    every shard of a mesh, bitwise: the ring is recomputed, not
    approximated."""
    counts = Dim3(*mesh)
    _, shards = _mesh_state((16, 16, 8), mesh, 42)
    prm = MhdParams(dt=1e-4)
    sl6 = exchange_interior_slabs(shards, counts, rz=6, ry=6,
                                  y_z_extended=True)
    pair = [cm.mhd_substep01_halo_plain(_per_field(t), _slabs_per_field(s),
                                        prm, 1e-4)
            for t, s in zip(shards, sl6)]
    sl3 = exchange_interior_slabs(shards, counts, rz=3, ry=3,
                                  y_z_extended=True)
    one = [cm.mhd_substep_halo_plain(_per_field(t), None, _slabs_per_field(s),
                                     0, prm, 1e-4)
           for t, s in zip(shards, sl3)]
    f1 = [torch.stack([f[q] for q in FIELDS]) for f, _ in one]
    sl3 = exchange_interior_slabs(f1, counts, rz=3, ry=3, y_z_extended=True)
    two = [cm.mhd_substep_halo_plain(_per_field(t), w, _slabs_per_field(s), 1,
                                     prm, 1e-4)
           for t, (_, w), s in zip(f1, one, sl3)]
    for (pf, pw), (tf, tw) in zip(pair, two):
        for q in FIELDS:
            assert torch.equal(pf[q], tf[q]) and torch.equal(pw[q], tw[q]), q


# -- the batched slab exchange ----------------------------------------------
@pytest.mark.parametrize("mesh,size,kw", [
    ((1, 2, 2), (16, 16, 8), dict(rz=3, ry=3, y_z_extended=True)),
    ((1, 2, 4), (32, 16, 8), dict(rz=6, ry=6, y_z_extended=True)),
    ((1, 1, 2), (16, 8, 12), dict(rz=8, ry=8, radius_rows=3,
                                  y_z_extended=True)),
    ((1, 2, 2), (11, 13, 6), dict(rz=1, ry=8)),     # uneven, JAX filler
])
def test_batched_exchange_equals_per_field_exchanges(mesh, size, kw):
    """One ``exchange_interior_slabs`` call on (8, Z, Y, X) shards equals
    eight calls on the fields, slab for slab, bitwise."""
    counts = Dim3(*mesh)
    Z, Y, X = size
    cap = (-(-Z // mesh[2]), -(-Y // mesh[1]), X)
    rem = Dim3(0, Y % mesh[1], Z % mesh[2])
    g = torch.from_numpy(np.random.default_rng(43).random(
        (8, cap[0] * mesh[2], cap[1] * mesh[1], X)))
    shards = [g[:, z * cap[0]:(z + 1) * cap[0],
                y * cap[1]:(y + 1) * cap[1]].contiguous()
              for z in range(mesh[2]) for y in range(mesh[1])]
    kw = dict(kw) if kw.get("y_z_extended") else dict(kw, rem=rem)
    batched = exchange_interior_slabs(shards, counts, **kw)
    for j in range(8):
        one = exchange_interior_slabs([t[j] for t in shards], counts, **kw)
        for i in range(len(shards)):
            for k, v in one[i].items():
                assert batched[i][k].shape[1:] == v.shape
                assert torch.equal(batched[i][k][j], v), (i, j, k)
                assert batched[i][k][j].is_contiguous()


# -- the wrappers -------------------------------------------------------------
def _cpu_case():
    _, (a,) = _mesh_state((16, 8, 16), (1, 1, 1), 44, torch.float32)
    sl = exchange_interior_slabs([a], Dim3(1, 1, 1), rz=6, ry=6,
                                 y_z_extended=True)[0]
    return _per_field(a), _slabs_per_field(sl)


def test_cpu_wrappers_route_to_the_twins_and_launch_nothing():
    cm.reset_launch_counts()
    f, sl = _cpu_case()
    prm = MhdParams(dt=1e-4)
    got = cm.mhd_substep_halo_cuda(f, None, sl, 0, prm, 1e-4)
    want = cm.mhd_substep_halo_plain(f, None, sl, 0, prm, 1e-4)
    out_f = {q: torch.empty_like(t) for q, t in f.items()}
    out_w = {q: torch.empty_like(t) for q, t in f.items()}
    pair = cm.mhd_substep01_halo_cuda(f, sl, prm, 1e-4, out_f=out_f,
                                      out_w=out_w)
    pwant = cm.mhd_substep01_halo_plain(f, sl, prm, 1e-4)
    assert pair[0] is out_f and pair[1] is out_w
    for q in FIELDS:
        assert torch.equal(got[0][q], want[0][q])
        assert torch.equal(got[1][q], want[1][q])
        assert torch.equal(out_f[q], pwant[0][q])
        assert torch.equal(out_w[q], pwant[1][q])
    assert set(cm.LAUNCHES.values()) == {0}


def test_wrappers_keep_the_jax_layout_rules():
    f, sl = _cpu_case()
    prm = MhdParams()
    with pytest.raises(ValueError, match="alpha"):
        cm.mhd_substep_halo_cuda(f, None, sl, 1, prm, 1e-8)
    thin = {q: {k: (v[:3] if k in ("zlo", "zhi") else v[3:-3, :3])
                for k, v in s.items()} for q, s in sl.items()}
    cm.mhd_substep_halo_cuda(f, None, thin, 0, prm, 1e-8)   # 3 rows: B11 ok
    with pytest.raises(ValueError, match="radius-6"):
        cm.mhd_substep01_halo_cuda(f, thin, prm, 1e-8)
    flat = {q: dict(s, ylo=s["ylo"][6:-6]) for q, s in sl.items()}
    with pytest.raises(ValueError, match="z-extended"):
        cm.mhd_substep_halo_cuda(f, None, flat, 0, prm, 1e-8)
    missing = dict(sl)
    missing.pop("ss")
    with pytest.raises(ValueError, match="exactly"):
        cm.mhd_substep_halo_cuda(f, None, missing, 0, prm, 1e-8)
    mixed = {q: dict(s) for q, s in sl.items()}
    mixed["ax"]["zhi"] = mixed["ax"]["zhi"].double()
    with pytest.raises(ValueError, match="ax/zhi"):
        cm.mhd_substep_halo_cuda(f, None, mixed, 0, prm, 1e-8)
    with pytest.raises(ValueError, match="write_w=False"):
        cm.mhd_substep_halo_cuda(f, None, sl, 0, prm, 1e-8, write_w=False,
                                 out_w={q: torch.empty_like(t)
                                        for q, t in f.items()})
