"""The port's batched ensembles (``stencil_tpu_torch/serving/
ensemble.py``) against the JAX package's, and against the port's own
standalone models.

The member axis changes throughput, never results: every member of a
batched dispatch equals the standalone ``xla`` path bit for bit (Jacobi
and Astaroth, the port's own models), JAX's ensemble bit for bit
(Jacobi) or within rtol 1e-11 in float64 (Astaroth: jax 0.9's CPU
compiler contracts a*b+c into FMAs in fused loops), including when
another member is faulted mid-run. The batched exchange sends the
messages of one member, each carrying N slabs: exactly N x the wire
bytes, on every method a depth-1 plan can name. Every case of JAX's
``tests/test_ensemble.py`` has its counterpart here (marked "JAX:").
JAX runs on its fake 8-device CPU mesh, the port on CPU shards.
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.models.astaroth import (FIELDS, Astaroth, MhdParams,
                                               _radial_explosion)
from stencil_tpu_torch.models.jacobi import Jacobi3D
from stencil_tpu_torch.ops.cuda_exchange import member_views
from stencil_tpu_torch.parallel import exchange as px
from stencil_tpu_torch.parallel.methods import Method
from stencil_tpu_torch.serving.ensemble import (EnsembleAstaroth,
                                                EnsembleJacobi,
                                                EnsembleSentinel)
from stencil_tpu_torch.topology import Boundary
from torch_port_support import reference_modules

jax.config.update("jax_platforms", "cpu")

MESH = (2, 2, 2)
GRID = (8, 8, 8)
CPU = {m: ["cpu"] * int(np.prod(m)) for m in ((1, 1, 1), (1, 2, 2),
                                               (2, 2, 2))}
TEMPS = [(1.0, 0.0), (2.0, -1.0), (0.75, 0.25), (1.5, 0.5)]


@pytest.fixture(scope="module")
def je():
    """JAX's serving.ensemble, importable and runnable for the module
    (its resilience import reads ``jax.core`` names jax 0.9 moved)."""
    with reference_modules():
        import stencil_tpu.serving.ensemble as mod

        yield mod


def _jax_devices(mesh):
    return jax.devices()[:int(np.prod(mesh))]


def _jacobi_ics(n, seed=0):
    rng = np.random.default_rng(seed)
    return [0.5 + 0.01 * rng.standard_normal(GRID[::-1])
            .astype(np.float32) for _ in range(n)]


def _poison(eng, k):
    host = eng.member_interior(eng.names[0], k)
    host[0, 0, 0] = np.nan
    eng.set_member_interior(eng.names[0], k, host)


def _port_jacobi(n, mesh=MESH, ics=None, temps=None, **kw):
    eng = EnsembleJacobi(n, *GRID, mesh_shape=mesh, devices=CPU[mesh], **kw)
    for k, (hot, cold) in enumerate(temps or []):
        eng.set_member_params(k, {"hot_temp": hot, "cold_temp": cold})
    eng.init()
    for k, ic in enumerate(ics or []):
        eng.set_member_interior("temp", k, ic)
    return eng


# ---------------------------------------------------------------------------
# Jacobi: bitwise


@pytest.mark.parametrize("mesh", [(1, 1, 1), (2, 2, 2)])
def test_ensemble_jacobi_bitwise_vs_jax(je, mesh):
    """Distinct ICs AND per-member hot/cold temperatures: every member
    after run(4) equals JAX's EnsembleJacobi bit for bit."""
    n = 4
    ics = _jacobi_ics(n, seed=11)
    eng = _port_jacobi(n, mesh, ics, TEMPS)
    eng.run(4)
    ref = je.EnsembleJacobi(n, *GRID, mesh_shape=mesh,
                            devices=_jax_devices(mesh))
    for k, (hot, cold) in enumerate(TEMPS):
        ref.set_member_params(k, {"hot_temp": hot, "cold_temp": cold})
    ref.init()
    for k, ic in enumerate(ics):
        ref.set_member_interior("temp", k, ic)
    ref.run(4)
    for k in range(n):
        np.testing.assert_array_equal(
            eng.member_interior("temp", k), ref.member_interior("temp", k),
            err_msg=f"member {k}")


def test_ensemble_jacobi_bitwise_vs_independent_runs():
    """JAX: test_ensemble_jacobi_bitwise_vs_independent_runs — an N=8
    batch equals 8 standalone ``Jacobi3D(kernel="xla")`` runs of the
    same ICs, member by member, bitwise."""
    n = 8
    ics = _jacobi_ics(n)
    eng = _port_jacobi(n, ics=ics)
    eng.run(4)
    ref = Jacobi3D(*GRID, mesh_shape=MESH, devices=CPU[MESH], kernel="xla")
    for k in range(n):
        ref.init()
        ref.dd.set_interior("temp", torch.from_numpy(ics[k]))
        ref.run(4)
        np.testing.assert_array_equal(
            ref.temperature(), eng.member_interior("temp", k),
            err_msg=f"member {k}")


def test_ensemble_jacobi_per_member_params():
    """JAX: test_ensemble_jacobi_per_member_params — each member of a
    mixed batch equals a one-member ensemble with its parameters."""
    eng = _port_jacobi(len(TEMPS), temps=TEMPS)
    eng.run(3)
    for k, t in enumerate(TEMPS):
        solo = _port_jacobi(1, temps=[t])
        solo.run(3)
        np.testing.assert_array_equal(
            solo.member_interior("temp", 0),
            eng.member_interior("temp", k), err_msg=f"member {k}")


def test_ensemble_jacobi_fault_isolated():
    """JAX: test_ensemble_jacobi_fault_isolated — a NaN in one member
    corrupts only that lane, and the sentinel trips only it."""
    n = 8
    ics = _jacobi_ics(n, seed=3)
    faulted, clean = _port_jacobi(n, ics=ics), _port_jacobi(n, ics=ics)
    faulted.run(2)
    clean.run(2)
    _poison(faulted, 5)
    faulted.run(2)
    clean.run(2)
    sentinel = EnsembleSentinel(faulted)
    sentinel.probe(4)
    health = sentinel.poll(block=True)[0]
    assert health.tripped_members == [5]
    assert "member 5" in health.members[5].reason
    assert np.isnan(faulted.member_interior("temp", 5)).any()
    for k in range(n):
        if k != 5:
            np.testing.assert_array_equal(
                clean.member_interior("temp", k),
                faulted.member_interior("temp", k), err_msg=f"member {k}")


def test_ensemble_sentinel_reset_member():
    """JAX: test_ensemble_sentinel_reset_member."""
    eng = _port_jacobi(2)
    _poison(eng, 1)
    s = EnsembleSentinel(eng)
    s.probe(0)
    assert s.poll(block=True)[0].tripped_members == [1]
    eng.reset_member(1)
    s.reset_member(1)
    s.probe(1)
    assert s.poll(block=True)[0].tripped_members == []


@pytest.mark.parametrize("nan_member", [None, 2])
def test_run_segment_probe_rows_match_jax(je, nan_member):
    """``run_segment`` probe rows against JAX's: non-finite counts
    exactly, max |x| bitwise, the fields bitwise; a NaN planted in one
    member trips that member alone."""
    n = 3
    ics = _jacobi_ics(n, seed=5)
    eng = _port_jacobi(n, ics=ics, temps=TEMPS[:n])
    ref = je.EnsembleJacobi(n, *GRID, mesh_shape=MESH,
                            devices=_jax_devices(MESH))
    for k, (hot, cold) in enumerate(TEMPS[:n]):
        ref.set_member_params(k, {"hot_temp": hot, "cold_temp": cold})
    ref.init()
    for k, ic in enumerate(ics):
        ref.set_member_interior("temp", k, ic)
    if nan_member is not None:
        _poison(eng, nan_member)
        _poison(ref, nan_member)
    got = eng.run_segment(5, probe_every=2)
    want = ref.run_segment(5, probe_every=2)
    assert got.steps == tuple(want.steps)
    g, w = got.array.numpy(), np.asarray(want.array)
    assert g.shape == w.shape == (3, n, 2, 1)
    np.testing.assert_array_equal(g[:, :, 0], w[:, :, 0])
    np.testing.assert_array_equal(g[:, :, 1].view(np.uint32),
                                  w[:, :, 1].view(np.uint32))
    sentinel = EnsembleSentinel(eng)
    sentinel.observe_segment(got, got.steps)
    tripped = {k for h in sentinel.poll(block=True)
               for k in h.tripped_members}
    assert tripped == (set() if nan_member is None else {nan_member})
    for k in range(n):
        np.testing.assert_array_equal(eng.member_interior("temp", k),
                                      ref.member_interior("temp", k))


# ---------------------------------------------------------------------------
# the member axis through the exchange and B4


def _batched_shards(n, mesh, shape_zyx, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((n,) + shape_zyx, generator=g, dtype=dtype)
            for _ in range(int(np.prod(mesh)))]


@pytest.mark.parametrize("method,nonper", [
    (Method.PpermuteSlab, False), (Method.PpermutePacked, False),
    (Method.AllGather, False), (Method.PallasDMA, False),
    (Method.PpermuteSlab, True), (Method.PpermutePacked, True)],
    ids=["slab", "packed", "allgather", "pallas-dma", "slab-none",
         "packed-none"])
def test_batched_exchange_is_one_member_per_message(method, nonper):
    """Every depth-1 method on (2,2,2): the batched exchange fills each
    member's halos exactly as one member's exchange does, with the same
    number of messages, each carrying N slabs — the wire bytes exactly
    N x one member's (B4's CPU twin sweeps the member views)."""
    n, radius, counts = 3, Radius.constant(1), Dim3(2, 2, 2)
    shape = (6, 6, 6)
    two = {"a": _batched_shards(n, MESH, shape, seed=1),
           "b": _batched_shards(n, MESH, shape, torch.float64, seed=2)}

    def run(fields):
        probe = None if method == Method.PallasDMA else px.WireProbe()
        px.dispatch_exchange(fields, radius, counts, method,
                             nonperiodic=nonper, probe=probe)
        return probe

    batched = {q: [t.clone() for t in v] for q, v in two.items()}
    pb = run(batched)
    for k in range(n):
        single = {q: [t[k].clone() for t in v] for q, v in two.items()}
        ps = run(single)
        for q in two:
            for i in range(len(single[q])):
                assert torch.equal(batched[q][i][k], single[q][i]), (q, i)
        if ps is not None:
            assert len(pb.records) == len(ps.records) > 0
            assert pb.bytes == n * ps.bytes


def test_member_views_alias_the_batched_shard():
    """B4's table rows for a batched shard are its member views: N
    quantities of contiguous (Z, Y, X) views at the member offsets of
    the one tensor (so the plan cache keys by the same addresses while
    the tensor is written in place); 3-D shards pass through."""
    b = [torch.zeros(4, 5, 6, 7) for _ in range(2)]
    plain = [torch.zeros(5, 6, 7) for _ in range(2)]
    views = member_views([b, plain])
    assert len(views) == 5 and views[4] == plain
    for k in range(4):
        for i in range(2):
            v = views[k][i]
            assert v.shape == (5, 6, 7) and v.is_contiguous()
            assert v.data_ptr() == b[i].data_ptr() + k * 5 * 6 * 7 * 4
    with pytest.raises(ValueError):
        member_views([[t.transpose(-1, -2) for t in b]])


def test_ensemble_pallas_dma_equals_default_method():
    """An ensemble built with a plan that names PallasDMA (B4's twin
    here) steps bitwise as the default method."""
    class Cfg:
        method = "PallasDMA"
        exchange_every = 1

    class FakePlan:
        config = Cfg()
        provenance = "cached"

    ics = _jacobi_ics(3, seed=8)
    dma = _port_jacobi(3, (1, 2, 2), ics, plan=FakePlan())
    ref = _port_jacobi(3, (1, 2, 2), ics)
    assert dma._method == Method.PallasDMA
    dma.run(4)
    ref.run(4)
    for k in range(3):
        np.testing.assert_array_equal(dma.member_interior("temp", k),
                                      ref.member_interior("temp", k))


# ---------------------------------------------------------------------------
# per-member checkpoints


def test_member_checkpoint_roundtrip(tmp_path):
    """JAX: test_member_checkpoint_roundtrip."""
    eng = _port_jacobi(3, ics=_jacobi_ics(3, seed=7))
    eng.run(2)
    want = eng.member_interior("temp", 1)
    eng.save_member(str(tmp_path), 2, 1)
    eng.run(3)
    assert not np.array_equal(want, eng.member_interior("temp", 1))
    other = eng.member_interior("temp", 2)
    assert eng.restore_member(str(tmp_path), 1) == 2
    np.testing.assert_array_equal(want, eng.member_interior("temp", 1))
    np.testing.assert_array_equal(other, eng.member_interior("temp", 2))


def test_member_checkpoint_corrupt_falls_back(tmp_path):
    """JAX: test_member_checkpoint_corrupt_falls_back — a truncated
    newest step is walked past to the older one."""
    eng = _port_jacobi(2)
    eng.run(1)
    eng.save_member(str(tmp_path), 1, 0)
    want = eng.member_interior("temp", 0)
    eng.run(1)
    eng.save_member(str(tmp_path), 2, 0)
    for f in glob.glob(str(tmp_path / "2" / "*.bin")):
        with open(f, "r+b") as fh:
            fh.truncate(4)
    assert eng.restore_member(str(tmp_path), 0) == 1
    np.testing.assert_array_equal(want, eng.member_interior("temp", 0))


def test_member_checkpoint_restores_across_meshes(tmp_path):
    """A member saved on (1,2,2) restores bitwise on (1,1,1): the
    checkpoint holds global interiors and per-member parameters, and
    the restored member continues as the uninterrupted one."""
    src = _port_jacobi(2, (1, 2, 2), _jacobi_ics(2, seed=9), TEMPS[2:4])
    src.run(2)
    src.save_member(str(tmp_path), 2, 1)
    dst = _port_jacobi(3, (1, 1, 1))
    assert dst.restore_member(str(tmp_path), 0) == 2
    np.testing.assert_array_equal(dst.member_interior("temp", 0),
                                  src.member_interior("temp", 1))
    assert dst.member_params(0) == src.member_params(1)
    src.run(3)
    dst.run(3)
    np.testing.assert_array_equal(dst.member_interior("temp", 0),
                                  src.member_interior("temp", 1))
    assert set(os.listdir(tmp_path / "2")) >= {"meta.json", "temp.0.bin"}


# ---------------------------------------------------------------------------
# Astaroth: float64 against JAX, bitwise against the port's standalone


AST_MESH = (1, 2, 2)
OVERRIDES = {"nu_visc": 7e-3, "eta": 6e-3}


def _astaroth_ref(seed, iters, overrides=None):
    """The port's standalone ``Astaroth(kernel="xla")`` from a member's
    seeded ICs (JAX: ``_astaroth_ref``)."""
    ref = Astaroth(*GRID, mesh_shape=AST_MESH, devices=CPU[AST_MESH],
                   kernel="xla", dtype=torch.float64,
                   params=MhdParams(**(overrides or {})))
    rng = np.random.default_rng(seed)
    for q in ("ax", "ay", "az", "ss"):
        ref.dd.set_interior(q, torch.from_numpy(
            rng.uniform(-1.0, 1.0, size=GRID[::-1])))
    ref.dd.set_interior("lnrho", torch.from_numpy(np.full(GRID[::-1], 0.5)))
    for q, v in zip(("uux", "uuy", "uuz"),
                    _radial_explosion(ref.dd.size, ref.prm)):
        ref.dd.set_interior(q, torch.from_numpy(v))
    ref.run(iters)
    return ref


def _port_astaroth(n, seeds):
    eng = EnsembleAstaroth(n, *GRID, mesh_shape=AST_MESH,
                           devices=CPU[AST_MESH], dtype=torch.float64)
    eng.init(seeds=seeds)
    return eng


def test_ensemble_astaroth_matches_jax_and_standalone(je):
    """JAX: test_ensemble_astaroth_matches_independent_runs — distinct
    ICs and one member on other viscosity/resistivity: every member
    within rtol 1e-11 of JAX's ensemble, and bitwise the port's
    standalone model with that member's coefficients."""
    n = 3
    eng = _port_astaroth(n, [20, 21, 22])
    eng.set_member_params(2, OVERRIDES)
    eng.run(2)
    ref = je.EnsembleAstaroth(n, *GRID, mesh_shape=AST_MESH,
                              devices=_jax_devices(AST_MESH),
                              dtype=np.float64)
    ref.init(seeds=[20, 21, 22])
    ref.set_member_params(2, OVERRIDES)
    ref.run(2)
    for k in range(n):
        for q in FIELDS:
            np.testing.assert_allclose(
                eng.member_interior(q, k), ref.member_interior(q, k),
                rtol=1e-11, atol=1e-13, err_msg=f"member {k} {q}")
    for k in (0, 2):
        solo = _astaroth_ref(20 + k, 2, OVERRIDES if k == 2 else None)
        for q in FIELDS:
            np.testing.assert_array_equal(solo.field(q),
                                          eng.member_interior(q, k),
                                          err_msg=f"member {k} {q}")


def test_ensemble_astaroth_fault_isolated():
    """JAX: test_ensemble_astaroth_fault_isolated."""
    eng = _port_astaroth(3, [30, 31, 32])
    eng.run(1)
    _poison(eng, 0)
    eng.run(1)
    sentinel = EnsembleSentinel(eng)
    sentinel.probe(2)
    assert sentinel.poll(block=True)[0].tripped_members == [0]
    ref = _astaroth_ref(31, 2)
    for q in FIELDS:
        np.testing.assert_array_equal(ref.field(q),
                                      eng.member_interior(q, 1), err_msg=q)


def test_member_checkpoint_restores_rk_accumulator(tmp_path):
    """JAX: test_member_checkpoint_restores_rk_accumulator — a lane
    rollback restores the RK accumulator with the fields."""
    eng = _port_astaroth(2, [40, 41])
    eng.run(1)
    eng.save_member(str(tmp_path), 1, 0)
    want = {q: eng.member_interior(q, 0) for q in FIELDS}
    eng.run(2)
    eng.restore_member(str(tmp_path), 0)
    for q in FIELDS:
        np.testing.assert_array_equal(want[q], eng.member_interior(q, 0))
    eng.run(1)
    ref = _astaroth_ref(40, 2)
    for q in FIELDS:
        np.testing.assert_array_equal(ref.field(q),
                                      eng.member_interior(q, 0), err_msg=q)


# ---------------------------------------------------------------------------
# engine hygiene


def test_ensemble_rejects_bad_member_count():
    """JAX: test_ensemble_rejects_bad_member_count."""
    with pytest.raises(ValueError):
        EnsembleJacobi(0, *GRID, mesh_shape=MESH, devices=CPU[MESH])


def test_unknown_param_rejected():
    """JAX: test_unknown_param_rejected."""
    eng = _port_jacobi(2)
    with pytest.raises(KeyError):
        eng.set_member_params(0, {"viscosity": 1.0})


def test_snapshot_async_roundtrip():
    """JAX: test_snapshot_async_roundtrip."""
    eng = _port_jacobi(2)
    eng.run(1)
    snap = eng.member_snapshot_async(1, step=1)
    data = snap.get()
    assert snap.ready()
    np.testing.assert_array_equal(data["temp"],
                                  eng.member_interior("temp", 1))


def test_ensemble_without_devices_wants_a_card():
    """No fallback hides the device: an ensemble built without devices
    runs on the card, and here, with none, it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(Exception):
        EnsembleJacobi(2, *GRID)


def test_ensemble_boundary_none_matches_standalone():
    """``Boundary.NONE`` (zero-Dirichlet exterior): members equal the
    standalone ``xla`` path bitwise."""
    ics = _jacobi_ics(2, seed=12)
    eng = _port_jacobi(2, (1, 2, 2), ics, boundary=Boundary.NONE)
    eng.run(3)
    ref = Jacobi3D(*GRID, mesh_shape=(1, 2, 2), devices=CPU[(1, 2, 2)],
                   kernel="xla", boundary=Boundary.NONE)
    for k in range(2):
        ref.init()
        ref.dd.set_interior("temp", torch.from_numpy(ics[k]))
        ref.run(3)
        np.testing.assert_array_equal(ref.temperature(),
                                      eng.member_interior("temp", k))


def test_lane_writes_keep_the_batched_tensors(tmp_path):
    """Every lane write — ``init``, ``set_member_interior``,
    ``reset_member``, a restore — and every step writes the batched
    tensors in place, so B4's plan cache, keyed by the member views'
    addresses, keeps its plan."""
    eng = _port_jacobi(3, (1, 2, 2), _jacobi_ics(3, seed=13))
    ptrs = [t.data_ptr() for t in eng.state["temp"]]
    eng.save_member(str(tmp_path), 0, 1)
    eng.init()
    eng.reset_member(2)
    eng.run(2)
    eng.restore_member(str(tmp_path), 1)
    eng.run_segment(2)
    assert [t.data_ptr() for t in eng.state["temp"]] == ptrs
