"""stencil_tpu_torch across processes: gloo worlds of two and four ranks
on the CPU, started by ``multihost.spawn_ranks`` (``spawn``, a
``file://`` rendezvous under ``tmp_path``), against the one-process
port and the JAX package.

The rank functions live in ``torch_mp_workers`` (no JAX, so a rank
starts in about a second); each world runs once per module and writes
its results, which the tests read. NCCL is not in this image: gloo
moves the CPU tensors. Tolerance: bitwise against the one-process port
everywhere — a message moves the same bits a one-process copy does, and
every rank computes its own shards as the one process computes them.
Against the JAX package, one path of each family: Jacobi's bitwise,
Astaroth's float64 within rtol 1e-11 / atol 1e-13 (JAX's CPU compiler
contracts into FMAs) and PIC's particles within rtol 1e-12 and rho
within 1e-12, as the one-process files hold them.
"""

import json

import jax
import numpy as np
import pytest
import torch

import torch_mp_workers as workers
from stencil_tpu_torch.models.astaroth import Astaroth
from stencil_tpu_torch.models.jacobi import Jacobi3D
from stencil_tpu_torch.models.pic import PARTICLE_FIELDS
from stencil_tpu_torch.parallel import multihost
from torch_port_support import astaroth_state, reference_block_planner

jax.config.update("jax_platforms", "cpu")

TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("two_ranks")
    multihost.spawn_ranks(workers.two_rank_cases, 2, args=(str(out),),
                          rendezvous_dir=str(out), timeout_s=TIMEOUT_S)
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("four_ranks")
    multihost.spawn_ranks(workers.four_rank_jacobi, 4, args=(str(out),),
                          rendezvous_dir=str(out), timeout_s=TIMEOUT_S)
    return out


def test_jacobi_dcn_xla_on_two_ranks_equals_jax_on_eight_devices(two_ranks):
    """Jacobi3D(16,16,16) float32 xla over (2,2,2), z blocked across two
    ranks of four shards, 2 steps: bitwise JAX's DCN run over 8 fake
    devices in two slices."""
    from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D

    devs = jax.devices()[:8]
    with reference_block_planner():
        jj = JJacobi3D(16, 16, 16, dtype=np.float32, kernel="xla",
                       mesh_shape=(2, 2, 2), devices=devs, dcn_axis="z",
                       dcn_groups=[devs[:4], devs[4:]])
        jj.init()
        jj.run(2)
        want = np.asarray(jj.temperature())
    got = np.load(two_ranks / "jacobi_dcn.npy")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # z index 0 on rank 0, z index 1 on rank 1: only z crosses
    assert list(np.load(two_ranks / "jacobi_dcn_ranks.npy")) == \
        [0] * 4 + [1] * 4


@pytest.mark.parametrize("name", [c[0] for c in workers.EXCHANGE_CASES])
def test_exchange_across_ranks_equals_one_process(two_ranks, name):
    """One exchange on the checkerboard placement of (2,2,2) over two
    ranks — every move crosses ranks — against the same exchange in one
    process, every padded shard bitwise, halos and dead rows included:
    uneven (+-1) shards at radius 2, Boundary.NONE, a bf16 wire with the
    irredundant layout, and the packed engine (float32 and float64
    quantities, a bf16 wire)."""
    dd = workers.exchange_domain(name, ["cpu"] * 8)
    for q, shards in dd.curr.items():
        for i, t in enumerate(shards):
            got = np.load(two_ranks / f"{name}_{q}_{i}.npy")
            want = t.numpy()
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_array_equal(got.view(np.uint8),
                                          want.view(np.uint8))


@pytest.mark.parametrize("tag,kernel,every", workers.MHD_CASES)
def test_astaroth_across_ranks_equals_one_process(two_ranks, tag, kernel,
                                                  every):
    """Astaroth float64 halo (B11's twin; with exchange_every=2 the pair,
    B12's) and xla over (1,2,2), two shards on each of two ranks, one
    iteration: bitwise the one-process run."""
    m = Astaroth(16, 16, 16, kernel=kernel, mesh_shape=(1, 2, 2),
                 devices=["cpu"] * 4, exchange_every=every,
                 dtype=torch.float64)
    m.init()
    m.run(1)
    got = np.load(two_ranks / f"{tag}.npz")
    for q in got.files:
        np.testing.assert_array_equal(got[q], m.field(q))


@pytest.mark.parametrize("tag,kernel,mesh,every", workers.JACOBI_CASES)
def test_jacobi_on_four_ranks_equals_one_process(four_ranks, tag, kernel,
                                                 mesh, every):
    """Jacobi3D over four ranks of two shards, 5 steps: halo over (1,2,4)
    at exchange_every 1 (B5's twin) and 2 (B6's, N = 2), pallas (K3's
    twin) and xla-temporal[s=2] over (2,2,2); each bitwise the
    one-process run, on the same path."""
    j = Jacobi3D(16, 16, 16, kernel=kernel, mesh_shape=mesh,
                 devices=["cpu"] * 8, exchange_every=every)
    j.init()
    j.run(5)
    got = np.load(four_ranks / f"{tag}.npy")
    assert (four_ranks / f"{tag}.path").read_text() == j.kernel_path
    np.testing.assert_array_equal(got.view(np.uint32),
                                  j.temperature().view(np.uint32))


def test_segment_across_ranks_equals_one_process(two_ranks):
    """Jacobi3D ``halo`` on (1,2,2), two shards on each of two ranks: a
    5-step segment (probe rows every 2 steps, their max across the ranks
    one all_reduce a row) gives the one-process segment's field and trace
    bitwise, and the one-process field equals its ``run(5)``."""
    j = Jacobi3D(16, 16, 16, kernel="halo", mesh_shape=(1, 2, 2),
                 devices=["cpu"] * 4)
    j.init()
    tr = j.make_segment(workers.SEGMENT_STEPS, probe_every=2).run(0)
    ref = Jacobi3D(16, 16, 16, kernel="halo", mesh_shape=(1, 2, 2),
                   devices=["cpu"] * 4)
    ref.init()
    ref.run(workers.SEGMENT_STEPS)
    np.testing.assert_array_equal(j.temperature(), ref.temperature())
    got = np.load(two_ranks / "segment_halo.npy")
    np.testing.assert_array_equal(got.view(np.uint32),
                                  j.temperature().view(np.uint32))
    np.testing.assert_array_equal(
        np.load(two_ranks / "segment_halo_trace.npy"), tr.array.numpy())


def _one_process(model, kw, steps):
    n = int(np.prod(kw["mesh_shape"]))
    m = workers.a4c_model(model, kw, ["cpu"] * n)
    m.run(steps)
    return workers.a4c_result(model, m)


def _assert_same(got, want):
    assert set(got.files) == set(want), (sorted(got.files), sorted(want))
    for k, v in want.items():
        g, v = got[k], np.asarray(v)
        assert g.dtype == v.dtype and g.shape == v.shape, k
        if v.dtype.kind == "f":
            np.testing.assert_array_equal(np.atleast_1d(g).view(np.uint8),
                                          np.atleast_1d(v).view(np.uint8),
                                          err_msg=k)
        else:
            np.testing.assert_array_equal(g, v, err_msg=k)


@pytest.mark.parametrize("tag", [c[0] for c in workers.A4C_CASES])
def test_a4c_path_across_ranks_equals_one_process(two_ranks, tag):
    """Each path of the remote-write kernels' twins, the overlap
    exchanges, the all-gather engine and PIC over two ranks (two or four
    shards a rank, or the checkerboard of (2,2,2)): every gathered array
    bitwise the same path in one process — Jacobi ``overlap`` (B7's
    twin) on (1,2,2) and (1,1,4), ``xla-overlap``, ``pallas-overlap``
    with PallasDMA, ``xla-temporal[s=2]-overlap``, ``xla`` with PallasDMA
    (B4's twin) and with AllGather; Astaroth ``halo-overlap`` (B13/B14's
    twins) with and without the pair and ``xla-overlap`` (fields and
    w); PIC NGP float64 and CIC float32 (rho, the particles slot by
    slot, the total charge and the overflow)."""
    _, model, kw, _, steps = next(c for c in workers.A4C_CASES
                                  if c[0] == tag)
    _assert_same(np.load(two_ranks / f"{tag}.npz"),
                 _one_process(model, kw, steps))


@pytest.mark.parametrize("tag", [c[0] for c in workers.A4C_FOUR])
def test_a4c_path_on_four_ranks_equals_one_process(four_ranks, tag):
    """Jacobi ``overlap`` and PIC NGP float64 on (1,2,2) with every shard
    its own rank: bitwise the one-process run."""
    _, model, kw, _, steps = next(c for c in workers.A4C_FOUR
                                  if c[0] == tag)
    _assert_same(np.load(four_ranks / f"{tag}.npz"),
                 _one_process(model, kw, steps))


def test_overlap_segment_across_ranks_equals_one_process(two_ranks):
    """A 5-step segment (probe rows every 2 steps) on the ``overlap``
    path (B7's twin, all of it in one session) over two ranks: the field
    and the trace bitwise the one-process segment's."""
    j = Jacobi3D(16, 16, 16, kernel="halo", overlap=True,
                 mesh_shape=(1, 2, 2), devices=["cpu"] * 4)
    j.init()
    tr = j.make_segment(workers.SEGMENT_STEPS, probe_every=2).run(0)
    _assert_same(np.load(two_ranks / "segment_overlap.npz"),
                 {"temp": j.temperature(), "trace": tr.array.numpy(),
                  "path": np.array("overlap")})


def test_jacobi_overlap_across_ranks_equals_jax(two_ranks):
    """The ``overlap`` path over two ranks (B7's twin, 3 steps on
    (1,2,2)) bitwise JAX's in-kernel RDMA overlap model on four fake
    devices."""
    from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D

    with reference_block_planner():
        jj = JJacobi3D(16, 16, 16, dtype=np.float32, kernel="halo",
                       overlap=True, mesh_shape=(1, 2, 2),
                       devices=jax.devices()[:4])
        assert jj.kernel_path == "overlap"
        jj.init()
        jj.run(3)
        want = np.asarray(jj.temperature())
    got = np.load(two_ranks / "jacobi_overlap.npz")["temp"]
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_jacobi_dma_across_ranks_equals_jax(two_ranks):
    """``xla`` with PallasDMA on the checkerboard of (2,2,2) over two
    ranks (B4's twin, every move between the ranks), 3 steps: bitwise
    JAX's ``xla`` run with its remote-write exchange on eight fake
    devices."""
    from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
    from stencil_tpu.parallel.methods import Method as JMethod

    jj = JJacobi3D(16, 16, 16, dtype=np.float32, kernel="xla",
                   mesh_shape=(2, 2, 2), devices=jax.devices()[:8],
                   methods=JMethod.PallasDMA)
    jj.init()
    jj.run(3)
    want = np.asarray(jj.temperature())
    got = np.load(two_ranks / "jacobi_xla_dma.npz")["temp"]
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_astaroth_xla_overlap_across_ranks_equals_jax(two_ranks):
    """Astaroth ``xla-overlap`` over two ranks, 16^3 float64 at dt 1e-4,
    one iteration: JAX's ``xla-overlap`` on four fake devices within
    rtol 1e-11 / atol 1e-13, fields and w."""
    from stencil_tpu.models import astaroth as jm

    jj = jm.Astaroth(16, 16, 16, params=jm.MhdParams(dt=1e-4),
                     mesh_shape=(1, 2, 2), dtype=np.float64,
                     devices=jax.devices()[:4], kernel="xla", overlap=True)
    assert jj.kernel_path == "xla-overlap"
    jj.init()
    jj.step()
    jf, jw = astaroth_state(jj)
    got = np.load(two_ranks / "mhd_xla_overlap.npz")
    for q in jm.FIELDS:
        np.testing.assert_allclose(got[q], jf[q], rtol=1e-11, atol=1e-13,
                                   err_msg=q)
        np.testing.assert_allclose(got[f"w_{q}"], jw[q], rtol=1e-11,
                                   atol=1e-13, err_msg=q)


def test_pic_across_ranks_equals_jax(two_ranks):
    """PIC NGP float64 on the checkerboard of (2,2,2) over two ranks
    (the deposit's accumulate and the migration between the ranks), 3
    steps from the seeded ``init()``: JAX's model on eight fake devices,
    the particles slot by slot within rtol 1e-12, rho within 1e-12 and
    the overflow counts equal."""
    from stencil_tpu.models.pic import Pic as JPic

    jp = JPic(12, 12, 12, 300, mesh_shape=(2, 2, 2),
              devices=jax.devices()[:8], dtype=np.float64,
              deposition="ngp", seed=11)
    jp.run(3)
    got = np.load(two_ranks / "pic_ngp_f64.npz")
    want = jp.particles_to_host()
    for k in PARTICLE_FIELDS:
        np.testing.assert_allclose(got[f"p_{k}"], want[k], rtol=1e-12,
                                   atol=0, err_msg=k)
    np.testing.assert_array_equal(got["p_overflow"], want["overflow"])
    np.testing.assert_allclose(got["rho"], np.asarray(jp.rho()), rtol=0,
                               atol=1e-12)
    assert float(got["charge"]) == 300.0


def test_nccl_refuses_what_it_cannot_carry(two_ranks):
    """nccl asked for CPU devices raises on every rank, and for two ranks
    on one card names gloo's staging; without NCCL in the build, asking
    for it raises before any process group is made."""
    got = json.loads((two_ranks / "refusals.json").read_text())
    assert "CUDA tensors only" in got["nccl_on_cpu"]
    shared = [multihost.GlobalDevice(r, "host", torch.device("cuda", 0))
              for r in range(2)]
    with pytest.raises(ValueError, match="share cuda:0.*gloo"):
        multihost.check_transport("nccl", shared)
    multihost.check_transport("gloo", shared)
    if not torch.distributed.is_nccl_available():
        with pytest.raises(RuntimeError, match="no NCCL"):
            multihost.initialize_distributed("file:///nonexistent", 2, 0,
                                             backend="nccl")
    assert not torch.distributed.is_initialized()


def test_one_process_needs_no_process_group():
    """Without a process group (and without torchrun's environment)
    ``initialize_distributed`` is a no-op returning rank 0, and
    ``global_devices`` is this process's devices."""
    assert multihost.initialize_distributed() == 0
    assert multihost.process_count() == 1
    got = multihost.global_devices(["cpu", "cpu"])
    assert [(g.rank, g.device) for g in got] == [(0, torch.device("cpu"))] * 2


def test_total_charge_is_jax_value_on_every_rank(two_ranks):
    """C1 across ranks: CIC float32 on 16^3 with 16,384 particles, seed
    7, one step, over (1,2,2) on two ranks: every rank's
    ``total_charge`` is JAX's value (the float32 ``np.sum`` of rho)."""
    from stencil_tpu.models.pic import Pic as JPic

    jp = JPic(16, 16, 16, 16384, mesh_shape=(1, 2, 2),
              devices=jax.devices()[:4], dtype=np.float32,
              deposition="cic", seed=7)
    jp.step()
    got = json.loads((two_ranks / "resilience.json").read_text())
    assert got["charges"] == [jp.total_charge()] * 2


def test_resilient_campaign_across_ranks_equals_one_process(two_ranks,
                                                            tmp_path):
    """A resilient Jacobi ``halo`` campaign on (1,2,2) over two ranks —
    a NaN at step 3 rolled back, a preemption at step 6 and the resume
    to step 10 — gives the one-process campaign's events and its final
    field bitwise (and the clean run's, stepped in the same segments)."""
    got = json.loads((two_ranks / "resilience.json").read_text())
    first, second, temp = workers.resilient_campaign(
        ["cpu"] * 4, str(tmp_path / "ckpt"))
    assert [tuple(e) for e in got["first"]] == first
    assert [tuple(e) for e in got["second"]] == second
    kinds = [k for k, _ in first]
    assert "sentinel_tripped" in kinds and kinds[-1] == "preempted"
    ranks_temp = np.load(two_ranks / "resilient_temp.npy")
    np.testing.assert_array_equal(ranks_temp.view(np.uint32),
                                  temp.view(np.uint32))
    # the clean run in the campaign's one-step segments (single-step
    # launches: an N-step group sums in another order)
    clean = Jacobi3D(16, 16, 16, kernel="halo", mesh_shape=(1, 2, 2),
                     devices=["cpu"] * 4)
    clean.init()
    for _ in range(workers.RESILIENT_STEPS):
        clean.run(1)
    np.testing.assert_array_equal(temp, clean.temperature())


def test_autotune_across_ranks_agrees_on_one_plan(two_ranks):
    """``Method.Auto`` on a mesh over two ranks: both ranks adopt rank
    0's tuned plan (their own timings differ), the second domain is a
    cache hit on both, and the run equals one process running the
    winner by name, bitwise."""
    recs = [json.loads((two_ranks / f"autotune_{r}.json").read_text())
            for r in range(2)]
    assert recs[0]["plan"] == recs[1]["plan"]
    assert recs[0]["plan"]["provenance"] == "tuned"
    assert recs[0]["plan"]["measurements"] == 3 + 4
    for rec in recs:
        assert rec["second"]["provenance"] == "cached"
        assert rec["second"]["measurements"] == 0
        assert rec["second"]["config"] == rec["plan"]["config"]
    cfg = recs[0]["plan"]["config"]
    from stencil_tpu_torch.parallel.methods import Method

    j = Jacobi3D(16, 16, 16, kernel="xla", mesh_shape=(1, 2, 2),
                 devices=["cpu"] * 4, methods=Method[cfg["method"]],
                 exchange_every=cfg["exchange_every"])
    j.init()
    j.run(3)
    got = np.load(two_ranks / "autotune_temp.npy")
    np.testing.assert_array_equal(got.view(np.uint32),
                                  j.temperature().view(np.uint32))


def test_autotune_ranks_with_different_clocks_time_the_same_candidates(
        two_ranks):
    """Each rank's clock fits an opposite link (rank 0 all latency, rank
    1 all bandwidth, ``workers.AGREEMENT_LINKS``), which on its own
    would rank a different pair of candidates first: both rank with rank
    0's fit, time the same candidates and adopt one plan."""
    recs = [json.loads((two_ranks / f"agreement_{r}.json").read_text())
            for r in range(2)]
    assert len(recs[0]["timed"]) == 2
    assert recs[0]["timed"] == recs[1]["timed"]
    assert recs[0]["plan"] == recs[1]["plan"]
    assert recs[0]["plan"]["config"]["exchange_every"] > 1


def test_checkpoint_corrupted_on_one_rank_walks_both_back(two_ranks):
    """Step 4's files of rank 1's shards bit-flipped: both ranks restore
    step 2, whose interior comes back bitwise."""
    got = json.loads((two_ranks / "resilience.json").read_text())
    assert got["corrupt_steps"] == [2, 2]
    np.testing.assert_array_equal(
        np.load(two_ranks / "corrupt_restored.npy"),
        workers.seeded_interior((16, 16, 16), 2))
