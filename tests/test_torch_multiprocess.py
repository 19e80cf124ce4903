"""stencil_tpu_torch across processes: gloo worlds of two and four ranks
on the CPU, started by ``multihost.spawn_ranks`` (``spawn``, a
``file://`` rendezvous under ``tmp_path``), against the one-process
port and the JAX package.

The rank functions live in ``torch_mp_workers`` (no JAX, so a rank
starts in about a second); each world runs once per module and writes
its results, which the tests read. NCCL is not in this image: gloo
moves the CPU tensors. Tolerance: bitwise everywhere — a message moves
the same bits a one-process copy does, and every rank computes its own
shards as the one process computes them.
"""

import json

import jax
import numpy as np
import pytest
import torch

import torch_mp_workers as workers
from stencil_tpu_torch.models.astaroth import Astaroth
from stencil_tpu_torch.models.jacobi import Jacobi3D
from stencil_tpu_torch.parallel import multihost
from torch_port_support import reference_block_planner

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


@pytest.mark.parametrize("path", ["jacobi_overlap", "jacobi_halo_overlap",
                                  "jacobi_pallas_dma", "allgather",
                                  "astaroth_halo_overlap", "pic"])
def test_a4c_paths_refuse_a_mesh_across_ranks(two_ranks, path):
    """The overlap paths, B4 (PallasDMA), the all-gather engine and PIC
    raise NotImplementedError naming ROADMAP A4c on a mesh over two
    ranks."""
    got = json.loads((two_ranks / "refusals.json").read_text())
    assert got[path] == "A4c"


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
