"""The port's Astaroth overlap paths against the JAX package's.

* Path selection: ``select_kernel_path`` (and the model built on the CPU)
  against the path JAX's ``Astaroth`` builds, for auto/halo/xla/wrap x
  overlap x mesh x uneven grid x dtype — the port's on-CUDA choice
  against JAX's on-TPU choice (``on_tpu`` patched for JAX's selection;
  nothing is compiled for a TPU), and both off the accelerator. A kernel
  a package refuses raises the same error class in both.
* ``halo-overlap`` on CPU shards (``devices=["cpu"] * 4``: the B13/B14
  twins) equals the port's ``halo`` bitwise after 2 iterations, with and
  without the substep pair, fields and carried w, and launches no
  kernel.
* ``xla-overlap`` against JAX's ``xla-overlap`` model on the same fake
  CPU mesh from the same state (float64, ``rtol=1e-11, atol=1e-13``: jax
  0.9 contracts a*b+c), and with ``methods=Method.PallasDMA`` against the
  slab method bitwise.
* ``exchange_stats`` of ``halo-overlap`` equal to JAX's.
* ``apps/astaroth.py --overlap`` and ``apps/measure_overlap.py --model
  mhd`` on ``--device cpu`` print their CSV lines.
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.models import astaroth as jm
from stencil_tpu_torch import Method
from stencil_tpu_torch.models import astaroth as pm
from stencil_tpu_torch.ops import cuda_mhd as cm
from stencil_tpu_torch.ops import cuda_mhd_overlap as mo
from torch_port_support import astaroth_state, reference_block_planner

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parent.parent

MESHES = [((1, 1, 1), (16, 16, 16)),
          ((1, 2, 2), (16, 16, 32)),
          ((2, 2, 1), (16, 16, 16)),      # x sharded
          ((1, 2, 2), (16, 16, 24)),      # local z = 12: not a tile multiple
          ((1, 2, 2), (16, 16, 31))]      # uneven z
COMBOS = ([(overlap, kernel, mesh, size, np.float32)
           for overlap in (False, True)
           for kernel in ("auto", "halo", "xla", "wrap")
           for mesh, size in MESHES]
          + [(overlap, kernel, mesh, size, np.float64)
             for overlap in (False, True) for kernel in ("auto", "halo")
             for mesh, size in MESHES[:2]])


def _ids(c):
    overlap, kernel, mesh, size, dtype = c
    return (f"{'overlap' if overlap else 'plain'}-{kernel}-"
            f"{''.join(map(str, mesh))}-{'x'.join(map(str, size))}-"
            f"{np.dtype(dtype).name}")


@pytest.mark.parametrize("combo", COMBOS, ids=[_ids(c) for c in COMBOS])
def test_kernel_path_matches_jax(monkeypatch, combo):
    from stencil_tpu.ops import pallas_stencil

    overlap, kernel, mesh, size, dtype = combo
    n = mesh[0] * mesh[1] * mesh[2]
    tdtype = {np.float32: torch.float32, np.float64: torch.float64}[dtype]
    for accel in (False, True):
        monkeypatch.setattr(pallas_stencil, "on_tpu", lambda a=accel: a)
        with reference_block_planner():
            try:
                jj = jm.Astaroth(*size, mesh_shape=mesh, dtype=dtype,
                                 devices=jax.devices()[:n], kernel=kernel,
                                 overlap=overlap)
                want = jj.kernel_path
            except (ValueError, NotImplementedError) as e:
                want = type(e)
        dd = pm.Astaroth(*size, kernel="xla", mesh_shape=mesh, dtype=tdtype,
                         devices=["cpu"] * n).dd
        try:
            got = pm.select_kernel_path(kernel, overlap, dd.mesh_counts,
                                        dd.rem, dd.local_size,
                                        cm.mhd_tile(tdtype),
                                        accel and dtype == np.float32)
        except (ValueError, NotImplementedError) as e:
            got = type(e)
        assert got == want, (accel, got, want)
        if not accel:
            try:
                p = pm.Astaroth(*size, kernel=kernel, overlap=overlap,
                                mesh_shape=mesh, dtype=tdtype,
                                devices=["cpu"] * n)
                built = p.kernel_path
            except (ValueError, NotImplementedError) as e:
                built = type(e)
            assert built == want


def _model(kernel, overlap, pair, monkeypatch, dtype=torch.float64,
           methods=Method.PpermutePacked, size=(16, 32, 48)):
    monkeypatch.setenv("STENCIL_MHD_PAIR", pair)
    return pm.Astaroth(*size, params=pm.MhdParams(dt=1e-4), kernel=kernel,
                       overlap=overlap, mesh_shape=(1, 2, 2), dtype=dtype,
                       devices=["cpu"] * 4, methods=methods)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pair", ["0", "1"])
def test_halo_overlap_on_cpu_shards_equals_halo_bitwise(monkeypatch, pair,
                                                        dtype):
    runs = []
    for overlap in (False, True):
        m = _model("halo", overlap, pair, monkeypatch, dtype)
        assert m.kernel_path == ("halo-overlap" if overlap else "halo")
        m.init()
        cm.reset_launch_counts()
        mo.reset_launch_counts()
        m.run(1)
        m.step()
        assert not any(cm.LAUNCHES.values())
        assert not any(mo.LAUNCHES.values())
        runs.append(astaroth_state(m))
    for q in pm.FIELDS:
        np.testing.assert_array_equal(runs[1][0][q], runs[0][0][q], err_msg=q)
        np.testing.assert_array_equal(runs[1][1][q], runs[0][1][q], err_msg=q)


def test_xla_overlap_matches_jax_and_pallas_dma_equals_slab(monkeypatch):
    """16 x 32 x 48 (x, y, z) on (1,2,2), float64, init() and 2 steps."""
    size, mesh = (16, 32, 48), (1, 2, 2)
    jj = jm.Astaroth(*size, params=jm.MhdParams(dt=1e-4), mesh_shape=mesh,
                     dtype=np.float64, devices=jax.devices()[:4],
                     kernel="xla", overlap=True)
    assert jj.kernel_path == "xla-overlap"
    jj.init()
    jj.step()
    jj.step()
    jf, jw = astaroth_state(jj)
    runs = {}
    for label, methods in (("slab", Method.PpermuteSlab),
                           ("dma", Method.PallasDMA)):
        p = _model("xla", True, "0", monkeypatch, methods=methods, size=size)
        assert p.kernel_path == "xla-overlap"
        p.init()
        p.step()
        p.step()
        runs[label] = astaroth_state(p)
    for q in pm.FIELDS:
        np.testing.assert_allclose(runs["slab"][0][q], jf[q], rtol=1e-11,
                                   atol=1e-13, err_msg=q)
        np.testing.assert_allclose(runs["slab"][1][q], jw[q], rtol=1e-11,
                                   atol=1e-13, err_msg=q)
        for j in (0, 1):
            np.testing.assert_array_equal(runs["dma"][j][q],
                                          runs["slab"][j][q], err_msg=q)


@pytest.mark.parametrize("pair", ["0", "1"])
def test_halo_overlap_exchange_stats_match_jax(monkeypatch, pair):
    monkeypatch.setenv("STENCIL_MHD_PAIR", pair)
    with reference_block_planner():
        jj = jm.Astaroth(16, 32, 48, mesh_shape=(1, 2, 2), dtype=np.float32,
                         devices=jax.devices()[:4], kernel="halo",
                         overlap=True)
        assert jj.kernel_path == "halo-overlap"
        want = jj.exchange_stats()
    p = _model("halo", True, pair, monkeypatch, dtype=torch.float32)
    assert p.exchange_stats() == want
    assert p.measure_exchange_seconds(reps=1) > 0


def _app(args, tmp_path):
    out = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1].split(",")


def test_astaroth_app_overlap_on_cpu(tmp_path):
    for flags, path in ((["--kernel", "halo"], "halo-overlap"),
                        (["--kernel", "xla", "--pallas-dma"], "xla-overlap")):
        line = _app(["stencil_tpu_torch.apps.astaroth", "--nx", "16", "--ny",
                     "8", "--nz", "8", "--iters", "1", "--overlap",
                     "--mesh-shape", "1,2,2", "--device", "cpu", *flags],
                    tmp_path)
        assert line[:4] == ["4", "16", "16", "16"]
        assert float(line[4]) > 0 and float(line[5]) > 0
        assert line[6] == path and int(line[7]) > 0


def test_measure_overlap_mhd_on_cpu(tmp_path):
    line = _app(["stencil_tpu_torch.apps.measure_overlap", "--model", "mhd",
                 "--x", "16", "--y", "8", "--z", "8", "--iters", "2",
                 "--mesh-shape", "1,2,2", "--device", "cpu"], tmp_path)
    assert line[:5] == ["measure_overlap_mhd", "4", "16", "16", "16"]
    t_ex, t_fused, t_over, eff = map(float, line[5:])
    assert min(t_ex, t_fused, t_over) > 0
    assert eff == pytest.approx((t_fused - t_over) / t_ex, abs=1e-3)
