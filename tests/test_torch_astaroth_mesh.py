"""The port's Astaroth model on meshes of shards against the JAX
package's.

The port's shards lie on the CPU (``devices=["cpu"] * n``), where the
kernel wrappers run their plain twins (``cuda_mhd.LAUNCHES`` stays 0);
the JAX model runs on as many fake CPU devices (tests/conftest.py). The
reference is JAX's ``xla`` path on the same mesh: its interpreted
``halo`` path would take minutes a run. Both start from ``init()`` and
take 2 ``step()``s.

Tolerances: float64 ``rtol=1e-11, atol=1e-13`` (the JAX package's own
halo-vs-xla bound, tests/test_halo.py:246-247), float32 per field
``max |port - jax| <= 64 * eps(f32) * max |jax|``. The halo path is held
on its fields: it carries substep 1's w, the xla path substep 2's. The
port's xla path is held on fields and w.
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.models import astaroth as jm
from stencil_tpu.parallel.mesh import mesh_dim
from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.models import astaroth as pm
from stencil_tpu_torch.ops import cuda_mhd as cm
from torch_port_support import (MHD_CASE_IDS, MHD_CASES, assert_mhd_fields_match,
                                astaroth_state, reference_block_planner)

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parent.parent
TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}
SIZE = {(1, 2, 2): (16, 16, 16), (1, 2, 4): (16, 16, 32)}   # (nx, ny, nz)


def _n(mesh):
    return mesh[0] * mesh[1] * mesh[2]


def jax_model(kernel, mesh, size, dt, dtype):
    return jm.Astaroth(*size, params=jm.MhdParams(dt=dt), mesh_shape=mesh,
                       dtype=dtype, devices=jax.devices()[:_n(mesh)],
                       kernel=kernel)


def port_model(kernel, mesh, size, dt, dtype, **kw):
    return pm.Astaroth(*size, params=pm.MhdParams(dt=dt), mesh_shape=mesh,
                       dtype=TORCH_DTYPE[dtype], devices=["cpu"] * _n(mesh),
                       kernel=kernel, **kw)


def _steps(m, n=2):
    m.init()
    for _ in range(n):
        m.step()
    return astaroth_state(m)


_JAX_RUNS = {}


def jax_xla_state(mesh, size, dt, dtype):
    """JAX's xla path after init() and 2 steps, once per configuration."""
    key = (mesh, size, dt, np.dtype(dtype).name)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _steps(jax_model("xla", mesh, size, dt, dtype))
    return _JAX_RUNS[key]


HALO_CASES = ([((1, 2, 2), d, dt) for d, dt in MHD_CASES]
              + [((1, 2, 4), np.float64, dt) for dt in (1e-8, 1e-4)])
HALO_IDS = ([f"(1,2,2)-{i}" for i in MHD_CASE_IDS]
            + [f"(1,2,4)-float64-dt{dt:g}" for dt in (1e-8, 1e-4)])


@pytest.mark.parametrize("pair", ["0", "1"])
@pytest.mark.parametrize("mesh,dtype,dt", HALO_CASES, ids=HALO_IDS)
def test_halo_path_on_a_mesh_matches_jax(monkeypatch, mesh, dtype, dt, pair):
    monkeypatch.setenv("STENCIL_MHD_PAIR", pair)
    jf, _ = jax_xla_state(mesh, SIZE[mesh], dt, dtype)
    cm.reset_launch_counts()
    p = port_model("halo", mesh, SIZE[mesh], dt, dtype)
    assert p.dd.mesh_counts == Dim3(*mesh) and p.kernel_path == "halo"
    pf, pw = _steps(p)
    assert_mhd_fields_match(pf, jf, dtype)
    assert all(np.isfinite(v).all() for v in pf.values())
    assert set(cm.LAUNCHES.values()) == {0}      # CPU: twins, no launches


@pytest.mark.parametrize("mesh,size", [
    ((1, 2, 2), (16, 16, 16)),
    ((2, 2, 1), (16, 16, 12)),          # x sharded: no halo path
    ((1, 2, 2), (12, 13, 11)),          # uneven (+-1) y and z shards
    ((2, 1, 2), (13, 12, 9)),           # uneven x and z
])
def test_xla_path_on_a_mesh_matches_jax(mesh, size):
    dtype, dt = np.float64, 1e-4
    jf, jw = jax_xla_state(mesh, size, dt, dtype)
    p = port_model("xla", mesh, size, dt, dtype)
    assert p.kernel_path == "xla"
    pf, pw = _steps(p)
    assert_mhd_fields_match(pf, jf, dtype)
    if all(size[a] % mesh[a] == 0 for a in range(3)):
        # JAX's w of an uneven mesh is capacity-shaped, dead rows included
        assert_mhd_fields_match(pw, jw, dtype)


def test_halo_on_one_shard_equals_wrap_bitwise():
    """On a (1,1,1) mesh the slabs are the shard's own wrapped rows: the
    halo path's twins compute the wrap path's, bit for bit."""
    runs = [_steps(port_model(k, (1, 1, 1), (16, 16, 16), 1e-4, np.float32))
            for k in ("halo", "wrap")]
    for q in pm.FIELDS:
        np.testing.assert_array_equal(runs[0][0][q], runs[1][0][q])
        np.testing.assert_array_equal(runs[0][1][q], runs[1][1][q])


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("mesh", [(1, 1, 1), (1, 2, 2), (1, 2, 4), (2, 2, 1)])
def test_exchange_stats_match_jax(monkeypatch, mesh, pair):
    monkeypatch.setenv("STENCIL_MHD_PAIR", "1" if pair else "0")
    kernel = "xla" if mesh[0] > 1 else "halo"
    size = (16, 16, 32)
    p = port_model(kernel, mesh, size, 1e-8, np.float32)
    with reference_block_planner():
        j = jax_model(kernel, mesh, size, 1e-8, np.float32)
        assert p.exchange_stats() == j.exchange_stats()
    assert p.measure_exchange_seconds(reps=1) >= 0.0


def test_exchange_every_2_takes_the_pair_like_jax(monkeypatch):
    monkeypatch.setenv("STENCIL_MHD_PAIR", "0")
    mesh, size = (1, 2, 2), (16, 16, 16)
    p = port_model("halo", mesh, size, 1e-8, np.float32, exchange_every=2)
    with reference_block_planner():
        j = jm.Astaroth(*size, mesh_shape=mesh, dtype=np.float32,
                        devices=jax.devices()[:4], kernel="halo",
                        exchange_every=2)
        assert p.exchange_stats() == j.exchange_stats()
    assert p.exchange_stats()["rounds_per_iteration"] == 2.0


def test_default_mesh_and_path_follow_jax():
    """With no mesh shape, ``kernel="halo"`` takes JAX's x-unsharded
    decomposition; ``auto`` off the card takes ``xla`` on JAX's default
    mesh."""
    size = (16, 16, 32)
    for kernel in ("halo", "auto"):
        p = pm.Astaroth(*size, devices=["cpu"] * 4, kernel=kernel)
        with reference_block_planner():
            j = jm.Astaroth(*size, devices=jax.devices()[:4], kernel=kernel)
        assert tuple(p.dd.mesh_counts) == tuple(mesh_dim(j.dd.mesh))
        assert p.kernel_path == j.kernel_path


def test_halo_refuses_what_jax_refuses():
    msg = "x-unsharded mesh"
    for mesh, size in (((2, 1, 2), (16, 16, 16)), ((1, 2, 2), (16, 12, 16))):
        with pytest.raises(ValueError, match=msg):
            port_model("halo", mesh, size, 1e-8, np.float32)
        with reference_block_planner():
            with pytest.raises(ValueError, match=msg):
                jax_model("halo", mesh, size, 1e-8, np.float32)


def test_reinit_resets_state():
    """tests/test_halo.py:249-261: re-init() after stepping is not lost
    in the interior-resident state."""
    m = port_model("halo", (1, 2, 2), (16, 16, 16), 1e-8, np.float64)
    m.init()
    m.step()
    after_one = m.field("uux").copy()
    m.init()
    m.step()
    np.testing.assert_array_equal(m.field("uux"), after_one)


def test_set_interior_after_step_is_honored():
    """tests/test_halo.py:263-274: ``dd.set_interior`` between steps
    flushes the resident state first, then reaches the fast path."""
    m = port_model("halo", (1, 2, 2), (16, 16, 16), 1e-8, np.float64)
    m.init()
    m.step()
    before = m.field("uux").copy()
    new_ss = np.zeros((16, 16, 16), dtype=np.float64)
    m.dd.set_interior("ss", new_ss)
    assert m._inner is None
    np.testing.assert_array_equal(m.field("ss"), new_ss)
    np.testing.assert_array_equal(m.field("uux"), before)
    m.step()
    assert not np.array_equal(m.field("ss"), new_ss)


def test_state_carried_from_jax_onto_a_mesh():
    """JAX takes one step on (1,2,2); its global fields and w go across
    into the port's four shards bit for bit; then each takes one more
    step on its xla path (float64, dt = 1e-4)."""
    mesh, size, dt = (1, 2, 2), (16, 16, 16), 1e-4
    j = jax_model("xla", mesh, size, dt, np.float64)
    j.init()
    j.step()
    fields, w = astaroth_state(j)
    p = port_model("xla", mesh, size, dt, np.float64)
    p.load_state(fields, w)
    got_f, got_w = astaroth_state(p)
    for q in pm.FIELDS:
        np.testing.assert_array_equal(got_f[q], fields[q])
        np.testing.assert_array_equal(got_w[q], w[q])
    j.step()
    p.step()
    assert_mhd_fields_match(astaroth_state(p)[0], astaroth_state(j)[0],
                            np.float64)


def test_state_scatter_over_an_uneven_mesh():
    from stencil_tpu_torch.convert import astaroth_state_from_jax

    p = port_model("xla", (1, 2, 2), (12, 13, 11), 1e-8, np.float64)
    rng = np.random.default_rng(61)
    f = {q: rng.random((11, 13, 12)) for q in pm.FIELDS}
    padded, w = astaroth_state_from_jax(f, f, p.dd)
    for q in pm.FIELDS:
        assert len(padded[q]) == len(w[q]) == 4
        np.testing.assert_array_equal(p.dd.assemble_interior(padded[q]), f[q])
        assert tuple(w[q][3].shape) == (6, 7, 12)      # capacity (z, y, x)
        assert float(w[q][3][5:].abs().max()) == 0.0     # dead z row
    with pytest.raises(ValueError, match="interior's"):
        astaroth_state_from_jax(f, {q: v[1:] for q, v in f.items()}, p.dd)


def test_app_runs_a_mesh_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "stencil_tpu_torch.apps.astaroth",
         "--nx", "16", "--ny", "8", "--nz", "8", "--iters", "1",
         "--kernel", "halo", "--mesh-shape", "1,2,2", "--devices",
         "cpu,cpu,cpu,cpu", "--f64"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1].split(",")
    assert line[:4] == ["4", "16", "16", "16"]     # per-device size x mesh
    assert float(line[4]) > 0 and float(line[5]) > 0
    assert line[6] == "halo" and int(line[7]) > 0
