"""The port's plan file, comm matrix, ParaView dumps and exchange timing
(``stencil_tpu_torch/distributed.py``) against the JAX package's.

``plan.txt`` must equal JAX's line for line except the
``subdomain ... -> device ...`` lines (device names differ between the
packages; the subdomain and index parts are compared), and
``comm_matrix.txt`` and every ``write_paraview`` CSV byte for byte
(float32, float64, bfloat16 widened to float32) for the same state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.distributed import DistributedDomain as JDomain
from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu_torch.distributed import DistributedDomain
from stencil_tpu_torch.models.jacobi import Jacobi3D

jax.config.update("jax_platforms", "cpu")

CASES = [  # size, mesh, radius, exchange_every, quantities
    ((16, 16, 16), (1, 2, 2), 1, 1, ("q",)),
    ((15, 17, 16), (2, 2, 2), 2, 1, ("a", "b")),
    ((16, 16, 32), (1, 1, 4), 1, 2, ("q",)),
    ((12, 12, 12), (1, 1, 1), 1, 1, ("q",)),
]


def _split(text):
    dev = [ln.split(" -> device ")[0] for ln in text.splitlines()
           if " -> device " in ln]
    rest = [ln for ln in text.splitlines() if " -> device " not in ln]
    return dev, rest


@pytest.mark.parametrize("size,mesh,r,s,names", CASES)
@pytest.mark.parametrize("mode", ["auto", "qap"])
def test_plan_file_and_comm_matrix_equal_jax(tmp_path, size, mesh, r, s,
                                             names, mode):
    n = int(np.prod(mesh))
    jd = JDomain(*size, devices=jax.devices()[:n])
    pd = DistributedDomain(*size, devices=["cpu"] * n)
    for d, dt, tag in ((jd, np.float32, "jax_"), (pd, torch.float32,
                                                  "port_")):
        d.set_radius(r)
        d.set_mesh_shape(mesh)
        d.set_placement(mode)
        if s > 1:
            d.set_exchange_every(s)
        d.set_output_prefix(str(tmp_path / tag))
        for q in names:
            d.add_data(q, dt)
        d.realize()
    jplan = (tmp_path / "jax_plan.txt").read_text()
    pplan = (tmp_path / "port_plan.txt").read_text()
    assert _split(pplan) == _split(jplan)
    assert pplan.count("message ") == jplan.count("message ")
    assert (tmp_path / "port_comm_matrix.txt").read_bytes() == \
        (tmp_path / "jax_comm_matrix.txt").read_bytes()
    assert pd.plan_provenance == jd.plan_provenance == "default"
    # the per-message bytes add up to the domain's exchange total on the
    # periodic, even grids (every halo row crosses once per message)
    if s == 1 and r == 1 and n > 1 and size[0] % mesh[0] == 0:
        msgs = [int(ln.rsplit(": ", 1)[1].split()[0])
                for ln in pplan.splitlines() if ln.startswith("message ")]
        assert sum(msgs) > 0


def test_output_prefix_comes_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("STENCIL_OUTPUT_PREFIX", str(tmp_path / "env_"))
    pd = DistributedDomain(8, 8, 8, devices=["cpu"] * 2)
    pd.set_radius(1)
    pd.add_data("q")
    pd.realize()
    assert (tmp_path / "env_plan.txt").exists()
    assert set(pd.setup_seconds) == {"partition", "placement", "realize",
                                     "plan"}


def test_jacobi_output_prefix_writes_jax_plan(tmp_path):
    jj = JJacobi3D(16, 16, 16, mesh_shape=(1, 2, 2), dtype=np.float32,
                   devices=jax.devices()[:4], kernel="xla",
                   output_prefix=str(tmp_path / "j_"))
    pj = Jacobi3D(16, 16, 16, mesh_shape=(1, 2, 2), devices=["cpu"] * 4,
                  kernel="xla", output_prefix=str(tmp_path / "p_"))
    assert _split((tmp_path / "p_plan.txt").read_text()) == \
        _split((tmp_path / "j_plan.txt").read_text())
    assert jj.dd._output_prefix and pj.dd._output_prefix


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("size,mesh", [((6, 5, 4), (1, 1, 1)),
                                       ((9, 8, 7), (2, 2, 1))])
def test_paraview_csv_equals_jax_bytes(tmp_path, dtype, size, mesh):
    n = int(np.prod(mesh))
    rng = np.random.default_rng(5)
    vals = {q: (rng.standard_normal(size[::-1]) * 1e3).astype(np.float64)
            for q in ("a", "b")}
    jd = JDomain(*size, devices=jax.devices()[:n])
    pd = DistributedDomain(*size, devices=["cpu"] * n)
    for d, dt in ((jd, getattr(jnp, dtype)), (pd, getattr(torch, dtype))):
        d.set_radius(1)
        d.set_mesh_shape(mesh)
        d.add_data("a", dt)
        d.add_data("b", dt)
        d.realize()
    for q, v in vals.items():
        jv = np.asarray(jnp.asarray(v, dtype=getattr(jnp, dtype)))
        jd.set_interior(q, jv)
        pd.set_interior(q, torch.from_numpy(v).to(getattr(torch, dtype)))
    jd.write_paraview(str(tmp_path / "jax_"))
    pd.write_paraview(str(tmp_path / "port_"))
    for i in range(n):
        want = (tmp_path / f"jax_{i}.txt").read_bytes()
        assert (tmp_path / f"port_{i}.txt").read_bytes() == want
        assert want.startswith(b"Z,Y,X,a,b\n")


def test_enable_timing_keeps_raw_exchange_seconds():
    pd = DistributedDomain(8, 8, 8, devices=["cpu"] * 4)
    pd.set_radius(1)
    pd.add_data("q")
    pd.realize()
    pd.exchange()
    assert pd.exchange_seconds == []
    pd.enable_timing(True)
    for _ in range(3):
        pd.exchange()
    assert len(pd.exchange_seconds) == 3
    assert all(t > 0 for t in pd.exchange_seconds)
    pd.enable_timing(False)
    pd.exchange()
    assert len(pd.exchange_seconds) == 3
