"""The port's Astaroth model against the JAX package's, on one device.

Both models run the same problem from the same state: the repo's own
initial condition (``init()``: the reference's hash noise and radial
explosion) or a state carried across with ``astaroth_state_from_jax``.
The port runs on the CPU (``device="cpu"``); JAX on one CPU device with
a (1,1,1) mesh. Every comparison runs at the default dt = 1e-8 and at
dt = 1e-4 (at 1e-8 the rates barely reach a float32 field; at 1e-4 an
error in them shows in f), in float32 and float64, after 2 ``step()``s.

Tolerances (``torch_port_support.assert_mhd_fields_match``): float64
``rtol=1e-11, atol=1e-13``; float32 per field ``max |port - jax| <=
64 * eps(f32) * max |jax|``. The numpy initial conditions, the
parameters and the conf reader are compared exactly. This file holds
the ``xla`` path; ``test_torch_astaroth_wrap.py`` the kernel paths.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.geometry import Dim3 as JDim3
from stencil_tpu.models import astaroth as jm
from stencil_tpu.utils import config as jconfig
from stencil_tpu_torch import Boundary
from stencil_tpu_torch.convert import astaroth_state_from_jax
from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.models import astaroth as pm
from stencil_tpu_torch.ops.fd6 import FieldData
from stencil_tpu_torch.utils import config as pconfig
from torch_port_support import (MHD_CASE_IDS, MHD_CASES, assert_mhd_fields_match,
                                astaroth_state, jax_astaroth, port_astaroth,
                                reference_block_planner, run_astaroth_pair)

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parent.parent
TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}


# -- parameters, conf reader, initial conditions ------------------------
CONF = """// astaroth.conf-style
AC_dsx = 0.05
AC_dsy = 0.06 /* block
comment */
AC_dt = 1e-5
AC_nu_visc = 4e-3   // trailing comment
AC_mu0 = 2
AC_max_steps = 100
AC_name = abc
"""


def test_params_defaults_match_jax():
    assert dataclasses.asdict(pm.MhdParams()) == \
        dataclasses.asdict(jm.MhdParams())
    assert pm.MhdParams().cs2_sound == jm.MhdParams().cs2_sound
    assert (pm.RK3_ALPHA, pm.RK3_BETA, pm.FIELDS) == \
        (jm.RK3_ALPHA, jm.RK3_BETA, jm.FIELDS)


def test_conf_round_trip_matches_jax(tmp_path):
    path = tmp_path / "astaroth.conf"
    path.write_text(CONF)
    assert pconfig.parse_config(CONF) == jconfig.parse_config(CONF)
    assert pconfig.load_config(str(path)) == jconfig.load_config(str(path))
    got = pm.MhdParams.from_conf(str(path))
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(jm.MhdParams.from_conf(str(path)))
    assert (got.dsx, got.dsy, got.dt, got.mu0) == (0.05, 0.06, 1e-5, 2.0)


@pytest.mark.parametrize("value", [None, "", "0", "1", "true", "YES", "no"])
def test_mhd_pair_switch_reads_like_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("STENCIL_MHD_PAIR", raising=False)
    else:
        monkeypatch.setenv("STENCIL_MHD_PAIR", value)
    assert pconfig.mhd_pair_requested() == jconfig.mhd_pair_requested()


@pytest.mark.parametrize("shape", [(16, 16, 16), (5, 7, 9)])
def test_initial_conditions_are_bitwise_jax(shape):
    x = np.arange(1000, dtype=np.int64)
    np.testing.assert_array_equal(pm._hash64(x), jm._hash64(x))
    np.testing.assert_array_equal(pm._hash_field(shape),
                                  jm._hash_field(shape))
    nz, ny, nx = shape
    for got, want in zip(pm._radial_explosion(Dim3(nx, ny, nz),
                                              pm.MhdParams()),
                         jm._radial_explosion(JDim3(nx, ny, nz),
                                              jm.MhdParams())):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_init_state_is_bitwise_jax(dtype):
    j = jax_astaroth("xla", 1e-8, dtype, n=(12, 8, 16))
    p = port_astaroth("xla", 1e-8, dtype, n=(12, 8, 16))
    j.init()
    p.init()
    for q in pm.FIELDS:
        np.testing.assert_array_equal(p.field(q), j.field(q))


# -- right-hand sides ----------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rates_on_padded_fields_match_jax(dtype):
    """``mhd_rates`` over radius-3 padded FieldData, eagerly in both
    packages (exp is the only operation that may round differently)."""
    import jax.numpy as jnp

    from stencil_tpu.ops.fd6 import FieldData as JFieldData

    rng = np.random.default_rng(3)
    shape = (10, 11, 12)
    inv = (1 / 0.049, 1 / 0.05, 1 / 0.047)
    raw = {q: rng.normal(0.0, 0.1, shape).astype(dtype) for q in pm.FIELDS}
    lo, n = (3, 3, 3), (6, 5, 4)
    jd = {q: JFieldData(jnp.asarray(v), inv, JDim3(*lo), JDim3(*n))
          for q, v in raw.items()}
    pd = {q: FieldData(torch.from_numpy(v), inv, Dim3(*lo), Dim3(*n))
          for q, v in raw.items()}
    want = jm.mhd_rates(jd, jm.MhdParams(), jnp.dtype(dtype))
    got = pm.mhd_rates(pd, pm.MhdParams(), TORCH_DTYPE[dtype])
    assert_mhd_fields_match(got, want, dtype)


# -- the xla path ----------------------------------------------------------
@pytest.fixture(scope="module", params=MHD_CASES, ids=MHD_CASE_IDS)
def xla_runs(request):
    dtype, dt = request.param
    return dtype, run_astaroth_pair("xla", dt, dtype)


def test_xla_path_matches_jax_after_two_steps(xla_runs):
    dtype, ((jf, jw), (pf, pw)) = xla_runs
    assert_mhd_fields_match(pf, jf, dtype)
    assert_mhd_fields_match(pw, jw, dtype)
    for q in pm.FIELDS:
        assert np.isfinite(pf[q]).all()


@pytest.mark.parametrize("kernel", ["xla", "wrap"])
def test_state_carried_from_jax_then_one_step(kernel):
    """JAX takes one step; its fields and w go across bit for bit; then
    each package takes one more step (float32, dt = 1e-4)."""
    dt = 1e-4
    with reference_block_planner():
        j = jax_astaroth("xla", dt, np.float32)
        j.init()
        j.step()
        fields, w = astaroth_state(j)
        p = port_astaroth(kernel, dt, np.float32)
        p.load_state(fields, w)
        got_f, got_w = astaroth_state(p)
        for q in pm.FIELDS:
            np.testing.assert_array_equal(got_f[q], fields[q])
            np.testing.assert_array_equal(got_w[q], w[q])
        j.step()
        p.step()
        jf, _ = astaroth_state(j)
    pf, _ = astaroth_state(p)
    assert_mhd_fields_match(pf, jf, np.float32)


def test_state_from_jax_checks_what_it_is_given():
    f = {q: np.zeros((8, 8, 8), np.float32) for q in pm.FIELDS}
    dd = port_astaroth("xla", 1e-8, np.float32, n=(8, 8, 8)).dd
    padded, w = astaroth_state_from_jax(f, None, dd)
    assert w is None and tuple(padded["lnrho"][0].shape) == (14, 14, 14)
    with pytest.raises(ValueError, match="exactly"):
        astaroth_state_from_jax({"lnrho": f["lnrho"]}, None, dd)
    with pytest.raises(TypeError):
        astaroth_state_from_jax(f, {q: v.astype(np.float64)
                                    for q, v in f.items()}, dd)
    with pytest.raises(TypeError):
        astaroth_state_from_jax(f, None, dd, dtype=torch.float64)
    with pytest.raises(ValueError, match="domain's"):
        astaroth_state_from_jax({q: v[:4] for q, v in f.items()}, None, dd)


# -- path selection and what this slice leaves out ------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_auto_takes_xla_off_the_card_like_jax(dtype):
    p = port_astaroth("auto", 1e-8, dtype)
    with reference_block_planner():
        j = jax_astaroth("auto", 1e-8, dtype)
        assert p.kernel_path == j.kernel_path == "xla"
        assert p.exchange_stats() == j.exchange_stats()


def test_misaligned_wrap_raises_like_jax():
    n = (16, 12, 16)                        # y = 12 is no multiple of 8
    with pytest.raises(ValueError, match="sublane tile"):
        jax_astaroth("wrap", 1e-8, np.float32, n=n)
    with pytest.raises(ValueError, match="sublane tile"):
        port_astaroth("wrap", 1e-8, np.float32, n=n)
    assert port_astaroth("auto", 1e-8, np.float32, n=n).kernel_path == "xla"


@pytest.mark.parametrize("kw", [
    dict(exchange_every=3), dict(overlap=True, exchange_every=3),
    dict(exchange_every=2),
    dict(overlap=True, mesh_shape=(1, 2, 2), devices=["cpu"] * 4,
         kernel="xla", exchange_every=2),
    dict(boundary=Boundary.NONE), dict(dtype=torch.bfloat16)])
def test_left_out_options_name_their_roadmap_item(kw):
    """Temporal blocking beyond the halo paths' substep pair (ROADMAP
    A7b), with overlap too, Boundary.NONE (A8d) and bfloat16 (A8b): the
    port accepts each and takes JAX's path and allocation for it
    (``xla-temporal[s=N]``, ``-overlap``, ``xla``; their results against
    JAX's: tests/test_torch_astaroth_temporal.py,
    test_torch_astaroth_none.py, test_torch_astaroth_bf16.py)."""
    import jax.numpy as jnp

    from stencil_tpu.topology import Boundary as JBoundary

    pkw, jkw = dict(kw), dict(kw)
    if "devices" in kw:
        jkw["devices"] = jax.devices()[:4]
    else:
        pkw["device"] = "cpu"
        jkw.update(devices=jax.devices()[:1], mesh_shape=(1, 1, 1))
    if "boundary" in kw:
        jkw["boundary"] = JBoundary.NONE
    if "dtype" in kw:
        jkw["dtype"] = jnp.bfloat16
    p = pm.Astaroth(16, 16, 16, **pkw)
    j = jm.Astaroth(16, 16, 16, **jkw)
    assert p.kernel_path == j.kernel_path
    assert p.dd.alloc_radius.pad_lo() == tuple(j.dd.alloc_radius.pad_lo())


@pytest.mark.parametrize("kw", [
    dict(kernel="halo", exchange_every=3),
    dict(kernel="halo", boundary="none"),
    dict(kernel="wrap", boundary="none"),
    dict(kernel="halo", overlap=True, exchange_every=3)])
def test_kernels_the_rules_exclude_raise_like_jax(kw):
    """An explicit kernel that the path rules exclude (deep blocking or a
    zero exterior on the kernel paths) raises JAX's ``ValueError``, in
    JAX's words."""
    from stencil_tpu.topology import Boundary as JBoundary

    pkw, jkw = dict(kw), dict(kw)
    if "boundary" in kw:
        pkw["boundary"], jkw["boundary"] = Boundary.NONE, JBoundary.NONE
    with pytest.raises(ValueError) as want:
        jm.Astaroth(16, 16, 32, mesh_shape=(1, 1, 2),
                    devices=jax.devices()[:2], **jkw)
    with pytest.raises(ValueError) as got:
        pm.Astaroth(16, 16, 32, mesh_shape=(1, 1, 2),
                    devices=["cpu"] * 2, **pkw)
    assert str(got.value) == str(want.value)


def test_model_entry_point_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.Astaroth(16, 16, 16)


def test_field_copies_and_sync_domain_writes_back():
    p = port_astaroth("wrap", 1e-4, np.float32)
    p.init()
    p.step()
    got = p.field("uux")
    got[...] = 7.0                                   # a copy: no effect
    assert not np.all(p.field("uux") == 7.0)
    resident = p.field("ss")
    assert p._inner is not None
    p.sync_domain()
    assert p._inner is None
    np.testing.assert_array_equal(p.dd.interior_to_host("ss"), resident)
    assert p.measure_exchange_seconds() == 0.0


def test_app_prints_the_reference_csv_line(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "stencil_tpu_torch.apps.astaroth",
         "--nx", "16", "--ny", "8", "--nz", "8", "--iters", "2",
         "--kernel", "wrap", "--f64", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1].split(",")
    assert line[:4] == ["1", "16", "8", "8"]
    assert float(line[4]) > 0 and float(line[5]) == 0.0
    assert line[6:] == ["wrap", "0"]
