"""bfloat16 storage in the port's MHD model and twins against the JAX
package's, on the CPU.

bfloat16 fields are stored half-width and computed in float32 in both
packages (``compute_dtype``). numpy has no bfloat16: the port's
``field``/``accumulator`` hand out float32 arrays holding the bf16
values exactly, compared here with JAX's ``field(q).astype(float32)``
(an ml_dtypes array) as float32 bits; JAX's arrays go into the port by
their ``uint16`` bits or as float32 values (``convert``).

* ``init()``: bitwise (both round the float64 initial conditions
  through float32).
* The twins B9 (each substep), B11 (each substep, on JAX's slabs) and
  B10, B12 (the pairs, whose f_1 and w_1 stay float32 in both) against
  the JAX kernels, interpreted on the CPU under
  ``reference_block_planner()``, on one (16, 16, 16) shard: within one
  bf16 ulp of the largest JAX value per field (2^-7 x max), since both
  compute in float32 and round once; jax 0.9's CPU compiler contracts
  a*b+c, so the float32 values may differ by a few ulps before the
  rounding.
* The ``xla`` model against JAX's after two steps; the port's ``wrap``
  and ``halo`` paths (their twins) against its ``xla`` path: within
  one bf16 ulp of max a substep (6 x 2^-7 x max).
* A JAX bf16 state carried across, bit for bit.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from stencil_tpu.geometry import Dim3 as JDim3
from stencil_tpu.models import astaroth as jm
from stencil_tpu.ops import pallas_mhd as jpm
from stencil_tpu.parallel.exchange import exchange_interior_slabs as jex
from stencil_tpu_torch.models import astaroth as pm
from stencil_tpu_torch.ops import cuda_mhd as cm
from torch_port_support import reference_block_planner

jax.config.update("jax_platforms", "cpu")

BF16 = jnp.bfloat16
ULP = 2.0 ** -7                 # one bf16 ulp, relative to the value
SHAPE = (16, 16, 16)            # (Z, Y, X): one bf16 tile of 16 rows
DT = 1e-4


def _host(d):
    """JAX bf16 arrays (or a dict of them) as float32 numpy."""
    return {q: np.asarray(v).astype(np.float32) for q, v in d.items()}


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _held(got, want, ulps=1.0, what=""):
    """Per field: max |got - want| <= ulps * 2^-7 * max |want| (float32
    arrays of bf16 values)."""
    assert set(got) == set(want)
    for q in want:
        g = np.asarray(got[q], np.float32)
        w = np.asarray(want[q], np.float32)
        assert np.isfinite(g).all(), (what, q)
        err = np.abs(g - w).max()
        assert err <= ulps * ULP * np.abs(w).max(), (what, q, err)


def _state(seed):
    rng = np.random.default_rng(seed)
    f = {q: rng.normal(0.0, 0.1, SHAPE).astype(ml_dtypes.bfloat16)
         for q in pm.FIELDS}
    w = {q: (rng.normal(0.0, 1e-4, SHAPE)).astype(ml_dtypes.bfloat16)
         for q in pm.FIELDS}
    return f, w


def _t(d):
    """bf16 numpy (ml_dtypes) as bf16 tensors, by their bits."""
    if d is None:
        return None
    return {q: (_t(v) if isinstance(v, dict) else
                torch.from_numpy(np.asarray(v).view(np.uint16).copy()
                                 .astype(np.int16)).view(torch.bfloat16))
            for q, v in d.items()}


def _j(d):
    if d is None:
        return None
    return {q: (_j(v) if isinstance(v, dict) else jnp.asarray(v))
            for q, v in d.items()}


def _np(d):
    return None if d is None else {q: np.asarray(v) for q, v in d.items()}


def _f32(d):
    return {q: v.float().numpy() for q, v in d.items()}


# -- init --------------------------------------------------------------------
def test_init_state_is_bitwise_jax():
    j = jm.Astaroth(16, 16, 32, mesh_shape=(1, 1, 1), dtype=BF16,
                    devices=jax.devices()[:1], kernel="xla")
    p = pm.Astaroth(16, 16, 32, dtype=torch.bfloat16, kernel="xla",
                    device="cpu")
    j.init()
    p.init()
    for q in pm.FIELDS:
        got = p.field(q)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(
            _bits(got), _bits(np.asarray(j.field(q)).astype(np.float32)))


# -- the twins against JAX's interpreted kernels ----------------------------
@pytest.fixture(scope="module")
def wrap_chain():
    """JAX's B9 substeps of one iteration, each on its own bf16 inputs,
    and its B10 pair."""
    f, w = _state(31)
    prm = jm.MhdParams(dt=DT)
    with reference_block_planner():
        out = {}
        for s, w_in, write_w in ((0, None, True), (1, w, True),
                                 (2, w, False)):
            got = jpm.mhd_substep_wrap_pallas(_j(f), _j(w_in), s, prm, DT,
                                              write_w=write_w,
                                              interpret=True)
            out[s] = tuple(_np(g) for g in got)
        out["pair"] = tuple(_np(g) for g in jpm.mhd_substep01_wrap_pallas(
            _j(f), prm, DT, interpret=True))
    return f, w, out


@pytest.mark.parametrize("s", [0, 1, 2])
def test_b9_twin_matches_jax_in_bf16(wrap_chain, s):
    f, w, want = wrap_chain
    write_w = s != 2
    got_f, got_w = cm.mhd_substep_wrap_plain(
        _t(f), _t(w) if s else None, s, pm.MhdParams(dt=DT), DT,
        write_w=write_w)
    assert got_f["ss"].dtype == torch.bfloat16
    _held(_f32(got_f), _host(want[s][0]), what=f"B9 s={s} f")
    if write_w:
        _held(_f32(got_w), _host(want[s][1]), what=f"B9 s={s} w")
    else:
        assert got_w is None and want[s][1] is None


def test_b10_pair_twin_matches_jax_in_bf16(wrap_chain):
    f, _, want = wrap_chain
    got_f, got_w = cm.mhd_substep01_wrap_plain(_t(f), pm.MhdParams(dt=DT),
                                               DT)
    _held(_f32(got_f), _host(want["pair"][0]), what="B10 f")
    _held(_f32(got_w), _host(want["pair"][1]), what="B10 w")


def test_bf16_pair_keeps_f1_w1_in_float32():
    """The pair's intermediates are float32, never rounded to bf16 (as in
    every JAX pair form), so it is not two bf16 substeps: equal to the
    float32 pair on the widened fields, rounded once."""
    f, _ = _state(32)
    prm = pm.MhdParams(dt=DT)
    pf, pw = cm.mhd_substep01_wrap_plain(_t(f), prm, DT)
    wide = {q: v.float() for q, v in _t(f).items()}
    ff, fw = cm.mhd_substep01_wrap_plain(wide, prm, DT)
    for q in pm.FIELDS:
        assert torch.equal(pf[q], ff[q].to(torch.bfloat16)), q
        assert torch.equal(pw[q], fw[q].to(torch.bfloat16)), q


def _jax_slabs(seed, rows):
    """JAX's bf16 slabs of one (16, 16, 16) shard on a (1,1,1) mesh (the
    wrapped edges of a second field): rz = 16, ry = 16."""
    g, _ = _state(seed)
    return {q: {k: np.asarray(v) for k, v in
                jex(jnp.asarray(g[q]), JDim3(1, 1, 1), rz=16, ry=16,
                    radius_rows=rows, y_z_extended=True).items()}
            for q in pm.FIELDS}


@pytest.fixture(scope="module")
def halo_chain():
    f, w = _state(41)
    prm = jm.MhdParams(dt=DT)
    sl3, sl6 = _jax_slabs(42, 3), _jax_slabs(43, 6)
    with reference_block_planner():
        from stencil_tpu.ops.pallas_halo import (mhd_substep01_halo_pallas,
                                                 mhd_substep_halo_pallas)
        out = {}
        for s, w_in, write_w in ((0, None, True), (1, w, True),
                                 (2, w, False)):
            got = mhd_substep_halo_pallas(_j(f), _j(w_in), _j(sl3), s, prm,
                                          DT, write_w=write_w,
                                          interpret=True)
            out[s] = tuple(_np(g) for g in got)
        out["pair"] = tuple(_np(g) for g in mhd_substep01_halo_pallas(
            _j(f), _j(sl6), prm, DT, interpret=True))
    return f, w, sl3, sl6, out


@pytest.mark.parametrize("s", [0, 1, 2])
def test_b11_twin_matches_jax_in_bf16(halo_chain, s):
    f, w, sl3, _, want = halo_chain
    write_w = s != 2
    got_f, got_w = cm.mhd_substep_halo_plain(
        _t(f), _t(w) if s else None, _t(sl3), s, pm.MhdParams(dt=DT), DT,
        write_w=write_w)
    _held(_f32(got_f), _host(want[s][0]), what=f"B11 s={s} f")
    if write_w:
        _held(_f32(got_w), _host(want[s][1]), what=f"B11 s={s} w")


def test_b12_pair_twin_matches_jax_in_bf16(halo_chain):
    f, _, _, sl6, want = halo_chain
    got_f, got_w = cm.mhd_substep01_halo_plain(_t(f), _t(sl6),
                                               pm.MhdParams(dt=DT), DT)
    _held(_f32(got_f), _host(want["pair"][0]), what="B12 f")
    _held(_f32(got_w), _host(want["pair"][1]), what="B12 w")


# -- the model's paths -----------------------------------------------------
@pytest.fixture(scope="module")
def xla_runs():
    """JAX's and the port's bf16 ``xla`` models after two steps, and
    JAX's state after its first (to carry across)."""
    j = jm.Astaroth(16, 16, 32, params=jm.MhdParams(dt=DT),
                    mesh_shape=(1, 1, 1), dtype=BF16,
                    devices=jax.devices()[:1], kernel="xla")
    p = pm.Astaroth(16, 16, 32, params=pm.MhdParams(dt=DT),
                    dtype=torch.bfloat16, kernel="xla", device="cpu")
    j.init()
    p.init()
    j.step()
    carry = ({q: np.asarray(j.field(q)) for q in jm.FIELDS},
             {q: np.asarray(j._w[q]) for q in jm.FIELDS})
    j.step()
    p.run(2)
    return dict(
        jax=({q: np.asarray(j.field(q)).astype(np.float32)
              for q in jm.FIELDS},
             {q: np.asarray(j._w[q]).astype(np.float32) for q in jm.FIELDS}),
        port=({q: p.field(q) for q in pm.FIELDS},
              {q: p.accumulator(q) for q in pm.FIELDS}),
        carry=carry, jax_dtype=np.asarray(j.field("ss")).dtype)


def test_xla_path_matches_jax_in_bf16(xla_runs):
    (jf, jw), (pf, pw) = xla_runs["jax"], xla_runs["port"]
    assert xla_runs["jax_dtype"] == ml_dtypes.bfloat16
    assert all(v.dtype == np.float32 for v in pf.values())
    _held(pf, jf, ulps=6, what="xla f")
    _held(pw, jw, ulps=6, what="xla w")


@pytest.mark.parametrize("form", ["uint16 bits", "float32 values"])
def test_bf16_state_carried_from_jax(xla_runs, form):
    """JAX's bf16 fields and w after one step go across bit for bit, by
    their bits or as float32 values; then one step in each package."""
    fields, w = xla_runs["carry"]
    conv = ((lambda a: a.view(np.uint16)) if form == "uint16 bits"
            else (lambda a: a.astype(np.float32)))
    p = pm.Astaroth(16, 16, 32, params=pm.MhdParams(dt=DT),
                    dtype=torch.bfloat16, kernel="xla", device="cpu")
    p.load_state({q: conv(v) for q, v in fields.items()},
                 {q: conv(v) for q, v in w.items()})
    for q in pm.FIELDS:
        np.testing.assert_array_equal(
            _bits(p.field(q)), _bits(fields[q].astype(np.float32)))
        np.testing.assert_array_equal(
            _bits(p.accumulator(q)), _bits(w[q].astype(np.float32)))
    p.step()
    _held({q: p.field(q) for q in pm.FIELDS}, xla_runs["jax"][0], ulps=3,
          what="carried f")


@pytest.mark.parametrize("kernel,mesh", [("wrap", (1, 1, 1)),
                                         ("halo", (1, 2, 2))])
def test_kernel_paths_match_xla_in_bf16(kernel, mesh):
    """The port's ``wrap`` and ``halo`` paths (their twins, on the CPU)
    against its ``xla`` path on the same mesh, two steps, bf16; the
    kernel paths need local z and y multiples of 16."""
    n = mesh[1] * mesh[2]
    got = {}
    for k in (kernel, "xla"):
        m = pm.Astaroth(16, 32, 32, params=pm.MhdParams(dt=DT),
                        dtype=torch.bfloat16, kernel=k, mesh_shape=mesh,
                        devices=["cpu"] * n)
        assert m.kernel_path == k
        m.init()
        m.run(2)
        got[k] = {q: m.field(q) for q in pm.FIELDS}
    _held(got[kernel], got["xla"], ulps=6, what=kernel)


def test_misaligned_bf16_kernel_paths_raise_like_jax():
    """bf16's tile is 16 rows: a (1,1,1) 16 x 8 x 16 grid is no wrap
    grid in either package, and auto takes xla off the card."""
    with pytest.raises(ValueError, match="sublane tile \\(16\\)"):
        jm.Astaroth(16, 8, 16, mesh_shape=(1, 1, 1), dtype=BF16,
                    devices=jax.devices()[:1], kernel="wrap")
    with pytest.raises(ValueError, match="sublane tile \\(16\\)"):
        pm.Astaroth(16, 8, 16, dtype=torch.bfloat16, kernel="wrap",
                    device="cpu")
