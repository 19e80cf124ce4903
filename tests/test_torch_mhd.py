"""B9's plain twin against the JAX package's fused MHD substep kernel.

``mhd_substep_wrap_plain`` (``stencil_tpu_torch/ops/cuda_mhd.py``) is
held against ``mhd_substep_wrap_pallas`` run in interpret mode on the
CPU (inside ``reference_block_planner``, which its block planner
needs), on the same seeded numpy inputs: 8 fields of sigma 0.1 and,
where read, 8 accumulators ``w``. One chain per (dtype, dt): substep 0
with ``w=None``, substep 1 on JAX's (f1, w1), substep 2 with
``write_w=False`` on JAX's (f2, w2) — so each comparison isolates one
substep. Each runs at the default dt = 1e-8 and at dt = 1e-4, where an
error in the right-hand sides would show in f.

Tolerances: float32 per field ``max |port - jax| <= 64 * eps(f32) *
max |jax|``; float64 ``rtol=1e-11, atol=1e-13`` (the JAX package's own
wrap-vs-xla tolerance, tests/test_astaroth.py:82-83). They are not
bitwise: XLA's exp differs from PyTorch's in the last bit, and jax
0.9's CPU compiler contracts multiply-adds in the fused kernel body.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.models.astaroth import FIELDS as JFIELDS
from stencil_tpu.models.astaroth import MhdParams as JParams
from stencil_tpu.ops import pallas_mhd as jpm
from stencil_tpu_torch.models.astaroth import FIELDS, MhdParams
from stencil_tpu_torch.ops import cuda_mhd as cm
from torch_port_support import (assert_mhd_fields_match as
                                assert_fields_match, reference_block_planner)

jax.config.update("jax_platforms", "cpu")

SHAPE = (16, 8, 16)          # (Z, Y, X): two TPU blocks in z
CASES = [(np.float32, 1e-8), (np.float32, 1e-4),
         (np.float64, 1e-8), (np.float64, 1e-4)]


def _state(dtype, seed=7):
    rng = np.random.default_rng(seed)
    f = {q: rng.normal(0.0, 0.1, SHAPE).astype(dtype) for q in FIELDS}
    w = {q: (rng.normal(0.0, 0.1, SHAPE) * 1e-3).astype(dtype)
         for q in FIELDS}
    return f, w


def _t(d):
    return None if d is None else {q: torch.from_numpy(np.array(v))
                                   for q, v in d.items()}


def _j(d):
    return None if d is None else {q: jnp.asarray(v) for q, v in d.items()}


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{np.dtype(d).name}-dt{dt:g}" for d, dt in CASES])
def chain(request):
    """JAX's three substeps of one iteration, each on JAX's own inputs."""
    dtype, dt = request.param
    f0, _ = _state(dtype)
    prm = JParams(dt=dt)
    with reference_block_planner():
        f1, w1 = jpm.mhd_substep_wrap_pallas(_j(f0), None, 0, prm, dt,
                                             interpret=True)
        f2, w2 = jpm.mhd_substep_wrap_pallas(f1, w1, 1, prm, dt,
                                             interpret=True)
        f3, w3 = jpm.mhd_substep_wrap_pallas(f2, w2, 2, prm, dt,
                                             write_w=False, interpret=True)
    assert w3 is None
    return dict(dtype=dtype, dt=dt, f0=f0, f1=f1, w1=w1, f2=f2, w2=w2, f3=f3)


def test_substep0_without_w_matches_jax(chain):
    f, w = cm.mhd_substep_wrap_plain(_t(chain["f0"]), None, 0,
                                     MhdParams(dt=chain["dt"]), chain["dt"])
    assert_fields_match(f, chain["f1"], chain["dtype"])
    assert_fields_match(w, chain["w1"], chain["dtype"])


def test_substep1_matches_jax(chain):
    f, w = cm.mhd_substep_wrap_plain(_t(chain["f1"]), _t(chain["w1"]), 1,
                                     MhdParams(dt=chain["dt"]), chain["dt"])
    assert_fields_match(f, chain["f2"], chain["dtype"])
    assert_fields_match(w, chain["w2"], chain["dtype"])


def test_substep2_without_w_out_matches_jax(chain):
    f, w = cm.mhd_substep_wrap_plain(_t(chain["f2"]), _t(chain["w2"]), 2,
                                     MhdParams(dt=chain["dt"]), chain["dt"],
                                     write_w=False)
    assert w is None
    assert_fields_match(f, chain["f3"], chain["dtype"])


@pytest.fixture(scope="module")
def unelided():
    """The variants the model does not run, float32 at dt = 1e-4: substep
    0 reading an explicit w, substep 2 writing its w."""
    dt = 1e-4
    f, w = _state(np.float32, seed=8)
    prm = JParams(dt=dt)
    with reference_block_planner():
        s0 = jpm.mhd_substep_wrap_pallas(_j(f), _j(w), 0, prm, dt,
                                         interpret=True)
        s2 = jpm.mhd_substep_wrap_pallas(_j(f), _j(w), 2, prm, dt,
                                         write_w=True, interpret=True)
    return dict(f=f, w=w, dt=dt, s0=s0, s2=s2)


def test_substep0_reading_w_matches_jax_and_elision(unelided):
    dt, prm = unelided["dt"], MhdParams(dt=unelided["dt"])
    f, w = cm.mhd_substep_wrap_plain(_t(unelided["f"]), _t(unelided["w"]), 0,
                                     prm, dt)
    assert_fields_match(f, unelided["s0"][0], np.float32)
    assert_fields_match(w, unelided["s0"][1], np.float32)
    # alpha_0 == 0: reading w changes nothing (0 * w + dt * rates)
    f_none, w_none = cm.mhd_substep_wrap_plain(_t(unelided["f"]), None, 0,
                                               prm, dt)
    for q in FIELDS:
        assert torch.equal(f[q], f_none[q]) and torch.equal(w[q], w_none[q])


def test_substep2_writing_w_matches_jax_and_elision(unelided):
    dt, prm = unelided["dt"], MhdParams(dt=unelided["dt"])
    f, w = cm.mhd_substep_wrap_plain(_t(unelided["f"]), _t(unelided["w"]), 2,
                                     prm, dt, write_w=True)
    assert_fields_match(f, unelided["s2"][0], np.float32)
    assert_fields_match(w, unelided["s2"][1], np.float32)
    # write_w elision is exact
    f_el, w_el = cm.mhd_substep_wrap_plain(_t(unelided["f"]), _t(unelided["w"]),
                                           2, prm, dt, write_w=False)
    assert w_el is None
    for q in FIELDS:
        assert torch.equal(f[q], f_el[q])


def test_cpu_wrapper_routes_to_the_twin_and_launches_nothing():
    cm.reset_launch_counts()
    f, w = _state(np.float32, seed=9)
    prm = MhdParams(dt=1e-4)
    got_f, got_w = cm.mhd_substep_wrap_cuda(_t(f), _t(w), 1, prm, 1e-4)
    want_f, want_w = cm.mhd_substep_wrap_plain(_t(f), _t(w), 1, prm, 1e-4)
    for q in FIELDS:
        assert torch.equal(got_f[q], want_f[q])
        assert torch.equal(got_w[q], want_w[q])
    cm.mhd_substep01_wrap_cuda(_t(f), prm, 1e-4)
    assert cm.LAUNCHES == {"mhd_substep_wrap": 0, "mhd_substep01_wrap": 0,
                           "mhd_substep_halo": 0, "mhd_substep01_halo": 0}


def test_wrappers_keep_the_jax_layout_rules():
    prm = MhdParams()
    f, w = _state(np.float32)
    with pytest.raises(ValueError, match="alpha"):
        cm.mhd_substep_wrap_cuda(_t(f), None, 1, prm, 1e-8)
    bad = {q: torch.zeros((16, 12, 16)) for q in FIELDS}   # Y % 8 != 0
    with pytest.raises(ValueError, match="multiples of 8"):
        cm.mhd_substep_wrap_cuda(bad, None, 0, prm, 1e-8)
    with pytest.raises(ValueError, match="multiples of 8"):
        cm.mhd_substep01_wrap_cuda(bad, prm, 1e-8)
    missing = dict(_t(f))
    missing.pop("ss")
    with pytest.raises(ValueError, match="exactly"):
        cm.mhd_substep_wrap_cuda(missing, None, 0, prm, 1e-8)
    mixed = dict(_t(f))
    mixed["ss"] = mixed["ss"].double()
    with pytest.raises(ValueError, match="ss"):
        cm.mhd_substep_wrap_cuda(mixed, None, 0, prm, 1e-8)


def test_tile_and_compute_dtype_match_jax():
    assert FIELDS == JFIELDS
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64),
                     (torch.bfloat16, jnp.bfloat16)):
        assert cm.mhd_tile(tdt) == jpm.mhd_tile(jdt)
        assert (torch.empty((), dtype=cm.compute_dtype(tdt)).numpy().dtype
                == np.dtype(jpm.compute_dtype(jdt)))


def test_bfloat16_twin_stores_half_width_and_computes_in_float32():
    f, w = _state(np.float32, seed=10)
    prm = MhdParams(dt=1e-4)
    fb = {q: t.to(torch.bfloat16) for q, t in _t(f).items()}
    got, gw = cm.mhd_substep_wrap_plain(fb, None, 0, prm, 1e-4)
    ref, rw = cm.mhd_substep_wrap_plain({q: t.float() for q, t in fb.items()},
                                        None, 0, prm, 1e-4)
    for q in FIELDS:
        assert got[q].dtype == gw[q].dtype == torch.bfloat16
        assert torch.equal(got[q], ref[q].to(torch.bfloat16))
        assert torch.equal(gw[q], rw[q].to(torch.bfloat16))


def test_kernel_consts_follow_the_struct():
    """35 float32 constants in csrc/mhd.cu ``struct Consts`` order, each
    the twin's ``const(v, float32)``."""
    prm = MhdParams(dt=1e-4)
    c = cm.kernel_consts(prm, 1e-4, s=2)
    assert c.dtype == np.float32 and c.shape == (35,)
    ix = 1.0 / prm.dsx
    assert c[0] == np.float32(ix) and c[3] == np.float32(ix * ix)
    assert c[6] == np.float32(ix * (1.0 / prm.dsy))
    assert c[29] == np.float32(1e-4)
    assert c[30] == np.float32(-153.0 / 128.0) and c[31] == np.float32(8 / 15)
    assert tuple(c[32:]) == (np.float32(1 / 3), np.float32(-5 / 9),
                             np.float32(15 / 16))
