"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

Each kernel against its plain PyTorch twin on the card, at small odd
shapes, and the models' kernel paths against their plain ``xla`` paths.
Tolerances: 0 for the Jacobi kernels and laplace6 (they add and multiply
in their twins' order and are built -fmad=false); per field
``64 * eps(f32) * max |twin|`` for the MHD substep kernels (the same
order, but ``expf`` in the kernel and PyTorch's exp in the twin).
Without a CUDA device these skip. This file imports no JAX, so it runs
on a machine without it; there, skip the JAX-side ``tests/conftest.py``:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.local_domain import raw_size, zyx_shape

pytestmark = pytest.mark.gpu

SHAPES = [(5, 8, 7), (9, 16, 13), (3, 8, 33), (1, 8, 1)]


@pytest.fixture
def cs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from stencil_tpu_torch.ops import _build, cuda_stencil

    try:
        _build.find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    return cuda_stencil


def _rand(shape, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.random(shape).astype(np.float32)).cuda()


@pytest.mark.parametrize("shape", SHAPES)
def test_wrap_kernels_equal_twins(cs, shape):
    t = _rand(shape, 31)
    Z, Y, X = shape
    hot, cold, r = (X // 3, Y // 2, Z // 2), (2 * X // 3, Y // 2, Z // 2), 2
    before = dict(cs.LAUNCHES)
    assert torch.equal(cs.jacobi7_wrap_cuda(t, hot, cold, r),
                       cs.jacobi7_wrap_plain(t, hot, cold, r))
    for n in (1, 2, 3, 8):
        assert torch.equal(cs.jacobi7_wrapn_cuda(t, hot, cold, r, steps=n),
                           cs.jacobi7_wrapn_plain(t, hot, cold, r, steps=n))
    assert cs.LAUNCHES["jacobi7_wrap"] == before["jacobi7_wrap"] + 1
    assert cs.LAUNCHES["jacobi7_wrapn"] == before["jacobi7_wrapn"] + 4


@pytest.mark.parametrize("asym", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_padded_kernel_equals_twin(cs, shape, asym):
    r = Radius.constant(1)
    if asym:
        r.set_dir((1, 0, 0), 2)
        r.set_dir((0, 0, -1), 3)
    interior = Dim3(shape[2], shape[1], shape[0])
    p = _rand(zyx_shape(raw_size(interior, r)), 32)
    assert torch.equal(cs.jacobi7_padded_cuda(p, r, interior),
                       cs.jacobi7_padded_plain(p, r, interior))


def test_wrapper_never_takes_a_cuda_tensor_to_the_twin(cs):
    t = _rand((4, 8, 4), 33).to(torch.float64)
    with pytest.raises(TypeError):
        cs.jacobi7_wrap_cuda(t, (1, 4, 2), (2, 4, 2), 1)
    with pytest.raises(ValueError, match="contiguous"):
        cs.jacobi7_wrap_cuda(_rand((4, 8, 8), 34)[:, :, ::2],
                             (1, 4, 2), (2, 4, 2), 1)


@pytest.mark.parametrize("kernel,iters", [("wrap", 5), ("pallas", 3)])
def test_paths_agree_with_plain_path(cs, kernel, iters):
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    cs.reset_launch_counts()
    j = Jacobi3D(24, 16, 20, kernel=kernel, device="cuda")
    ref = Jacobi3D(24, 16, 20, kernel="xla", device="cuda")
    for m in (j, ref):
        m.init()
        m.run(iters)
    eps = float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(j.temperature(), ref.temperature(), rtol=0,
                               atol=iters * 8 * eps)
    if kernel == "wrap":
        assert cs.LAUNCHES["jacobi7_wrapn"] == iters // 2
        assert cs.LAUNCHES["jacobi7_wrap"] == iters % 2
    else:
        assert cs.LAUNCHES["jacobi7_padded"] == iters


# ---------------------------------------------------------------------------
# Astaroth MHD: B9/B10 (csrc/mhd.cu) and B8 (csrc/laplace6.cu)
# ---------------------------------------------------------------------------
MHD_SHAPES = [(8, 8, 8), (16, 8, 24), (8, 16, 40), (8, 8, 5)]
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def cm(cs):
    from stencil_tpu_torch.ops import cuda_mhd

    return cuda_mhd


def _mhd_state(shape, seed, w_scale=1e-3):
    """8 fields of sigma 0.1 and 8 w of sigma 0.1 * w_scale, float32 on
    the card, from a seeded numpy generator."""
    from stencil_tpu_torch.models.astaroth import FIELDS

    g = np.random.default_rng(seed)
    f = {q: torch.from_numpy(g.normal(0, 0.1, shape).astype(np.float32))
         .cuda() for q in FIELDS}
    w = {q: torch.from_numpy((g.normal(0, 0.1, shape) * w_scale)
                             .astype(np.float32)).cuda() for q in FIELDS}
    return f, w


def _assert_fields_close(got, want):
    """Per field: max |kernel - twin| <= 64 * eps(f32) * max |twin| (the
    kernels' expf and PyTorch's exp differ by an ulp, and the rates add
    many terms of either sign)."""
    assert set(got) == set(want)
    for q in want:
        err = float((got[q] - want[q]).abs().max())
        tol = 64 * EPS32 * float(want[q].abs().max())
        assert bool(torch.isfinite(got[q]).all()), q
        assert err <= tol, (q, err, tol)


@pytest.mark.parametrize("dt", [1e-8, 1e-4])
@pytest.mark.parametrize("shape", MHD_SHAPES)
def test_mhd_substep_kernel_matches_twin(cm, shape, dt):
    from stencil_tpu_torch.models.astaroth import MhdParams

    prm = MhdParams(dt=dt)
    f, w = _mhd_state(shape, 41)
    before = cm.LAUNCHES["mhd_substep_wrap"]
    for s, w_in, write_w in [(0, None, True), (1, w, True), (2, w, False),
                             (0, w, True), (2, w, True)]:
        kf, kw = cm.mhd_substep_wrap_cuda(f, w_in, s, prm, dt, write_w=write_w)
        tf, tw = cm.mhd_substep_wrap_plain(f, w_in, s, prm, dt,
                                           write_w=write_w)
        _assert_fields_close(kf, tf)
        if write_w:
            _assert_fields_close(kw, tw)
        else:
            assert kw is None and tw is None
    assert cm.LAUNCHES["mhd_substep_wrap"] == before + 5


@pytest.mark.parametrize("dt", [1e-8, 1e-4])
@pytest.mark.parametrize("shape", MHD_SHAPES)
def test_mhd_pair_kernel_matches_twin_and_two_substeps(cm, shape, dt):
    from stencil_tpu_torch.models.astaroth import MhdParams

    prm = MhdParams(dt=dt)
    f, _ = _mhd_state(shape, 42)
    before = dict(cm.LAUNCHES)
    kf, kw = cm.mhd_substep01_wrap_cuda(f, prm, dt)
    tf, tw = cm.mhd_substep01_wrap_plain(f, prm, dt)
    _assert_fields_close(kf, tf)
    _assert_fields_close(kw, tw)
    f1, w1 = cm.mhd_substep_wrap_cuda(f, None, 0, prm, dt)
    f2, w2 = cm.mhd_substep_wrap_cuda(f1, w1, 1, prm, dt)
    _assert_fields_close(kf, f2)
    _assert_fields_close(kw, w2)
    assert cm.LAUNCHES["mhd_substep01_wrap"] == before["mhd_substep01_wrap"] + 1
    assert cm.LAUNCHES["mhd_substep_wrap"] == before["mhd_substep_wrap"] + 2


def test_mhd_wrappers_never_take_a_cuda_tensor_to_the_twin(cm):
    from stencil_tpu_torch.models.astaroth import MhdParams

    f, w = _mhd_state((8, 8, 8), 43)
    f64 = {q: t.double() for q, t in f.items()}
    with pytest.raises(TypeError, match="float32"):
        cm.mhd_substep_wrap_cuda(f64, None, 0, MhdParams(), 1e-8)
    with pytest.raises(TypeError, match="float32"):
        cm.mhd_substep01_wrap_cuda(f64, MhdParams(), 1e-8)
    with pytest.raises(ValueError, match="alpha"):
        cm.mhd_substep_wrap_cuda(f, None, 1, MhdParams(), 1e-8)


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 8, 24), (5, 7, 33)])
def test_laplace6_kernel_equals_twin(cs, shape):
    Z, Y, X = shape
    r = Radius.constant(3)
    interior = Dim3(X, Y, Z)
    p = _rand(zyx_shape(raw_size(interior, r)), 44)
    inv = (1 / 0.049, 1 / 0.05, 1 / 0.047)
    before = cs.LAUNCHES["laplace6"]
    assert torch.equal(cs.laplace6_cuda(p, r, interior, inv),
                       cs.laplace6_plain(p, r, interior, inv))
    assert cs.LAUNCHES["laplace6"] == before + 1


@pytest.mark.parametrize("pair", ["0", "1"])
def test_astaroth_wrap_path_agrees_with_plain_path(cm, monkeypatch, pair):
    """Two iterations at 16 x 16 x 24 with dt = 1e-4: the wrap path
    (kernels) against the xla path (plain PyTorch), per field within
    substeps * 64 * eps(f32) * max|xla|; launch counts as the JAX
    model's grouping gives them."""
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth, MhdParams

    monkeypatch.setenv("STENCIL_MHD_PAIR", pair)
    prm = MhdParams(dt=1e-4)
    m = Astaroth(24, 16, 16, params=prm, kernel="auto", device="cuda")
    ref = Astaroth(24, 16, 16, params=prm, kernel="xla", device="cuda")
    assert m.kernel_path == "wrap"
    cm.reset_launch_counts()
    for a in (m, ref):
        a.init()
        a.run(2)
    if pair == "1":
        assert cm.LAUNCHES == {"mhd_substep_wrap": 2, "mhd_substep01_wrap": 2}
    else:
        assert cm.LAUNCHES == {"mhd_substep_wrap": 6, "mhd_substep01_wrap": 0}
    for q in FIELDS:
        got, want = m.field(q), ref.field(q)
        assert np.isfinite(got).all(), q
        assert np.abs(got - want).max() <= 6 * 64 * EPS32 * np.abs(want).max(), q
