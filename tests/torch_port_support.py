"""Shared setup for the tests that hold stencil_tpu_torch against
stencil_tpu (tests/test_torch_*.py)."""

from __future__ import annotations

import contextlib
import sys

import numpy as np

#: names newer jax releases moved from ``jax.core`` to
#: ``jax.extend.core``; ``stencil_tpu/analysis/jaxprs.py`` reads them
#: from ``jax.core`` when the block planner is imported
_JAX_CORE_NAMES = ("Jaxpr", "ClosedJaxpr", "Literal", "Var")


@contextlib.contextmanager
def reference_block_planner():
    """Let the JAX package's wrap kernels run on this jax.

    ``jacobi7_wrap_pallas`` and ``jacobi7_wrapn_pallas`` choose their
    blocks through ``stencil_tpu.analysis.tiling``, whose package import
    reads ``jax.core.Jaxpr`` and its siblings (``ops/pallas_halo.py``
    imports it at module level). Where jax no longer has them there,
    lend the ``jax.extend.core`` objects for the duration, then take them
    back and drop every JAX-package module imported meanwhile, so every
    other test sees the process as it was. The JAX package itself is not
    touched."""
    import jax.core as jc
    import jax.extend.core as jec

    lent = []
    for name in _JAX_CORE_NAMES:
        try:
            getattr(jc, name)
        except AttributeError:
            setattr(jc, name, getattr(jec, name))
            lent.append(name)
    before = set(sys.modules)
    try:
        yield
    finally:
        if lent:
            for mod in sorted(set(sys.modules) - before, reverse=True):
                if not mod.startswith("stencil_tpu."):
                    continue
                del sys.modules[mod]
                parent, _, child = mod.rpartition(".")
                pkg = sys.modules.get(parent)
                if pkg is not None and child in vars(pkg):
                    delattr(pkg, child)
            for name in lent:
                delattr(jc, name)


def sphere_args(shape_zyx):
    """(hot, cold, radius) of the Jacobi spheres for a (Z, Y, X) grid,
    as both packages' ``sphere_geometry`` computes them, with the radius
    raised by one so that small grids have non-empty spheres."""
    Z, Y, X = shape_zyx
    return (X // 3, Y // 2, Z // 2), (2 * X // 3, Y // 2, Z // 2), X // 10 + 1


def halo_row_of(g, y, z):
    """csrc/mhd_common.cuh halo_row_of: (buffer, offset of the row's first
    float) of window row (z, y); g = (Z, Y, X, rz, ry)."""
    Z, Y, X, rz, ry = g
    if y < 0:
        return "ylo", ((z + rz) * ry + ry + y) * X
    if y >= Y:
        return "yhi", ((z + rz) * ry + y - Y) * X
    if z < 0:
        return "zlo", ((z + rz) * Y + y) * X
    if z >= Z:
        return "zhi", ((z - Z) * Y + y) * X
    return "shard", (z * Y + y) * X


def ring_row(bufs, g, axis, u, p):
    """Margin row u of slice p by the MHD ring kernel's rule
    (csrc/mhd_ring.cuh ring_run, kHaloRows): the row's source at slice
    pref = -1, 0 or N (N = Z for the z instance, Y for the y instance),
    stepped by the stride. ``bufs``: the shard and its four slabs by
    name; g = (Z, Y, X, rz, ry). The row must lie inside its buffer."""
    Z, Y, X, rz, ry = g
    N = Z if axis == "z" else Y
    pref = -1 if p < 0 else (0 if p < N else N)
    if axis == "z":
        name, base = halo_row_of(g, u, pref)
        stride = (Y if 0 <= u < Y else ry) * X
    else:
        name, base = halo_row_of(g, pref, u)
        stride = X
    flat = bufs[name].reshape(-1)
    off = base + (p - pref) * stride
    assert 0 <= off and off + X <= flat.numel(), (name, axis, u, p)
    return flat[off:off + X]


def shell_block(p, Z, Y, b, ty=16):
    """csrc/mhd_overlap.cu mhd_shell_kernel reading ShellPlan p (an
    ``ops/cuda_mhd_overlap.ShellLaunch``) on a (Z, Y, X) shard: the axis
    its block row b walks, the slices [s0, s1) and the tile rows [u0,
    min(u0 + ty, u1)); ty is the ring's tile rows (``RING_TILE_Y``)."""
    assert b < p.nzs * p.tz + p.nys * p.ty
    if b < p.nzs * p.tz:
        far = b >= p.tz
        b -= p.tz if far else 0
        return "z", (p.zt, Z) if far else (0, min(p.e, Z)), (b * ty, Y)
    b -= p.nzs * p.tz
    far = b >= p.ty
    b -= p.ty if far else 0
    return ("y", (p.yt, Y) if far else (0, min(p.e, Y)),
            (p.e + b * ty, Z - p.e))


def assert_mhd_fields_match(got, want, dtype):
    """Per field of an MHD state (``got`` and ``want`` map field names to
    tensors or arrays): float64 within ``rtol=1e-11, atol=1e-13`` (the
    JAX package's own wrap-vs-xla tolerance, tests/test_astaroth.py:82-83);
    float32 within ``64 * eps(f32) * max |want|``."""
    assert set(got) == set(want)
    for q in want:
        g, w = np.asarray(got[q]), np.asarray(want[q])
        assert g.dtype == w.dtype == dtype, q
        if dtype == np.float64:
            np.testing.assert_allclose(g, w, rtol=1e-11, atol=1e-13,
                                       err_msg=q)
        else:
            err = np.abs(g - w).max()
            assert err <= 64 * np.finfo(np.float32).eps * np.abs(w).max(), \
                (q, err)


#: (dtype, dt) of every MHD comparison: the default dt = 1e-8, where the
#: rates barely reach a float32 field, and 1e-4, where an error in them
#: shows in f
MHD_CASES = [(np.float32, 1e-8), (np.float32, 1e-4),
             (np.float64, 1e-8), (np.float64, 1e-4)]
MHD_CASE_IDS = [f"{np.dtype(d).name}-dt{dt:g}" for d, dt in MHD_CASES]


def jax_astaroth(kernel, dt, dtype, n=(16, 16, 16)):
    """The JAX model on one CPU device, a (1,1,1) mesh."""
    import jax

    from stencil_tpu.models import astaroth as jm

    return jm.Astaroth(*n, params=jm.MhdParams(dt=dt), mesh_shape=(1, 1, 1),
                       dtype=dtype, devices=jax.devices()[:1], kernel=kernel)


def port_astaroth(kernel, dt, dtype, n=(16, 16, 16)):
    """The port's model on the CPU."""
    import torch

    from stencil_tpu_torch.models import astaroth as pm

    return pm.Astaroth(*n, params=pm.MhdParams(dt=dt),
                       dtype={np.float32: torch.float32,
                              np.float64: torch.float64}[dtype],
                       kernel=kernel, device="cpu")


def astaroth_state(m):
    """({field: interior}, {field: w}) of either package's model, as
    numpy."""
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth

    if isinstance(m, Astaroth):
        return ({q: m.field(q) for q in FIELDS},
                {q: m.accumulator(q) for q in FIELDS})
    return ({q: m.field(q) for q in FIELDS},
            {q: np.asarray(m._w[q]) for q in FIELDS})


def jax_astaroth_w(m):
    """The JAX model's RK3 accumulators as global (z,y,x) interiors, as
    numpy: its ``_w`` as it is, or, on its temporal path (padded: one
    ``raw_size(local, alloc_radius)`` block per mesh position, the block
    of mesh position (x, y, z) at block index (z, y, x)), each block's
    interior, a short shard's dead rows dropped."""
    from stencil_tpu.geometry import Dim3

    if not m._w_padded:
        return {q: np.asarray(v) for q, v in m._w.items()}
    dd = m.dd
    lo = dd.alloc_radius.pad_lo()
    cnt = dd.placement.dim()
    out = {}
    for q, v in m._w.items():
        arr = np.asarray(v)
        pz, py, px = (arr.shape[0] // cnt.z, arr.shape[1] // cnt.y,
                      arr.shape[2] // cnt.x)
        w = np.empty((dd.size.z, dd.size.y, dd.size.x), arr.dtype)
        for iz in range(cnt.z):
            for iy in range(cnt.y):
                for ix in range(cnt.x):
                    sz = dd.placement.subdomain_size(Dim3(ix, iy, iz))
                    org = dd.placement.subdomain_origin(Dim3(ix, iy, iz))
                    z0, y0, x0 = iz * pz + lo.z, iy * py + lo.y, ix * px + lo.x
                    w[org.z:org.z + sz.z, org.y:org.y + sz.y,
                      org.x:org.x + sz.x] = arr[z0:z0 + sz.z, y0:y0 + sz.y,
                                                x0:x0 + sz.x]
        out[q] = w
    return out


def run_astaroth_pair(kernel, dt, dtype, steps=2):
    """(JAX state, port state) after ``init()`` and ``steps`` steps on
    path ``kernel`` in both packages."""
    with reference_block_planner():
        j = jax_astaroth(kernel, dt, dtype)
        j.init()
        for _ in range(steps):
            j.step()
        jstate = astaroth_state(j)
    p = port_astaroth(kernel, dt, dtype)
    p.init()
    for _ in range(steps):
        p.step()
    assert p.kernel_path == j.kernel_path == kernel
    return jstate, astaroth_state(p)
