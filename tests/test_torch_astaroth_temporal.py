"""The port's MHD temporal path (``xla-temporal[s=N]``) against the JAX
package's, on the CPU.

Both models run ``Astaroth(..., kernel="xla", exchange_every=s)`` on the
same mesh of shards (the port's on ``devices=["cpu"] * n``, JAX's on as
many fake CPU devices, tests/conftest.py), from ``init()``, two runs
back to back: ``run(2)`` then ``run(3)`` (``run(4)`` then ``run(3)`` at
s = 4, whose period is four iterations), so that groups straddle
iterations, whole periods and tail iterations run, and w rides the deep
exchange where a group starts at alpha != 0. Each JAX model is built
once per module (its compile is most of its cost). Compared after each
run: the 8 fields, the 8 accumulators ``w`` (ring stripped) and
``exchange_stats()``. Also: ``temporal_shard_steps(exchange_keys=)`` on
a toy update, and a JAX state carried across mid-run, its padded ``w``
included.

Tolerances (``torch_port_support.assert_mhd_fields_match``): float32
per field ``max |port - jax| <= 64 * eps(f32) * max |jax|`` (jax 0.9's
CPU compiler contracts a*b+c into FMAs in fused loops); float64
``rtol=1e-11, atol=1e-13``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.geometry import Dim3 as JDim3, Radius as JRadius
from stencil_tpu.models import astaroth as jm
from stencil_tpu.parallel.methods import Method as JMethod
from stencil_tpu.parallel.temporal import (
    temporal_shard_steps as j_temporal_shard_steps)
from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.models import astaroth as pm
from stencil_tpu_torch.parallel.methods import Method
from stencil_tpu_torch.parallel.temporal import temporal_shard_steps
from torch_port_support import (assert_mhd_fields_match, jax_astaroth_w,
                                reference_block_planner)

jax.config.update("jax_platforms", "cpu")

DT = 1e-4          # large enough that the rates show in float32 fields
TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}

# id: (mesh, (nx, ny, nz), s, overlap, dtype, runs)
CASES = {
    "s2": ((1, 2, 2), (32, 32, 32), 2, False, np.float32, (2, 3)),
    "s3": ((1, 2, 2), (32, 32, 32), 3, False, np.float32, (2, 3)),
    "s4": ((1, 2, 2), (32, 32, 32), 4, False, np.float32, (4, 3)),
    "s3-overlap": ((1, 2, 2), (32, 32, 32), 3, True, np.float32, (2, 3)),
    "s2-mesh221": ((2, 2, 1), (32, 32, 32), 2, False, np.float32, (2, 3)),
    "s2-uneven": ((1, 2, 2), (34, 33, 32), 2, False, np.float64, (2, 3)),
}


def _n(mesh):
    return mesh[0] * mesh[1] * mesh[2]


def _state(m, port: bool):
    """(fields, interior-shaped w) of either model, as numpy."""
    if port:
        return ({q: m.field(q) for q in pm.FIELDS},
                {q: m.accumulator(q) for q in pm.FIELDS})
    return {q: m.field(q) for q in jm.FIELDS}, jax_astaroth_w(m)


def _models(case):
    mesh, size, s, overlap, dtype, _ = CASES[case]
    j = jm.Astaroth(*size, params=jm.MhdParams(dt=DT), mesh_shape=mesh,
                    dtype=dtype, devices=jax.devices()[:_n(mesh)],
                    kernel="xla", exchange_every=s, overlap=overlap)
    p = pm.Astaroth(*size, params=pm.MhdParams(dt=DT), mesh_shape=mesh,
                    dtype=TORCH_DTYPE[dtype], devices=["cpu"] * _n(mesh),
                    kernel="xla", exchange_every=s, overlap=overlap)
    return j, p


#: the cases this file runs; ``test_torch_astaroth_temporal_more.py``
#: runs the others, so that a worker of ``--dist loadfile`` compiles
#: half of the JAX models
HERE = ("s2", "s2-mesh221", "s4")


@pytest.fixture(scope="module", params=HERE)
def runs(request):
    return run_case(request.param)


def run_case(case):
    """Per case: the JAX and port states after each of the two runs, both
    models' exchange_stats, and a second port model that took JAX's
    fields and padded w after the first run (``load_state``), as loaded
    and after the second run."""
    mesh, size, s, overlap, dtype, (n1, n2) = CASES[case]
    j, p = _models(case)
    assert p.kernel_path == j.kernel_path
    j.init()
    p.init()
    out = {"case": case, "dtype": dtype, "path": p.kernel_path}
    j.run(n1)
    p.run(n1)
    out["first"] = (_state(j, False), _state(p, True))
    fields = {q: j.field(q) for q in jm.FIELDS}
    wpad = {q: np.asarray(j._w[q]) for q in jm.FIELDS}
    c = pm.Astaroth(*size, params=pm.MhdParams(dt=DT), mesh_shape=mesh,
                    dtype=TORCH_DTYPE[dtype], devices=["cpu"] * _n(mesh),
                    kernel="xla", exchange_every=s, overlap=overlap)
    c.load_state(fields, wpad)
    loaded = {q: c.field(q) for q in pm.FIELDS}
    blocks = []
    for i in range(c.dd.num_subdomains()):
        m = c.dd.shard_index(i)
        got = {q: c._w[i][q].numpy().copy() for q in pm.FIELDS}
        Z, Y, X = got["uux"].shape
        blocks.append((got, {q: wpad[q][m.z * Z:(m.z + 1) * Z,
                                        m.y * Y:(m.y + 1) * Y,
                                        m.x * X:(m.x + 1) * X]
                             for q in pm.FIELDS}))
    out["carry"] = (fields, loaded, blocks)
    j.run(n2)
    p.run(n2)
    c.run(n2)
    out["second"] = (_state(j, False), _state(p, True))
    out["carried"] = (out["second"][0], _state(c, True))
    with reference_block_planner():
        out["stats"] = (j.exchange_stats(), p.exchange_stats())
    return out


def _held(pair, dtype):
    (jf, jw), (pf, pw) = pair
    assert_mhd_fields_match(pf, jf, dtype)
    assert_mhd_fields_match(pw, jw, dtype)
    for q in pm.FIELDS:
        assert np.isfinite(pf[q]).all()


def test_temporal_path_matches_jax_after_the_first_run(runs):
    assert runs["path"].startswith("xla-temporal[s=")
    _held(runs["first"], runs["dtype"])


def test_temporal_path_matches_jax_after_the_second_run(runs):
    _held(runs["second"], runs["dtype"])


def test_temporal_exchange_stats_match_jax(runs):
    got_j, got_p = runs["stats"]
    assert got_p == got_j
    assert got_p["path"] == runs["path"]


def test_state_carried_from_jax_mid_run_with_its_padded_w(runs):
    """JAX's fields and padded ``_w`` after the first run go across bit
    for bit (``load_state``; the w ring included); the port then takes
    the second run and meets JAX's state after it."""
    fields, loaded, blocks = runs["carry"]
    for q in pm.FIELDS:
        np.testing.assert_array_equal(loaded[q], fields[q])
    for got, want in blocks:
        for q in pm.FIELDS:
            np.testing.assert_array_equal(got[q], want[q])
    _held(runs["carried"], runs["dtype"])


# -- temporal_shard_steps(exchange_keys=) on a toy update -----------------
@pytest.mark.parametrize("with_w", [False, True])
def test_exchange_keys_match_jax_on_a_toy_update(with_w):
    """Two fields through one depth-3 group of a 6-point average on a
    (1,2,2) mesh: ``u`` always rides the exchange, ``w`` only when
    ``exchange_keys`` names it; where it does not, its ring cells keep
    what earlier sub-steps wrote there, in both packages."""
    from jax.sharding import PartitionSpec as P

    from stencil_tpu.parallel.mesh import make_mesh

    r, s = 1, 3
    mesh = (1, 2, 2)
    local = (8, 8, 8)              # (x, y, z) per shard
    pad = s * r
    shape = tuple(c * m + 2 * pad * m for c, m in zip(local[::-1],
                                                     mesh[::-1]))
    rng = np.random.default_rng(5)
    gu = rng.random(shape)
    gw = rng.random(shape)
    keys = ["u", "w"] if with_w else ["u"]

    def upd_np(blocks, dims, k):
        # sums, then one multiply: no a*b+c for a compiler to contract
        out = {}
        for q in ("u", "w"):
            b = blocks[q]
            acc = (b[1:-1, 1:-1, 2:] + b[1:-1, 1:-1, :-2]
                   + b[1:-1, 2:, 1:-1] + b[1:-1, :-2, 1:-1]
                   + b[2:, 1:-1, 1:-1] + b[:-2, 1:-1, 1:-1])
            if q == "w":
                acc = acc + blocks["u"][1:-1, 1:-1, 1:-1]
            out[q] = (acc + (k + 1) * 0.01) * (1.0 / 6.0)
        return out

    jmesh = make_mesh(JDim3(*mesh), jax.devices()[:4])
    spec = P("z", "y", "x")

    def shard_fn(u, w):
        out = j_temporal_shard_steps(
            {"u": u, "w": w}, JRadius.constant(r), JDim3(*mesh),
            JMethod.PpermuteSlab,
            lambda b, d, o, k: upd_np(b, d, k), s,
            exchange_keys=keys)
        return out["u"], out["w"]

    ju, jw = jax.jit(jax.shard_map(shard_fn, mesh=jmesh,
                                   in_specs=(spec, spec),
                                   out_specs=(spec, spec),
                                   check_vma=False))(jnp.asarray(gu),
                                                     jnp.asarray(gw))
    ju, jw = np.asarray(ju), np.asarray(jw)

    counts = Dim3(*mesh)
    bz, by = shape[0] // mesh[2], shape[1] // mesh[1]
    shards = {q: [] for q in ("u", "w")}
    for i in range(4):
        iy, iz = i % 2, i // 2
        for q, g in (("u", gu), ("w", gw)):
            shards[q].append(torch.from_numpy(
                g[iz * bz:(iz + 1) * bz, iy * by:(iy + 1) * by].copy()))
    temporal_shard_steps(shards, Radius.constant(r), counts,
                         Method.PpermuteSlab,
                         lambda b, d, o, k, i: upd_np(b, d, k), s,
                         exchange_keys=keys)
    for q, want in (("u", ju), ("w", jw)):
        for i in range(4):
            iy, iz = i % 2, i // 2
            np.testing.assert_array_equal(
                shards[q][i].numpy(),
                want[iz * bz:(iz + 1) * bz, iy * by:(iy + 1) * by],
                err_msg=f"{q} shard {i}")
