"""The port's segments (``stencil_tpu_torch/parallel/megastep.py``) on
Jacobi3D, PIC and ``DistributedDomain`` against the port's own stepwise
runs and against the JAX package's ``make_segment``.

Every Jacobi path the port builds runs one segment of 5 steps (probe
rows every 2 steps and at the end, the ``StepMetrics`` columns on the
padded paths) from the same seeded numpy field as JAX's model on the
same mesh: JAX over its fake CPU devices (Pallas kernels interpreted
inside ``reference_block_planner``), the port over ``["cpu"] * n``
shards, where the CUDA wrappers route to their plain twins. The
``overlap`` path is held against JAX's ``xla`` segment, since JAX's
remote-DMA kernel does not execute on this CPU. PIC runs NGP in float64
with ``budget=1``, so that the overflow column is nonzero.

Tolerance: bitwise (``assert_array_equal``) against the port's own runs
everywhere, and against JAX everywhere but one place: the segment runs
the same bodies as ``run(k)``; Jacobi has no ``a*b+c`` for XLA to
contract and the port groups steps where JAX does; NGP deposits of unit
charges and the float64 push are exact; the probe's count is an integer
and its max |finite| a float32 max, exact in any order. The exception:
the ``overlap`` path's fields against JAX's ``xla`` path, within
``2**-21`` absolute (values in [0, 1]): B7 sums the seven points in the
order of JAX's overlap kernel, not of its ``xla`` path, one rounding
apart a step (its trace, whose max is the hot sphere's 1.0, is
bitwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from stencil_tpu.distributed import DistributedDomain as JDomain
from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.models.pic import Pic as JPic
from stencil_tpu.parallel.exchange import exchange_shard as j_exchange
from stencil_tpu.parallel.mesh import mesh_dim
from stencil_tpu.telemetry.probe import StepMetrics as JStepMetrics
from stencil_tpu.topology import Boundary as JBoundary
from stencil_tpu_torch import Boundary, Jacobi3D, Radius
from stencil_tpu_torch.distributed import DistributedDomain
from stencil_tpu_torch.models.pic import PARTICLE_STATE_KEYS, Pic
from stencil_tpu_torch.parallel.exchange import dispatch_exchange
from stencil_tpu_torch.parallel.megastep import Segment
from stencil_tpu_torch.parallel.methods import Method
from stencil_tpu_torch.telemetry.probe import StepMetrics
from torch_port_support import reference_block_planner

jax.config.update("jax_platforms", "cpu")

K = 5
PROBE_EVERY = 2

#: case: (x, y, z), mesh, kernel, exchange_every, boundary, overlap, path,
#: probe steps of a 5-step segment at probe_every=2, JAX's path to hold
#: it against
CASES = {
    "xla": ((16, 16, 16), (2, 2, 2), "xla", None, None, False, "xla",
            (2, 4, 5)),
    "xla-none-uneven": ((17, 17, 17), (2, 2, 2), "xla", None, "none", False,
                        "xla", (2, 4, 5)),
    "pallas": ((16, 16, 16), (1, 2, 2), "pallas", None, None, False,
               "pallas", (2, 4, 5)),
    "pallas-none-uneven": ((17, 16, 15), (1, 2, 2), "pallas", None, "none",
                           False, "pallas", (2, 4, 5)),
    "temporal": ((16, 16, 16), (2, 2, 1), "xla", 2, None, False,
                 "xla-temporal[s=2]", (2, 4, 5)),
    "temporal-none-uneven": ((17, 15, 14), (1, 2, 2), "xla", 2, "none",
                             False, "xla-temporal[s=2]", (2, 4, 5)),
    "wrap": ((16, 16, 16), (1, 1, 1), "wrap", None, None, False, "wrap",
             (2, 4, 5)),
    "halo": ((16, 16, 16), (1, 2, 2), "halo", None, None, False, "halo",
             (2, 4, 5)),
    "halo-uneven": ((16, 15, 17), (1, 2, 2), "halo", None, None, False,
                    "halo", (2, 4, 5)),
    "overlap": ((16, 16, 16), (1, 2, 2), "halo", None, None, True,
                "overlap", (2, 4, 5)),
}
#: the padded paths carry the StepMetrics columns
METRICS = ("xla", "xla-none-uneven", "pallas", "temporal")


def _port(case, n_devices):
    (x, y, z), mesh, kernel, s, bnd, overlap = CASES[case][:6]
    j = Jacobi3D(x, y, z, dtype=torch.float32, kernel=kernel,
                 mesh_shape=mesh, devices=["cpu"] * n_devices,
                 exchange_every=s, overlap=overlap,
                 boundary=Boundary.NONE if bnd else None)
    return j


def _seed(j, vals):
    j.load_interior(vals)
    return j


@pytest.mark.parametrize("case", sorted(CASES))
def test_jacobi_segment_equals_run_and_jax(case):
    """One 5-step segment: fields bitwise the port's ``run(5)``, the
    trace (and fields) bitwise JAX's segment; a second segment continues
    as ``run`` does."""
    (x, y, z), mesh, kernel, s, bnd, overlap, path, probes = CASES[case]
    n = mesh[0] * mesh[1] * mesh[2]
    vals = np.random.default_rng(19).random((z, y, x)).astype(np.float32)
    a, b = _seed(_port(case, n), vals), _seed(_port(case, n), vals)
    assert b.kernel_path == path
    metrics = StepMetrics(b.dd) if case in METRICS else None
    a.run(K)
    seg = b.make_segment(K, probe_every=PROBE_EVERY, metrics=metrics)
    assert isinstance(seg, Segment) and seg.fn is None
    assert seg.steps == K and seg.probe_steps == probes
    tr = seg.run(3)
    assert tr.abs_steps == [3 + r for r in probes]
    np.testing.assert_array_equal(b.temperature(), a.temperature())
    # JAX's segment (the overlap case: JAX's xla path)
    jkernel = "xla" if overlap else kernel
    with reference_block_planner():
        jj = JJacobi3D(x, y, z, dtype=np.float32, kernel=jkernel,
                       mesh_shape=mesh, devices=jax.devices()[:n],
                       exchange_every=s,
                       boundary=JBoundary.NONE if bnd else None)
        jj.dd.set_interior("temp", vals)
        jm = JStepMetrics(jj.dd) if metrics is not None else None
        jtr = jj.make_segment(K, probe_every=PROBE_EVERY, metrics=jm).run(3)
        want = np.asarray(jtr.array)
        jtemp = np.asarray(jj.temperature())
    assert tuple(jtr.steps) == tr.steps
    np.testing.assert_array_equal(tr.array.numpy(), want)
    if overlap:
        np.testing.assert_allclose(b.temperature(), jtemp, rtol=0,
                                   atol=2.0 ** -21)
    else:
        np.testing.assert_array_equal(b.temperature(), jtemp)
    # a second segment continues the state as run() does
    a.run(3)
    b.make_segment(3).run(K)
    np.testing.assert_array_equal(b.temperature(), a.temperature())


def test_jacobi_segment_probe_trips_on_a_planted_nan():
    """A NaN planted in a shard before a segment: every row counts it,
    while the rows of a clean twin count none."""
    j = _port("halo", 4)
    j.init()
    j.dd.curr["temp"][3][5, 5, 5] = float("nan")
    rows = j.make_segment(4).run(0).array.numpy()
    assert rows.shape == (2, 2, 1)
    assert (rows[:, 0, 0] > 0).all()
    clean = _port("halo", 4)
    clean.init()
    rows = clean.make_segment(4).run(0).array.numpy()
    assert (rows[:, 0, 0] == 0).all() and (rows[:, 1, 0] == 1.0).all()


def _pic_particles(n, grid, seed):
    """Seeded particles whose thermal speeds carry a few of them across
    a shard face each step (positions away from the CFL bound)."""
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(0, grid[0], n), "y": rng.uniform(0, grid[1], n),
            "z": rng.uniform(0, grid[2], n),
            "vx": rng.normal(0, 1.5, n), "vy": rng.normal(0, 1.5, n),
            "vz": rng.normal(0, 1.5, n), "q": np.ones(n)}


def test_pic_segment_equals_steps_and_jax():
    """PIC NGP float64 on (2,2,2), ``budget=1``: a 3-step segment is
    bitwise three ``step()`` calls on every state key (the overflow
    counts included, nonzero), its trace (rho, the seven lanes, the
    overflow column) bitwise JAX's, a later ``step()`` continues bitwise,
    and ``make_sentinel`` decodes the overflow column as JAX's does."""
    grid, n = (8, 8, 8), 96
    parts = _pic_particles(n, grid, 23)
    kw = dict(mesh_shape=(2, 2, 2), devices=["cpu"] * 8,
              dtype=torch.float64, deposition="ngp", budget=1, capacity=48)
    a, b = Pic(*grid, n, **kw), Pic(*grid, n, **kw)
    a.set_particles(parts)
    b.set_particles(parts)
    for _ in range(3):
        a.step()
    tr = b.make_segment(3).run(0)
    assert tr.steps == (1, 2, 3) and tuple(tr.array.shape) == (3, 2, 9)
    for k in ("rho",) + PARTICLE_STATE_KEYS:
        for u, v in zip(a.state[k], b.state[k]):
            assert torch.equal(u, v), k
    assert b.overflow_total() > 0
    assert (tr.array[:, 0, 8] > 0).any()
    a.step()
    b.step()
    np.testing.assert_array_equal(b.rho(), a.rho())
    with reference_block_planner():
        jp = JPic(*grid, n, mesh_shape=(2, 2, 2), devices=jax.devices()[:8],
                  dtype=np.float64, deposition="ngp", budget=1, capacity=48)
        jp.set_particles(parts)
        jtr = jp.make_segment(3).run(0)
        np.testing.assert_array_equal(tr.array.numpy(), np.asarray(jtr.array))
        js = jp.make_sentinel()
        js.observe_segment(jtr.array, jtr.abs_steps)
        want = [r.to_record() for r in js.poll(block=True)]
    ps = b.make_sentinel()
    ps.observe_segment(tr, tr.abs_steps)
    got = [r.to_record() for r in ps.poll(block=True)]
    assert got == want
    assert got[-1]["metrics"]["migration_overflow"] > 0


def test_domain_make_segment_equals_jax():
    """``DistributedDomain.make_segment`` over two quantities on (2,2,2):
    a step exchanging and halving every shard (JAX
    ``tests/test_megastep.py:349``), from seeded padded blocks, 3 steps:
    the trace and every padded shard bitwise JAX's."""
    rng = np.random.default_rng(29)
    dd = DistributedDomain(16, 16, 16, devices=["cpu"] * 8)
    dd.set_mesh_shape((2, 2, 2))
    dd.set_radius(1)
    jd = JDomain(16, 16, 16)
    jd.set_mesh_shape((2, 2, 2))
    jd.set_radius(1)
    for q in ("a", "b"):
        dd.add_data(q, torch.float32)
        jd.add_data(q, np.float32)
    dd.realize()
    jd.realize()
    blocks = {q: [rng.standard_normal((10, 10, 10)).astype(np.float32)
                  for _ in range(8)] for q in ("a", "b")}
    for q, bl in blocks.items():
        for t, v in zip(dd.curr[q], bl):
            t.copy_(torch.from_numpy(v))
        rows = [np.concatenate([np.concatenate(bl[(z * 2 + y) * 2:
                                                  (z * 2 + y) * 2 + 2],
                                               axis=2) for y in range(2)],
                               axis=1) for z in range(2)]
        jd.curr[q] = jax.device_put(np.concatenate(rows, axis=0),
                                    NamedSharding(jd.mesh, P("z", "y", "x")))
    counts, radius = dd.mesh_counts, Radius.constant(1)

    def shard_step(fields):
        dispatch_exchange(fields, radius, counts, Method.Default)
        return {q: [t * 0.5 for t in v] for q, v in fields.items()}

    jcounts = mesh_dim(jd.mesh)

    def j_step(fields):
        from stencil_tpu.geometry import Radius as JRadius
        return {q: j_exchange(p, JRadius.constant(1), jcounts) * 0.5
                for q, p in fields.items()}

    tr = dd.make_segment(shard_step, check_every=3).run(0)
    with reference_block_planner():
        jtr = jd.make_segment(j_step, check_every=3).run(0)
    assert tr.steps == tuple(jtr.steps) == (1, 2, 3)
    np.testing.assert_array_equal(tr.array.numpy(), np.asarray(jtr.array))
    for q in ("a", "b"):
        np.testing.assert_array_equal(dd.interior_to_host(q),
                                      np.asarray(jd.interior_to_host(q)))
    with pytest.raises(RuntimeError, match="realize"):
        DistributedDomain(8, 8, 8, device="cpu").make_segment(shard_step, 2)
