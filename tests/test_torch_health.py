"""The port's health probe, sentinel, step metrics and segment helpers
against the JAX package's (``stencil_tpu_torch/resilience/health.py``,
``telemetry/probe.py``, ``parallel/megastep.py``).

Inputs are seeded numpy blocks: one padded block per position of a
(2,2,2) mesh, with NaN and +-inf planted in some. JAX reduces them under
``shard_map`` over 8 fake CPU devices, the port over ``["cpu"] * 8``
shard lists. Tolerance: exact — the non-finite count is an integer in
float32 (bitwise), max |finite| a float32 max (bitwise, whatever the
reduction order), the metric columns float32 sums computed the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from stencil_tpu.distributed import DistributedDomain as JDomain
from stencil_tpu.parallel import megastep as jms
from stencil_tpu.parallel.mesh import make_mesh
from stencil_tpu.telemetry.probe import StepMetrics as JStepMetrics
from stencil_tpu_torch.distributed import DistributedDomain
from stencil_tpu_torch.parallel import megastep as ms
from stencil_tpu_torch.resilience import health as ph
from stencil_tpu_torch.telemetry.probe import (STEP_METRIC_NAMES,
                                               StepMetrics, step_metrics_for)
from torch_port_support import reference_block_planner

jax.config.update("jax_platforms", "cpu")

MESH = (2, 2, 2)
PADDED = (6, 5, 7)      # (z, y, x) of one padded block
NAMES = ("a", "b")


def _jax_health():
    """``stencil_tpu.resilience.health``: its package import reads
    ``jax.core.Jaxpr`` (the recovery driver's analysis), hence the
    planner's lending; the module object keeps working afterwards."""
    with reference_block_planner():
        from stencil_tpu.resilience import health
    return health


def _blocks(seed, plant=True, dtype=np.float32):
    """{name: [block per position (x fastest)]}, seeded, with NaN, +inf
    and -inf planted in blocks of ``a`` and one NaN in ``b``."""
    rng = np.random.default_rng(seed)
    out = {}
    for q in NAMES:
        out[q] = [(rng.standard_normal(PADDED) * 10).astype(dtype)
                  for _ in range(8)]
    if plant:
        out["a"][1][0, 0, 0] = np.nan
        out["a"][1][2, 3, 4] = np.inf
        out["a"][5][5, 4, 6] = -np.inf
        out["a"][6][1, 1, 1] = np.nan
        out["b"][7][3, 2, 1] = np.nan
    return out


def _global(blocks):
    """The JAX global array of per-position blocks (x fastest)."""
    mx, my, mz = MESH
    rows = []
    for z in range(mz):
        plane = []
        for y in range(my):
            plane.append(np.concatenate(
                [blocks[(z * my + y) * mx + x] for x in range(mx)], axis=2))
        rows.append(np.concatenate(plane, axis=1))
    return np.concatenate(rows, axis=0)


def _jax_fields(blocks, mesh):
    sh = NamedSharding(mesh, P("z", "y", "x"))
    return {q: jax.device_put(_global(v), sh) for q, v in blocks.items()}


def _port_fields(blocks):
    return {q: [torch.from_numpy(b.copy()) for b in v]
            for q, v in blocks.items()}


def test_segment_helpers_match_jax():
    """``segment_chunks``, ``probe_rel_steps``, ``MAX_UNROLL``, the
    decline vocabulary and ``certificate_gate`` give JAX's outputs."""
    for k in range(1, 12):
        for stride in (1, 2, 3, 8):
            chunks = ms.segment_chunks(k, stride)
            assert chunks == jms.segment_chunks(k, stride)
            for pe in (1, 2, 3, 5):
                assert ms.probe_rel_steps(chunks, pe) == \
                    jms.probe_rel_steps(chunks, pe)
    assert ms.MAX_UNROLL == jms.MAX_UNROLL
    assert ms.DECLINE_REASONS == jms.DECLINE_REASONS
    for name in ("DECLINE_NO_BUILDER", "DECLINE_UNCERTIFIED_SCHEDULE",
                 "DECLINE_INTERIOR_RESIDENT_STATE", "DECLINE_POLICY_DISABLED",
                 "DECLINE_NO_FACTORY", "DECLINE_REBUILD_NO_FACTORY"):
        assert getattr(ms, name) == getattr(jms, name)

    class Cert:
        def __init__(self, safe, reasons=(), replay=4):
            self.replay_safe, self.reasons, self.replay = safe, reasons, replay

    for cert in (None, Cert(True), Cert(False),
                 Cert(False, ["in-flight aliasing", "circular wait"], 3)):
        assert ms.certificate_gate(cert) == jms.certificate_gate(cert)
    d = ms.decline("jacobi", "overlap", "gate said no",
                   code=ms.DECLINE_UNCERTIFIED_SCHEDULE)
    jd = jms.decline("jacobi", "overlap", "gate said no",
                     code=jms.DECLINE_UNCERTIFIED_SCHEDULE)
    assert not d and repr(d) == repr(jd)
    with pytest.raises(ValueError, match="unknown decline code"):
        ms.decline("jacobi", "xla", "typo", code="not-a-real-code")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_probe_shard_and_make_probe_match_jax(dtype):
    """Per-shard vectors (extra columns included) and the whole-mesh
    probe on fields with NaN and +-inf: counts exact, max |finite|
    bitwise in float32."""
    jh = _jax_health()
    blocks = _blocks(7, dtype=dtype)
    for i in (0, 1, 5, 7):
        got = ph.probe_shard(
            {q: torch.from_numpy(blocks[q][i]) for q in NAMES},
            extra={"m": torch.tensor(3.5, dtype=torch.float64),
                   "n": 12.0})
        want = jh.probe_shard({q: jnp.asarray(blocks[q][i]) for q in NAMES},
                              axis_names=(),
                              extra={"m": jnp.asarray(3.5), "n": 12.0})
        assert got.dtype == torch.float32 and got.shape == (2, 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mesh = make_mesh(MESH, jax.devices()[:8])
    want = np.asarray(jh.make_probe(mesh, NAMES)(_jax_fields(blocks, mesh)))
    got = ph.make_probe(None, NAMES)(_port_fields(blocks))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0] == 2 and want[0, 1] == 1   # per-shard max count
    vec = np.asarray([5.0, 1.25e6], np.float32)
    want = np.asarray(jh.make_probe(mesh, NAMES, extra_names=("s", "w"))(
        _jax_fields(blocks, mesh), jnp.asarray(vec)))
    got = ph.make_probe(None, NAMES, extra_names=("s", "w"))(
        _port_fields(blocks), vec)
    np.testing.assert_array_equal(got.numpy(), want)


def _domains(n_names=2):
    # local (x, y, z) = (5, 3, 4): padded blocks of PADDED
    jd = JDomain(10, 6, 8)
    jd.set_mesh_shape(MESH)
    jd.set_radius(1)
    dd = DistributedDomain(10, 6, 8, devices=["cpu"] * 8)
    dd.set_mesh_shape(MESH)
    dd.set_radius(1)
    for q in NAMES[:n_names]:
        jd.add_data(q, np.float32)
        dd.add_data(q, torch.float32)
    jd.realize()
    dd.realize()
    return jd, dd


def test_sentinel_stats_match_jax():
    """A probe sequence through ``HealthSentinel``: clean probes, a
    growth trip (max |a| x 1e7 over the window), a NaN trip, a reset,
    then metrics columns (``StepMetrics``): the same ``HealthStats``
    records, the same first trip, the same ``has_pending``."""
    jh = _jax_health()
    jd, dd = _domains()
    mesh = jd.mesh
    seq = [_blocks(s, plant=False) for s in (1, 2, 3)]
    big = _blocks(4, plant=False)
    big["a"] = [b * 1e7 for b in big["a"]]
    seq += [big, _blocks(5)]
    js, ps = jh.HealthSentinel(jd, window=3), ph.HealthSentinel(dd, window=3)
    for step, blocks in enumerate(seq):
        js.probe(_jax_fields(blocks, mesh), step)
        ps.probe(_port_fields(blocks), step)
    assert ps.has_pending(3) and js.has_pending(3)
    assert not ps.has_pending(9)
    want = [r.to_record() for r in js.poll(block=True)]
    got = [r.to_record() for r in ps.poll(block=True)]
    assert got == want
    assert [r["tripped"] for r in got] == [False] * 3 + [True, True]
    assert ps.tripped.to_record() == js.tripped.to_record()
    assert ps.tripped.step == 3
    ps.reset()
    assert ps.tripped is None and not ps.poll()
    jm, pm = JStepMetrics(jd), StepMetrics(dd)
    js = jh.HealthSentinel(jd, metrics=jm)
    ps = ph.HealthSentinel(dd, metrics=pm)
    for step in (4, 9):
        js.probe(_jax_fields(seq[0], mesh), step)
        ps.probe(_port_fields(seq[0]), step)
    got = [r.to_record() for r in ps.poll(block=True)]
    assert got == [r.to_record() for r in js.poll(block=True)]
    assert got[1]["metrics"] == {"substeps": 9.0,
                                 "wire_bytes": pm.cumulative_bytes(9)}
    with pytest.raises(ValueError, match="not both"):
        ph.HealthSentinel(dd, metrics=pm, probe_fn=lambda f, s: None)


def test_sentinel_names_the_tripped_step_in_a_segment_trace():
    """A NaN planted at the third step of a five-step domain segment
    (JAX ``tests/test_megastep.py:277``): rows 1-2 clean, rows 3-5
    tripped, ``tripped.step`` the planted step; the stats equal JAX's
    sentinel reading a trace of the same rows."""
    jh = _jax_health()
    jd, dd = _domains(1)
    base = _blocks(11, plant=False)
    for i, t in enumerate(dd.curr["a"]):
        t.copy_(torch.from_numpy(base["a"][i]))
    calls = []

    def shard_step(fields):
        calls.append(1)
        if len(calls) == 3:
            fields["a"][2][2, 2, 2] = float("nan")
        return fields

    seg = dd.make_segment(shard_step, check_every=5)
    tr = seg.run(10)
    assert tr.steps == (1, 2, 3, 4, 5) and tr.abs_steps == [11, 12, 13,
                                                            14, 15]
    ps = ph.HealthSentinel(dd)
    ps.observe_segment(tr, tr.abs_steps)
    assert ps.has_pending(13)
    got = ps.poll(block=True)
    assert [r.tripped for r in got] == [False, False, True, True, True]
    assert ps.tripped.step == 13
    # JAX: the same five rows, probed one by one and stacked
    mesh = jd.mesh
    nan = {"a": [b.copy() for b in base["a"]]}
    nan["a"][2][2, 2, 2] = np.nan
    probe = jh.make_probe(mesh, ["a"])
    clean = {"a": base["a"]}
    rows = jnp.stack([probe(_jax_fields(clean if s < 3 else nan, mesh))
                      for s in range(1, 6)])
    np.testing.assert_array_equal(tr.array.numpy(), np.asarray(rows))
    js = jh.HealthSentinel(jd)
    js.observe_segment(rows, [11, 12, 13, 14, 15])
    assert [r.to_record() for r in got] == \
        [r.to_record() for r in js.poll(block=True)]


def test_step_metrics_match_jax():
    """``host_values``, ``cumulative_bytes``, ``rebased`` and ``decode``
    give JAX's figures on the same temporal domain."""
    jd = JDomain(16, 16, 16, devices=jax.devices()[:4])
    jd.set_mesh_shape((1, 2, 2))
    jd.set_radius(1)
    jd.set_exchange_every(2)
    jd.add_data("t", np.float32)
    jd.realize()
    dd = DistributedDomain(16, 16, 16, devices=["cpu"] * 4)
    dd.set_mesh_shape((1, 2, 2))
    dd.set_radius(1)
    dd.set_exchange_every(2)
    dd.add_data("t", torch.float32)
    dd.realize()
    jm, pm = JStepMetrics(jd), StepMetrics(dd)
    assert pm.names == jm.names == STEP_METRIC_NAMES
    assert pm.bytes_per_step == jm.bytes_per_step
    for step in (0, 1, 7, 123456, 2 ** 25 + 1):
        np.testing.assert_array_equal(pm.host_values(step),
                                      jm.host_values(step))
    jr, pr = jm.rebased(jd, 10), pm.rebased(dd, 10)
    for step in (5, 10, 31):
        assert pr.cumulative_bytes(step) == jr.cumulative_bytes(step)
    for got in ({"substeps": 12.0, "wire_bytes": 1e5}, {"substeps": 0.0},
                {}):
        assert pm.decode(got) == jm.decode(got)
    assert isinstance(step_metrics_for(dd), StepMetrics)
    assert step_metrics_for(object()) is None
