"""The port's Astaroth segments (``Astaroth.make_segment``, with
``parallel/megastep.py``) against its own stepwise runs and against the
JAX package's.

``xla`` carries the ``(fields, w)`` pair one iteration a chunk;
``xla-temporal[s=2]`` one ``lcm(3, 2)``-substep period (two iterations)
a chunk, groups straddling the iteration boundary and shipping ``w``
where they start at alpha != 0, then a tail iteration. Both models start
from ``init()`` (the reference's hash init, the same in both packages)
in float64; JAX over its fake CPU devices, the port over ``["cpu"] * n``
shards. JAX's side runs the segment's chunks through its ``run`` and
probes after each (its own tests hold its segments to that, and its
unrolled MHD segment takes 35 s to compile here); the interior-resident
kernel paths decline with JAX's code.

Tolerances: the segment against the port's ``run(k)``, bitwise (fields,
``w`` and the trace of probe rows against the stepwise probes); against
JAX, the MHD comparisons' float64 tolerance ``rtol=1e-11, atol=1e-13``
(``torch_port_support.assert_mhd_fields_match``: jax's CPU compiler
contracts ``a*b+c`` into FMAs), the trace's non-finite counts exact and
its max |finite| within the same rtol.
"""

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.models.astaroth import Astaroth as JAstaroth
from stencil_tpu.parallel.methods import Method as JMethod
from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth
from stencil_tpu_torch.parallel.megastep import (
    DECLINE_INTERIOR_RESIDENT_STATE, SegmentDecline)
from stencil_tpu_torch.parallel.methods import Method
from stencil_tpu_torch.resilience.health import HealthSentinel
from torch_port_support import (assert_mhd_fields_match, jax_astaroth_w,
                                reference_block_planner)

jax.config.update("jax_platforms", "cpu")

#: case: size (x, y, z), mesh, exchange_every, segment length, path
CASES = {
    "xla": ((8, 8, 8), (2, 2, 2), None, 2, "xla", (1, 2)),
    "temporal-s2": ((8, 8, 16), (1, 1, 2), 2, 3, "xla-temporal[s=2]",
                    (2, 3)),
}


def _port(size, mesh, s):
    n = mesh[0] * mesh[1] * mesh[2]
    m = Astaroth(*size, mesh_shape=mesh, devices=["cpu"] * n,
                 dtype=torch.float64, kernel="xla",
                 methods=Method.PpermuteSlab, exchange_every=s)
    m.init()
    return m


@pytest.mark.parametrize("case", sorted(CASES))
def test_astaroth_segment_equals_run_and_jax(case):
    size, mesh, s, k, path, probes = CASES[case]
    a, b = _port(size, mesh, s), _port(size, mesh, s)
    assert b.kernel_path == path
    sent = HealthSentinel(a.dd)
    for prev, p in zip((0,) + probes, probes):
        a.run(p - prev)
        sent.probe(a.dd.curr, p)
    seg = b.make_segment(k)
    assert seg.steps == k and seg.probe_steps == probes
    tr = seg.run(0)
    for q in FIELDS:
        np.testing.assert_array_equal(b.field(q), a.field(q), err_msg=q)
        np.testing.assert_array_equal(b.accumulator(q), a.accumulator(q),
                                      err_msg=q)
    # the trace rows are the stepwise probes of the same steps
    rows = {r.step: r for r in sent.poll(block=True)}
    bs = HealthSentinel(b.dd)
    bs.observe_segment(tr, tr.abs_steps)
    for r in bs.poll(block=True):
        assert r.to_record() == rows[r.step].to_record()
    # JAX from the same init(), the same chunks, a probe after each
    n = mesh[0] * mesh[1] * mesh[2]
    with reference_block_planner():
        from stencil_tpu.resilience.health import make_probe

        jm = JAstaroth(*size, mesh_shape=mesh, devices=jax.devices()[:n],
                       dtype=np.float64, kernel="xla",
                       methods=JMethod.PpermuteSlab, exchange_every=s)
        jm.init()
        probe = make_probe(jm.dd.mesh, FIELDS)
        want = []
        for prev, p in zip((0,) + probes, probes):
            jm.run(p - prev)
            want.append(np.asarray(probe(jm.dd.curr)))
        want = np.stack(want)
        jf = {q: jm.field(q) for q in FIELDS}
        jw = jax_astaroth_w(jm)
    got = tr.array.numpy()
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-11)
    assert_mhd_fields_match({q: b.field(q) for q in FIELDS}, jf, np.float64)
    assert_mhd_fields_match({q: b.accumulator(q) for q in FIELDS}, jw,
                            np.float64)


@pytest.mark.parametrize("kernel,overlap,mesh,size,path", [
    ("wrap", False, (1, 1, 1), (16, 16, 16), "wrap"),
    ("halo", False, (1, 2, 2), (16, 16, 16), "halo"),
    ("halo", True, (1, 2, 2), (16, 16, 32), "halo-overlap"),
])
def test_interior_resident_paths_decline_as_jax(kernel, overlap, mesh, size,
                                                path):
    """``wrap``, ``halo`` and ``halo-overlap`` keep their state in
    ``_inner``: a falsy ``SegmentDecline`` with JAX's model, path and
    code."""
    n = mesh[0] * mesh[1] * mesh[2]
    m = Astaroth(*size, mesh_shape=mesh, devices=["cpu"] * n,
                 kernel=kernel, overlap=overlap)
    assert m.kernel_path == path
    d = m.make_segment(2)
    assert isinstance(d, SegmentDecline) and not d
    assert d.code == DECLINE_INTERIOR_RESIDENT_STATE
    with reference_block_planner():
        jm = JAstaroth(*size, mesh_shape=mesh, devices=jax.devices()[:n],
                       dtype=np.float32, kernel=kernel, overlap=overlap)
        jd = jm.make_segment(2)
    assert (d.model, d.path, d.code) == (jd.model, jd.path, jd.code)
