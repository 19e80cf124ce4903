"""The port's MHD model with ``boundary=Boundary.NONE`` (a zero-Dirichlet
exterior) against the JAX package's, on the CPU.

The three paths that take it — ``xla``, ``xla-overlap`` and
``xla-temporal[s=3]`` — on four 16 x 16 x 32 shards of a (1,2,2) mesh
(the port's on ``devices=["cpu"] * 4``, JAX's on four fake CPU devices),
from ``init()``, ``run(2)``; each JAX model is built once per module.
Compared: the 8 fields, the 8 accumulators ``w`` (ring stripped on the
temporal path) and ``exchange_stats()``; the port's temporal path also
against its stepwise ``xla`` path. The kernel paths refuse the boundary
as JAX's do (tests/test_torch_astaroth.py).

Tolerance (``torch_port_support.assert_mhd_fields_match``): float32 per
field ``max |port - jax| <= 64 * eps(f32) * max |jax|``.
"""

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.models import astaroth as jm
from stencil_tpu.topology import Boundary as JBoundary
from stencil_tpu_torch import Boundary
from stencil_tpu_torch.models import astaroth as pm
from torch_port_support import (assert_mhd_fields_match, jax_astaroth_w,
                                reference_block_planner)

jax.config.update("jax_platforms", "cpu")

DT = 1e-4
MESH = (1, 2, 2)
SIZE = (32, 32, 32)
# id: (exchange_every, overlap)
PATHS = {"xla": (None, False), "xla-overlap": (None, True),
         "xla-temporal[s=3]": (3, False)}


def _port(s, overlap):
    return pm.Astaroth(*SIZE, params=pm.MhdParams(dt=DT), mesh_shape=MESH,
                       dtype=torch.float32, devices=["cpu"] * 4,
                       kernel="xla", exchange_every=s, overlap=overlap,
                       boundary=Boundary.NONE)


@pytest.fixture(scope="module", params=list(PATHS))
def runs(request):
    s, overlap = PATHS[request.param]
    j = jm.Astaroth(*SIZE, params=jm.MhdParams(dt=DT), mesh_shape=MESH,
                    dtype=np.float32, devices=jax.devices()[:4],
                    kernel="xla", exchange_every=s, overlap=overlap,
                    boundary=JBoundary.NONE)
    p = _port(s, overlap)
    j.init()
    p.init()
    j.run(2)
    p.run(2)
    with reference_block_planner():
        stats = (j.exchange_stats(), p.exchange_stats())
    return dict(path=request.param, paths=(j.kernel_path, p.kernel_path),
                jax=({q: j.field(q) for q in jm.FIELDS}, jax_astaroth_w(j)),
                port=({q: p.field(q) for q in pm.FIELDS},
                      {q: p.accumulator(q) for q in pm.FIELDS}),
                stats=stats)


def test_path_is_jax_s(runs):
    assert runs["paths"] == (runs["path"], runs["path"])


def test_fields_and_w_match_jax(runs):
    (jf, jw), (pf, pw) = runs["jax"], runs["port"]
    assert_mhd_fields_match(pf, jf, np.float32)
    assert_mhd_fields_match(pw, jw, np.float32)
    for q in pm.FIELDS:
        assert np.isfinite(pf[q]).all()


def test_exchange_stats_match_jax(runs):
    assert runs["stats"][1] == runs["stats"][0]


def test_temporal_path_matches_the_stepwise_path():
    """``xla-temporal[s=3]`` against stepwise ``xla``, both the port's,
    with the zero exterior: the ring cells outside the domain are zeroed
    after each substep, as the stepwise exchange delivers them. Within
    ``substeps * 64 * eps(f32) * max`` (the paths group the same
    operations alike; the bound is the MHD paths')."""
    got = []
    for s in (3, None):
        m = _port(s, False)
        m.init()
        m.run(2)
        got.append({q: m.field(q) for q in pm.FIELDS})
    for q in pm.FIELDS:
        err = np.abs(got[0][q] - got[1][q]).max()
        assert err <= 6 * 64 * np.finfo(np.float32).eps * \
            np.abs(got[1][q]).max(), (q, err)
