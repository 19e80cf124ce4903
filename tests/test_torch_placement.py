"""The port's placement layer (``stencil_tpu_torch/placement.py``)
against the JAX package's ``stencil_tpu/placement.py``.

``iter_messages`` and ``comm_bytes_matrix`` are compared exactly; every
strategy x mode of ``make_placement`` (with and without a DCN-blocked
axis of two host groups) must give JAX's assignment on the same
partition (JAX on its fake CPU devices, which carry no torus
coordinates, the port on CPU devices, which have none either); and
``Jacobi3D`` run under the QAP order equals JAX's bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.geometry import Dim3 as JDim3, Radius as JRadius
from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.partition import RankPartition as JRankPartition
from stencil_tpu.placement import (PlacementStrategy as JStrategy,
                                   comm_bytes_matrix as j_comm,
                                   iter_messages as j_iter,
                                   make_placement as j_make)
from stencil_tpu.topology import Boundary as JBoundary, Topology as JTopology
from stencil_tpu_torch import Boundary, Dim3, Radius
from stencil_tpu_torch.distributed import DistributedDomain
from stencil_tpu_torch.models.jacobi import Jacobi3D
from stencil_tpu_torch.parallel.mesh import GlobalDevice
from stencil_tpu_torch.partition import RankPartition
from stencil_tpu_torch.placement import (PlacementStrategy,
                                         comm_bytes_matrix, iter_messages,
                                         make_placement,
                                         mesh_distance_matrix)
from stencil_tpu_torch.topology import Topology

jax.config.update("jax_platforms", "cpu")

GRIDS = [((16, 16, 16), (1, 2, 2)), ((16, 12, 20), (2, 2, 2)),
         ((24, 16, 8), (4, 2, 1)), ((15, 16, 17), (2, 1, 3))]
RADII = [(JRadius.constant(1), Radius.constant(1)),
         (JRadius.face_edge_corner(2, 1, 0),
          Radius.face_edge_corner(2, 1, 0))]


def _parts(size, dim):
    return (JRankPartition.from_dim(JDim3(*size), JDim3(*dim)),
            RankPartition.from_dim(Dim3(*size), Dim3(*dim)))


@pytest.mark.parametrize("size,dim", GRIDS)
@pytest.mark.parametrize("ri", [0, 1])
@pytest.mark.parametrize("boundary", ["periodic", "none"])
def test_messages_and_comm_matrix_equal_jax(size, dim, ri, boundary):
    jp, pp = _parts(size, dim)
    jr, pr = RADII[ri]
    jt = JTopology(JDim3(*dim), JBoundary.PERIODIC if boundary ==
                   "periodic" else JBoundary.NONE)
    pt = Topology(Dim3(*dim), Boundary.PERIODIC if boundary == "periodic"
                  else Boundary.NONE)
    want = [(i, j, tuple(d), b) for i, j, d, b in
            j_iter(jp, jr, [4, 8], jt)]
    got = [(i, j, tuple(d), b) for i, j, d, b in
           iter_messages(pp, pr, [4, 8], pt)]
    assert got == want and len(got) > 0
    np.testing.assert_array_equal(comm_bytes_matrix(pp, pr, [4, 8], pt),
                                  j_comm(jp, jr, [4, 8], jt))


STRATEGIES = {"NodeAware": (JStrategy.NodeAware,
                            PlacementStrategy.NodeAware),
              "Trivial": (JStrategy.Trivial, PlacementStrategy.Trivial),
              "IntraNodeRandom": (JStrategy.IntraNodeRandom,
                                  PlacementStrategy.IntraNodeRandom)}


#: every grid with no DCN tier and with each axis that splits over two
#: host groups
PLACEMENT_CASES = [(size, dim, dcn) for size, dim in GRIDS
                   for dcn in (None, 0, 1, 2)
                   if dcn is None or dim[dcn] % 2 == 0]


@pytest.mark.parametrize("size,dim,dcn", PLACEMENT_CASES)
@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("mode", ["auto", "qap", "trivial"])
def test_make_placement_gives_jax_assignment(size, dim, dcn, strategy,
                                             mode):
    n = int(np.prod(dim))
    jp, pp = _parts(size, dim)
    js, ps = STRATEGIES[strategy]
    kw = {} if dcn is None else dict(dcn_axis=dcn, n_slices=2)
    want = j_make(js, jp, jax.devices()[:n], JRadius.constant(1), [4, 8],
                  seed=3, mode=mode, **kw)
    got = make_placement(ps, pp, ["cpu"] * n, Radius.constant(1), [4, 8],
                         seed=3, mode=mode, **kw)
    assert got.assignment == [int(a) for a in want.assignment]
    # get_device / get_idx invert each other on distinct devices
    devs = [GlobalDevice(k, "host", torch.device("cpu")) for k in range(n)]
    pl = make_placement(ps, pp, devs, Radius.constant(1), [4, 8], seed=3,
                        mode=mode, **kw)
    for i in range(n):
        idx = pp.dimensionize(i)
        assert pl.get_idx(pl.get_device(idx)) == idx
        assert pl.slot_order_for_mesh()[i] == pl.get_device(idx)


def test_qap_moves_heavy_traffic_off_the_host_boundary():
    """With z blocked over two hosts, mode='qap' places a (1,1,4) mesh
    so that the QAP objective is no worse than identity — JAX's clamp —
    and the synthetic distances charge the host crossing."""
    dim = Dim3(1, 1, 4)
    pp = RankPartition.from_dim(Dim3(8, 8, 32), dim)
    dist = mesh_distance_matrix(dim, dcn_axis=2, n_slices=2)
    assert dist[0, 3] == 1 + 8 and dist[0, 1] == 1
    pl = make_placement(PlacementStrategy.NodeAware, pp, ["cpu"] * 4,
                        Radius.constant(1), [4], mode="qap", dcn_axis=2,
                        n_slices=2)
    w = comm_bytes_matrix(pp, Radius.constant(1), [4])
    from stencil_tpu_torch import qap
    assert qap.cost(w, dist, pl.assignment) <= \
        qap.cost(w, dist, list(range(4)))


@pytest.mark.parametrize("placement", ["qap", "random"])
def test_jacobi_under_qap_and_random_order_equals_jax(placement):
    strat = {"qap": ("qap", "qap"),
             "random": (JStrategy.IntraNodeRandom,
                        PlacementStrategy.IntraNodeRandom)}[placement]
    jj = JJacobi3D(16, 16, 16, mesh_shape=(2, 2, 1), dtype=np.float32,
                   devices=jax.devices()[:4], kernel="xla",
                   placement=strat[0])
    pj = Jacobi3D(16, 16, 16, mesh_shape=(2, 2, 1), dtype=torch.float32,
                  devices=["cpu"] * 4, kernel="xla", placement=strat[1])
    assert pj.dd.placement.assignment == \
        [int(a) for a in jj.dd.placement.assignment]
    jj.init()
    pj.init()
    jj.run(5)
    pj.run(5)
    np.testing.assert_array_equal(pj.temperature(), jj.temperature())


def test_domain_takes_a_strategy_or_a_mode():
    pd = DistributedDomain(8, 8, 8, devices=["cpu"] * 4)
    pd.set_radius(1)
    pd.add_data("q")
    pd.set_placement(PlacementStrategy.Trivial)
    pd.set_placement("qap")
    assert (pd.strategy, pd.placement_mode) == \
        (PlacementStrategy.Trivial, "qap")
    with pytest.raises(ValueError):
        pd.set_placement("bogus")
    pd.realize()
    assert pd.placement.assignment == [0, 1, 2, 3]
