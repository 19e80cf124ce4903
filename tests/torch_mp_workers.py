"""Rank functions for the tests that run stencil_tpu_torch across
processes (tests/test_torch_multiprocess.py, tests/test_torch_gpu.py).

Each runs in a process that ``multihost.spawn_ranks`` starts, as one
rank of a process group, and writes what it computed under ``out`` for
the test to compare: rank 0 the global arrays the collectives return,
every rank its own padded shards. This module imports no JAX, so a rank
starts in about a second.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from stencil_tpu_torch import Boundary, Radius
from stencil_tpu_torch.distributed import DistributedDomain
from stencil_tpu_torch.parallel.methods import Method
from stencil_tpu_torch.parallel.multihost import check_transport, global_devices

#: the exchange cases: (name, grid (x, y, z), radius, domain settings)
EXCHANGE_CASES = (
    ("uneven", (17, 14, 13), 2, {}),
    ("none", (16, 12, 10), 1, {"boundary": Boundary.NONE}),
    ("bf16_irredundant", (16, 12, 10), 1,
     {"wire_format": "bf16", "wire_layout": "irredundant"}),
    ("packed", (14, 12, 10), 1,
     {"methods": Method.PpermutePacked, "wire_format": "bf16"}),
)

#: the Astaroth cases of the two-rank world: (tag, kernel, exchange_every)
MHD_CASES = (("mhd_halo", "halo", None), ("mhd_halo_pair", "halo", 2),
             ("mhd_xla", "xla", None))

#: the Jacobi cases of the four-rank world: (tag, kernel, mesh,
#: exchange_every)
JACOBI_CASES = (("halo_s1", "halo", (1, 2, 4), 1),
                ("halo_s2", "halo", (1, 2, 4), 2),
                ("pallas", "pallas", (2, 2, 2), None),
                ("xla_temporal", "xla", (2, 2, 2), 2))

#: the checkerboard placement of a (2,2,2) mesh on two ranks: every
#: neighbour along every axis lies on the other rank
CHECKERBOARD = [(x + y + z) % 2 for z in range(2) for y in range(2)
                for x in range(2)]


def seeded_interior(size_xyz, seed: int, dtype=np.float32) -> np.ndarray:
    x, y, z = size_xyz
    return np.random.default_rng(seed).standard_normal((z, y, x)).astype(
        dtype)


def exchange_domain(name: str, devices) -> DistributedDomain:
    """The realized domain of exchange case ``name`` over ``devices``
    (eight, on the (2,2,2) mesh), seeded and exchanged once."""
    _, size, r, kw = next(c for c in EXCHANGE_CASES if c[0] == name)
    dd = DistributedDomain(*size, devices=devices)
    dd.set_radius(Radius.constant(r))
    dd.set_mesh_shape((2, 2, 2))
    if "boundary" in kw:
        dd.set_boundary(kw["boundary"])
    if "methods" in kw:
        dd.set_methods(kw["methods"])
    if "wire_format" in kw:
        dd.set_wire_format(kw["wire_format"])
    if "wire_layout" in kw:
        dd.set_wire_layout(kw["wire_layout"])
    dd.add_data("a", torch.float32)
    if name == "packed":
        dd.add_data("b", torch.float64)
    dd.realize()
    for k, q in enumerate(dd._names):
        dd.set_interior(q, torch.from_numpy(seeded_interior(
            size, 7 + k, np.float64 if q == "b" else np.float32)))
    dd.exchange()
    return dd


def _save_shards(out: str, tag: str, dd: DistributedDomain) -> None:
    for q, shards in dd.curr.items():
        for i, t in enumerate(shards):
            if t is not None:
                np.save(os.path.join(out, f"{tag}_{q}_{i}.npy"),
                        t.cpu().numpy())


def _refusals(devs) -> dict:
    """Which A4c paths raise ``NotImplementedError`` naming the item on
    a mesh over ``devs`` (four positions, two ranks)."""
    from stencil_tpu_torch.models.astaroth import Astaroth
    from stencil_tpu_torch.models.jacobi import Jacobi3D
    from stencil_tpu_torch.models.pic import Pic

    cases = {
        "jacobi_overlap": lambda: Jacobi3D(
            16, 16, 16, kernel="xla", overlap=True, mesh_shape=(1, 2, 2),
            devices=devs),
        "jacobi_halo_overlap": lambda: Jacobi3D(
            16, 16, 16, kernel="halo", overlap=True, mesh_shape=(1, 2, 2),
            devices=devs),
        "jacobi_pallas_dma": lambda: Jacobi3D(
            16, 16, 16, kernel="xla", methods=Method.PallasDMA,
            mesh_shape=(1, 2, 2), devices=devs),
        "allgather": lambda: _exchange_with(devs, Method.AllGather),
        "astaroth_halo_overlap": lambda: Astaroth(
            16, 16, 16, kernel="halo", overlap=True, mesh_shape=(1, 2, 2),
            devices=devs),
        "pic": lambda: Pic(8, 8, 8, 16, mesh_shape=(1, 2, 2), devices=devs,
                           dtype=torch.float64, init=False),
    }
    got = {}
    for name, make in cases.items():
        try:
            make()
            got[name] = "ran"
        except NotImplementedError as e:
            got[name] = "A4c" if "A4c" in str(e) else f"other: {e}"
    return got


def _exchange_with(devs, method) -> None:
    dd = DistributedDomain(8, 8, 8, devices=devs)
    dd.set_radius(1)
    dd.set_mesh_shape((1, 2, 2))
    dd.set_methods(method)
    dd.add_data("q", torch.float32)
    dd.realize()
    dd.exchange()


def two_rank_cases(rank: int, out: str) -> None:
    """The cases of a world of two ranks of four CPU shards each."""
    from stencil_tpu_torch.models.astaroth import Astaroth
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    torch.set_num_threads(1)
    devs = global_devices(["cpu"] * 4)
    # Jacobi3D xla over (2,2,2) with z blocked across the two "hosts"
    by_rank = [[g for g in devs if g.rank == r] for r in range(2)]
    j = Jacobi3D(16, 16, 16, kernel="xla", mesh_shape=(2, 2, 2),
                 devices=devs, dcn_axis="z", dcn_groups=by_rank)
    j.init()
    j.run(2)
    temp = j.temperature()
    if rank == 0:
        np.save(os.path.join(out, "jacobi_dcn.npy"), temp)
        np.save(os.path.join(out, "jacobi_dcn_ranks.npy"),
                np.array(j.dd.mesh.ranks))
    # one exchange of each case, on the checkerboard placement
    left = [iter(by_rank[0]), iter(by_rank[1])]
    board = [next(left[r]) for r in CHECKERBOARD]
    for name, *_ in EXCHANGE_CASES:
        _save_shards(out, name, exchange_domain(name, board))
    # Astaroth halo with and without the substep pair on (1,2,2), two
    # shards a rank (x is one shard: its wraps are local)
    devs2 = global_devices(["cpu"] * 2)
    for tag, kernel, every in MHD_CASES:
        m = Astaroth(16, 16, 16, kernel=kernel, mesh_shape=(1, 2, 2),
                     devices=devs2, exchange_every=every,
                     dtype=torch.float64)
        m.init()
        m.run(1)
        fields = {q: m.field(q) for q in ("lnrho", "uux", "ax", "ss")}
        if rank == 0:
            np.savez(os.path.join(out, f"{tag}.npz"), **fields)
    got = _refusals(devs2)
    try:
        check_transport("nccl", global_devices(["cpu"]))
        got["nccl_on_cpu"] = "ran"
    except ValueError as e:
        got["nccl_on_cpu"] = str(e)
    if rank == 0:
        with open(os.path.join(out, "refusals.json"), "w") as f:
            json.dump(got, f)


def four_rank_jacobi(rank: int, out: str) -> None:
    """The ``JACOBI_CASES``, two shards on each of four ranks: ``halo``
    over (1,2,4) at exchange_every 1 (B5) and 2 (B6), ``pallas`` (K3)
    and ``xla-temporal[s=2]`` over (2,2,2); 5 steps each."""
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    torch.set_num_threads(1)
    devs = global_devices(["cpu"] * 2)
    for tag, kernel, mesh, every in JACOBI_CASES:
        j = Jacobi3D(16, 16, 16, kernel=kernel, mesh_shape=mesh,
                     devices=devs, exchange_every=every)
        j.init()
        j.run(5)
        temp = j.temperature()
        if rank == 0:
            np.save(os.path.join(out, f"{tag}.npy"), temp)
            with open(os.path.join(out, f"{tag}.path"), "w") as f:
                f.write(j.kernel_path)


def card_paths(rank: int, out: str, cards, cases) -> None:
    """One rank of the card tests: two shards of (1,2,2) on card
    ``cards[rank]``; for each case ``(model, kernel, steps)`` rank 0
    saves the gathered result."""
    from stencil_tpu_torch.models.astaroth import Astaroth
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    devs = global_devices([cards[rank]] * 2)
    for model, kernel, steps in cases:
        if model == "jacobi":
            m = Jacobi3D(128, 128, 128, kernel=kernel, mesh_shape=(1, 2, 2),
                         devices=devs)
        else:
            m = Astaroth(32, 64, 64, kernel=kernel, mesh_shape=(1, 2, 2),
                         devices=devs, exchange_every=2 if "pair" in model
                         else None)
        m.init()
        m.run(steps)
        got = ({"temp": m.temperature()} if model == "jacobi"
               else {q: m.field(q) for q in ("lnrho", "uux", "ax", "ss")})
        if rank == 0:
            np.savez(os.path.join(out, f"{model}_{kernel}.npz"), **got)
