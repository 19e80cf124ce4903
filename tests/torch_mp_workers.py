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

#: the segment of ``two_rank_cases`` (halo on (1,2,2))
SEGMENT_STEPS = 5

#: the paths of the remote-write kernels, the overlap exchanges, the
#: all-gather engine and PIC across ranks (two-rank world): (tag, model,
#: constructor settings, placement, steps). Placement "pairs": the mesh
#: positions in rank order (two shards a rank on four positions, four on
#: eight); "board": ``CHECKERBOARD`` on (2,2,2), every neighbour on the
#: other rank. Jacobi 16^3 float32, Astaroth 16^3 float64 at dt 1e-4,
#: PIC float64 NGP on 12^3 and float32 CIC on 8 x 8 x 16.
A4C_CASES = (
    ("jacobi_overlap", "jacobi",
     {"kernel": "halo", "overlap": True, "mesh_shape": (1, 2, 2)}, "pairs", 3),
    ("jacobi_halo_overlap_z", "jacobi",
     {"kernel": "halo", "overlap": True, "mesh_shape": (1, 1, 4)}, "pairs", 3),
    ("jacobi_xla_overlap", "jacobi",
     {"kernel": "xla", "overlap": True, "mesh_shape": (1, 2, 2)}, "pairs", 3),
    ("jacobi_pallas_overlap_dma", "jacobi",
     {"kernel": "pallas", "overlap": True, "methods": Method.PallasDMA,
      "mesh_shape": (1, 2, 2)}, "pairs", 3),
    ("jacobi_temporal_overlap", "jacobi",
     {"kernel": "xla", "overlap": True, "exchange_every": 2,
      "mesh_shape": (2, 2, 2)}, "pairs", 5),
    ("jacobi_xla_dma", "jacobi",
     {"kernel": "xla", "methods": Method.PallasDMA, "mesh_shape": (2, 2, 2)},
     "board", 3),
    ("jacobi_xla_allgather", "jacobi",
     {"kernel": "xla", "methods": Method.AllGather, "mesh_shape": (2, 2, 2)},
     "board", 3),
    ("mhd_halo_overlap", "astaroth",
     {"kernel": "halo", "overlap": True, "mesh_shape": (1, 2, 2)}, "pairs", 1),
    ("mhd_halo_overlap_pair", "astaroth",
     {"kernel": "halo", "overlap": True, "exchange_every": 2,
      "mesh_shape": (1, 2, 2)}, "pairs", 1),
    ("mhd_xla_overlap", "astaroth",
     {"kernel": "xla", "overlap": True, "mesh_shape": (1, 2, 2)}, "pairs", 1),
    ("pic_ngp_f64", "pic",
     {"deposition": "ngp", "dtype": torch.float64, "mesh_shape": (2, 2, 2)},
     "board", 3),
    ("pic_cic_f32", "pic",
     {"deposition": "cic", "dtype": torch.float32, "mesh_shape": (1, 2, 2)},
     "pairs", 3),
)

#: the four-rank world's cases in which every shard is its own rank
A4C_FOUR = (
    ("jacobi_overlap_4", "jacobi",
     {"kernel": "halo", "overlap": True, "mesh_shape": (1, 2, 2)}, "pairs", 3),
    ("pic_ngp_4", "pic",
     {"deposition": "ngp", "dtype": torch.float64, "mesh_shape": (1, 2, 2)},
     "pairs", 3),
)

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


def a4c_model(model: str, kw: dict, devices):
    """A model of an ``A4C_CASES`` entry over ``devices``, initialized."""
    from stencil_tpu_torch.models.astaroth import Astaroth, MhdParams
    from stencil_tpu_torch.models.jacobi import Jacobi3D
    from stencil_tpu_torch.models.pic import Pic

    if model == "jacobi":
        m = Jacobi3D(16, 16, 16, devices=devices, **kw)
        m.init()
    elif model == "astaroth":
        m = Astaroth(16, 16, 16, params=MhdParams(dt=1e-4), devices=devices,
                     dtype=torch.float64, **kw)
        m.init()
    else:
        grid = (12, 12, 12) if kw["deposition"] == "ngp" else (8, 8, 16)
        m = Pic(*grid, 300, devices=devices, seed=11, **kw)
    return m


def a4c_result(model: str, m) -> dict:
    """What a case is held to (collectives: every rank calls it)."""
    if model == "jacobi":
        return {"temp": m.temperature(), "path": np.array(m.kernel_path)}
    if model == "astaroth":
        from stencil_tpu_torch.models.astaroth import FIELDS

        return {**{q: m.field(q) for q in FIELDS},
                **{f"w_{q}": m.accumulator(q) for q in FIELDS},
                "path": np.array(m.kernel_path)}
    got = {f"p_{k}": v for k, v in m.particles_to_host().items()}
    return {"rho": m.rho(), "charge": np.array(m.total_charge()),
            "overflow_total": np.array(m.overflow_total()), **got}


def _a4c(rank: int, out: str, cases, placements) -> None:
    """Run ``cases`` over ``placements[layout]``; rank 0 saves each."""
    for tag, model, kw, layout, steps in cases:
        n = int(np.prod(kw["mesh_shape"]))
        m = a4c_model(model, kw, placements[
            layout if layout == "board" else f"pairs{n}"])
        m.run(steps)
        got = a4c_result(model, m)
        if rank == 0:
            np.savez(os.path.join(out, f"{tag}.npz"), **got)
    # a segment on the overlap path (B7's twin), (1,2,2)
    if "segment" in placements:
        from stencil_tpu_torch.models.jacobi import Jacobi3D

        j = Jacobi3D(16, 16, 16, kernel="halo", overlap=True,
                     mesh_shape=(1, 2, 2), devices=placements["segment"])
        j.init()
        tr = j.make_segment(SEGMENT_STEPS, probe_every=2).run(0)
        temp = j.temperature()
        if rank == 0:
            np.savez(os.path.join(out, "segment_overlap.npz"), temp=temp,
                     trace=tr.array.numpy(), path=np.array(j.kernel_path))


def _save_shards(out: str, tag: str, dd: DistributedDomain) -> None:
    for q, shards in dd.curr.items():
        for i, t in enumerate(shards):
            if t is not None:
                np.save(os.path.join(out, f"{tag}_{q}_{i}.npy"),
                        t.cpu().numpy())


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
    # a segment on the halo path over (1,2,2), two shards a rank: its
    # probe rows reduce across the ranks (one all_reduce a row)
    j = Jacobi3D(16, 16, 16, kernel="halo", mesh_shape=(1, 2, 2),
                 devices=devs2)
    j.init()
    tr = j.make_segment(SEGMENT_STEPS, probe_every=2).run(0)
    temp = j.temperature()
    if rank == 0:
        np.save(os.path.join(out, "segment_halo.npy"), temp)
        np.save(os.path.join(out, "segment_halo_trace.npy"),
                tr.array.numpy())
    _a4c(rank, out, A4C_CASES, {"pairs4": devs2, "pairs8": devs,
                                "board": board, "segment": devs2})
    resilience_cases(rank, out, devs2)
    autotune_case(rank, out, devs2)
    autotune_agreement_case(rank, out, devs2)
    got = {}
    try:
        check_transport("nccl", global_devices(["cpu"]))
        got["nccl_on_cpu"] = "ran"
    except ValueError as e:
        got["nccl_on_cpu"] = str(e)
    if rank == 0:
        with open(os.path.join(out, "refusals.json"), "w") as f:
            json.dump(got, f)


def autotune_case(rank: int, out: str, devs2) -> None:
    """``Method.Auto`` across two ranks: the real timer (its ring shift
    along z crosses the ranks as a message, every candidate's exchange
    too), every rank adopting rank 0's plan; a second domain of the same
    problem reads the cache both ranks see. Each rank writes its plans
    and its ``run(3)`` field."""
    from stencil_tpu_torch.models.jacobi import Jacobi3D
    from stencil_tpu_torch.parallel.methods import Method

    os.environ["STENCIL_TUNE_CACHE"] = os.path.join(out, "plans.json")
    j = Jacobi3D(16, 16, 16, kernel="xla", mesh_shape=(1, 2, 2),
                 devices=devs2, methods=Method.Auto)
    j.init()
    j.run(3)
    k = Jacobi3D(16, 16, 16, kernel="xla", mesh_shape=(1, 2, 2),
                 devices=devs2, methods=Method.Auto)
    temp = j.temperature()
    with open(os.path.join(out, f"autotune_{rank}.json"), "w") as f:
        json.dump({"plan": j.dd.plan.to_record(),
                   "second": k.dd.plan.to_record()}, f)
    if rank == 0:
        np.save(os.path.join(out, "autotune_temp.npy"), temp)


#: each rank's own link in ``autotune_agreement_case``: rank 0's is all
#: latency (the deepest exchange ranks first), rank 1's all bandwidth
#: (depth 1 ranks first), so that each rank's own fit would keep
#: different candidates
AGREEMENT_LINKS = ((1e-3, 1e15), (1e-9, 1e6))


class RecordingTimer:
    """A ``FakeTimer`` that notes the key of every candidate it times."""

    def __init__(self, timer) -> None:
        self._timer = timer
        self.timed = []

    def __getattr__(self, name):
        return getattr(self._timer, name)

    def exchange_round(self, cand, geom):
        self.timed.append(cand.key())
        return self._timer.exchange_round(cand, geom)


def autotune_agreement_case(rank: int, out: str, devs2) -> None:
    """Two ranks whose clocks fit opposite links: both rank with rank
    0's fit, so both time the same candidates (the timings are
    collective exchanges) and adopt one plan. Each rank writes the keys
    it timed and its plan."""
    from stencil_tpu_torch.analysis.costmodel import LinkCoefficients
    from stencil_tpu_torch.tuning import FakeTimer

    alpha, beta = AGREEMENT_LINKS[rank]
    timer = RecordingTimer(FakeTimer(LinkCoefficients(
        alpha_s=alpha, beta_bytes_per_s=beta)))
    dd = DistributedDomain(16, 16, 16, devices=devs2)
    dd.set_mesh_shape((1, 2, 2))
    dd.set_radius(1)
    dd.add_data("q0", torch.float32)
    plan = dd.autotune(timer=timer, use_cache=False, max_measurements=2)
    with open(os.path.join(out, f"agreement_{rank}.json"), "w") as f:
        json.dump({"timed": timer.timed, "plan": plan.to_record()}, f)


#: the resilient campaign across ranks: Jacobi halo on (1,2,2) (two
#: shards a rank), a NaN at step 3 and a preemption at step 6 of 10,
#: checkpoints every 2 steps; then a resume to the end
RESILIENT_STEPS = 10


def resilient_campaign(devices, ckpt_dir: str):
    """The campaign of ``resilience_cases`` on ``devices`` (one process
    or a rank's share): the preempted run's report, then the resumed
    one's and the final field."""
    from stencil_tpu_torch.models.jacobi import Jacobi3D
    from stencil_tpu_torch.resilience import (FaultPlan, NaNInjection,
                                              Preemption, ResiliencePolicy)

    def model():
        j = Jacobi3D(16, 16, 16, kernel="halo", mesh_shape=(1, 2, 2),
                     devices=devices)
        j.init()
        return j

    pol = ResiliencePolicy(check_every=1, ckpt_every=2, base_delay=0.0,
                           sleep=lambda s: None)
    j = model()
    first = j.run_resilient(RESILIENT_STEPS, policy=pol, ckpt_dir=ckpt_dir,
                            faults=FaultPlan(nans=[NaNInjection(step=3)],
                                             preemptions=[
                                                 Preemption(step=6)]))
    k = model()
    second = k.run_resilient(RESILIENT_STEPS, policy=pol, ckpt_dir=ckpt_dir)
    # the observatory's perf_* events follow each rank's own clock
    def kinds(rep):
        return [(e["event"], e.get("step")) for e in rep.events
                if not e["event"].startswith("perf_")]

    return kinds(first), kinds(second), k.temperature()


def resilience_cases(rank: int, out: str, devs2) -> None:
    """C1 and A11 across two ranks: ``Pic.total_charge`` (CIC float32,
    16^3, 16,384 particles, seed 7, one step) on every rank; the
    resilient campaign with a NaN and a preemption; and a checkpoint
    corrupted on rank 1 alone, which walks both ranks back."""
    from stencil_tpu_torch.models.pic import Pic
    from stencil_tpu_torch.parallel.multihost import all_gather_objects
    from stencil_tpu_torch.resilience import CheckpointCorruption
    from stencil_tpu_torch.utils import checkpoint as ck

    p = Pic(16, 16, 16, 16384, mesh_shape=(1, 2, 2), devices=devs2,
            dtype=torch.float32, deposition="cic", seed=7)
    p.step()
    charges = all_gather_objects(p.total_charge())
    first, second, temp = resilient_campaign(
        devs2, os.path.join(out, "resilient_ckpt"))
    # corrupt step 4 on rank 1's shards only: both ranks restore step 2
    dd = DistributedDomain(16, 16, 16, devices=devs2)
    dd.set_radius(1)
    dd.set_mesh_shape((1, 2, 2))
    dd.add_data("q")
    dd.realize()
    d = os.path.join(out, "corrupt_ckpt")
    for step in (2, 4):
        dd.set_interior("q", seeded_interior((16, 16, 16), step))
        ck.save_domain(dd, d, step)
    if rank == 1:
        CheckpointCorruption(step=4, mode="bitflip").fire(
            d, 4, np.random.default_rng(0), lambda *a, **k: None,
            positions=dd.mesh.local_positions)
    dd.set_interior("q", seeded_interior((16, 16, 16), 9))
    step, _ = ck.restore_domain(dd, d)
    steps = all_gather_objects(step)
    restored = dd.interior_to_host("q")
    if rank == 0:
        with open(os.path.join(out, "resilience.json"), "w") as f:
            json.dump({"charges": charges, "first": first,
                       "second": second, "corrupt_steps": steps}, f)
        np.save(os.path.join(out, "resilient_temp.npy"), temp)
        np.save(os.path.join(out, "corrupt_restored.npy"), restored)


def four_rank_jacobi(rank: int, out: str) -> None:
    """The ``A4C_FOUR`` cases, one shard a rank, then the
    ``JACOBI_CASES``, two shards on each of four ranks: ``halo`` over
    (1,2,4) at exchange_every 1 (B5) and 2 (B6), ``pallas`` (K3) and
    ``xla-temporal[s=2]`` over (2,2,2); 5 steps each."""
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    torch.set_num_threads(1)
    _a4c(rank, out, A4C_FOUR, {"pairs4": global_devices(["cpu"])})
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
