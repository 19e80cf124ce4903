"""Command-line pieces the port's apps share.

PyTorch-port counterpart of ``apps/_common.py`` of the JAX package
(reference: bin/ — argparse flags, CSV result lines, Statistics): the
device and mesh flags, the dtype flags, the per-method exchange flags
(reference: bin/jacobi3d.cu:107-122), the CSV line, and the one
steps/s measurement contract every app uses.

The device flags take the place of JAX's ``--fake-cpu``: ``--devices``
lists one torch device per mesh position (x fastest; repeats allowed,
so ``cuda:0,cuda:0,cuda:0,cuda:0`` puts four shards on one card and
``cpu,cpu,cpu,cpu`` runs a mesh on the host), ``--device`` names one
device for the whole mesh, and with neither every visible CUDA device is
used (no card: the app raises, it never falls back to the CPU).

Several processes: started under ``python -m torch.distributed.run
--nproc_per_node P``, an app calls ``multihost.initialize_distributed``
(reading torchrun's environment; ``--backend`` names ``nccl`` or
``gloo``), the device flags then name THIS rank's devices (default: its
card, ``cuda:LOCAL_RANK``), the mesh spans every rank's, and rank 0
alone prints the result line. The
DCN flags (``--dcn-axis``, ``--fake-slices``; JAX's ``apps/_common.py:
83-134``) block one grid axis across hosts, or across fake groups of
the devices.

Not in this slice: the observatory ledger record (``--ledger``, JAX's
``emit_bench_artifacts`` schema-1 append) waits for ROADMAP A12; a
non-empty ``--ledger`` raises, and ``--json-out`` writes the JSON alone.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Tuple

KERNEL_CHOICES = ("auto", "wrap", "halo", "xla", "pallas")


def mesh_shape(text: str):
    """``X,Y,Z`` as a tuple of three positive ints (``--mesh-shape``)."""
    parts = [int(v) for v in text.split(",")]
    if len(parts) != 3 or min(parts) < 1:
        raise argparse.ArgumentTypeError("--mesh-shape wants X,Y,Z")
    return tuple(parts)


def add_device_flags(ap: argparse.ArgumentParser, mesh: bool = True) -> None:
    """``--devices``, ``--device``, ``--backend`` and (with ``mesh``)
    ``--mesh-shape``."""
    if mesh:
        ap.add_argument("--mesh-shape", type=mesh_shape, default=None,
                        metavar="X,Y,Z", help="shards along x, y and z")
    ap.add_argument("--devices", default=None,
                    help="comma list of torch devices, one per mesh "
                         "position (x fastest; repeats allowed); under "
                         "torchrun, this rank's")
    ap.add_argument("--device", default=None,
                    help="one torch device for the whole mesh (under "
                         "torchrun, for this rank's shards)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend under torchrun: nccl "
                         "(a card per rank) or gloo (messages staged "
                         "through host memory); default nccl with a card")


def devices_from_args(args) -> list:
    """The device list the flags name: ``--devices`` verbatim, else
    ``--device`` (or every visible CUDA device) — repeated over the mesh
    when ``--mesh-shape`` asks for more shards than that one device. In
    a process group of more than one rank the flags name this rank's
    devices (default: its card) and the list is every rank's
    (``multihost.global_devices``)."""
    from ..parallel.mesh import resolve_devices
    from ..parallel.multihost import global_devices, process_count

    if process_count() > 1:
        local = (args.devices.split(",") if getattr(args, "devices", None)
                 else [args.device] if getattr(args, "device", None)
                 else None)
        return global_devices(local)
    if getattr(args, "devices", None):
        return args.devices.split(",")
    devices = resolve_devices(None, getattr(args, "device", None))
    shape = getattr(args, "mesh_shape", None)
    if shape is not None and len(devices) == 1:
        # every shard of the mesh on the one device
        devices = devices * (shape[0] * shape[1] * shape[2])
    return devices


def mesh_from_args(args, xfree: bool = False) -> Tuple[list, tuple]:
    """(devices, mesh shape): ``--mesh-shape`` or, without it, the
    host-compatible shape when the DCN tier is asked for
    (``dcn_mesh_shape``), else the near-cubic shape over the devices
    (x-unsharded when ``xfree``, as the halo paths want)."""
    from ..parallel.mesh import default_mesh_shape, default_mesh_shape_xfree

    devices = devices_from_args(args)
    shape = getattr(args, "mesh_shape", None)
    if shape is None:
        shape = dcn_mesh_shape(args, devices, xfree)
    if shape is None:
        shape = tuple((default_mesh_shape_xfree if xfree
                       else default_mesh_shape)(len(devices)))
    return devices, tuple(shape)


def add_dcn_flags(ap: argparse.ArgumentParser) -> None:
    """The host tier (the reference's NodePartition level,
    partition.hpp:120-256)."""
    ap.add_argument("--dcn-axis", default=None,
                    choices=("x", "y", "z", "auto"),
                    help="block this grid axis across hosts so that only "
                         "its halo sweep crosses between them ('auto' "
                         "lets the planner choose); omit for one tier")
    ap.add_argument("--fake-slices", type=int, default=0, metavar="S",
                    help="treat the devices as S equal hosts (testing the "
                         "tier on one machine)")


def dcn_from_args(args, devices) -> dict:
    """The ``dcn_axis`` / ``dcn_groups`` model kwargs the DCN flags ask
    for over ``devices`` (``--fake-slices``: S equal consecutive groups
    of them); {} without the tier."""
    axis = getattr(args, "dcn_axis", None)
    fake = getattr(args, "fake_slices", 0)
    if axis is None and not fake:
        return {}
    groups = None
    if fake:
        if len(devices) % fake:
            raise SystemExit(f"{len(devices)} devices not divisible into "
                             f"{fake} fake slices")
        per = len(devices) // fake
        groups = [list(devices[i * per:(i + 1) * per]) for i in range(fake)]
    return {"dcn_axis": axis or "auto", "dcn_groups": groups}


def dcn_mesh_shape(args, devices, xfree: bool):
    """The weak-scaling mesh shape under the DCN tier: its host-blocked
    axis divisible by the host count (JAX ``apps/_common.py:111-134``).
    None without the tier."""
    from ..parallel.mesh import default_mesh_shape_dcn
    from ..parallel.multihost import slice_groups

    kw = dcn_from_args(args, devices)
    if not kw:
        return None
    groups = kw["dcn_groups"] or slice_groups(devices)
    axis = {"x": 0, "y": 1, "z": 2}.get(kw["dcn_axis"], 2)
    if xfree and axis == 0 and len(groups) > 1:
        raise SystemExit("--dcn-axis x shards the lane axis, which the "
                         "halo kernel path cannot use; pick y/z or "
                         "--kernel xla")
    return tuple(default_mesh_shape_dcn(len(devices), len(groups),
                                        axis=axis, xfree=xfree))


def add_dtype_flags(ap: argparse.ArgumentParser) -> None:
    """``--f64`` / ``--bf16`` (the reference's float/double templating
    analog)."""
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--f64", action="store_true")
    g.add_argument("--bf16", action="store_true",
                   help="bfloat16 fields (Astaroth: stored half-width, "
                        "computed in float32; Jacobi: computed in "
                        "bfloat16, rounded after every operation as the "
                        "JAX kernels round; both on their CUDA kernels)")


def dtype_from_args(args):
    import torch

    if getattr(args, "f64", False):
        return torch.float64
    return torch.bfloat16 if getattr(args, "bf16", False) else torch.float32


def add_method_flags(ap: argparse.ArgumentParser) -> None:
    """The analog of the reference's per-method CLI flags (reference:
    bin/jacobi3d.cu:107-122)."""
    ap.add_argument("--slab", action="store_true",
                    help="per-axis slab copy (default)")
    ap.add_argument("--packed", action="store_true",
                    help="packed exchange: one buffer a direction for "
                         "every quantity")
    ap.add_argument("--allgather", action="store_true",
                    help="all-gather exchange: each mesh line's boundary "
                         "slabs gathered onto every device")
    ap.add_argument("--pallas-dma", action="store_true",
                    help="remote-write exchange: each shard's kernel stores "
                         "its slabs into its neighbours' halos")


def methods_from_args(args):
    """The ``Method`` flags the method flags ask for; ``Method.Default``
    when none is given."""
    from ..parallel.methods import Method

    m = Method.NONE
    for flag, method in (("slab", Method.PpermuteSlab),
                         ("packed", Method.PpermutePacked),
                         ("allgather", Method.AllGather),
                         ("pallas_dma", Method.PallasDMA)):
        if getattr(args, flag, False):
            m |= method
    return m if m != Method.NONE else Method.Default


def csv_line(*fields) -> str:
    return ",".join(str(f) for f in fields)


def timed_samples(fn, sync, iters: int, warmup: int = 2):
    """Time ``fn()`` ``iters`` times after ``warmup`` calls, fencing
    with ``sync()``; returns the ``Statistics`` accumulator."""
    from ..numerics import Statistics

    for _ in range(warmup):
        fn()
    sync()
    stats = Statistics()
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        stats.insert(time.perf_counter() - t0)
    return stats


def grouped_steps_per_s(run, block, iters: int, group: int = 1):
    """Whole-loop steps/s: ``run(n)`` advances n steps; ``iters`` is
    rounded to whole ``group``-sized blocks so that configurations of
    different temporal depth compare the same work. One group runs
    first, outside the timed window (the kernels' build and the first
    launches). Returns ``(steps, seconds, steps_per_s)``."""
    g = max(int(group), 1)
    n = max(int(iters), g)
    n -= n % g
    run(g)
    block()
    t0 = time.perf_counter()
    run(n)
    block()
    dt = time.perf_counter() - t0
    return n, dt, n / dt


def sampled_steps_per_s(one, block, samples: int, batch: int,
                        warmup: int = 2):
    """Sampled steps/s: ``one()`` advances ``batch`` steps, timed
    ``samples`` times after ``warmup`` calls. Returns ``(stats,
    steps_per_s)`` with steps/s from the trimean, the figure the CSV
    line prints."""
    stats = timed_samples(one, block, max(int(samples), 1), warmup)
    return stats, batch / stats.trimean()


def add_bench_record_flags(ap: argparse.ArgumentParser) -> None:
    """``--json-out`` and ``--ledger`` (the observatory ledger waits for
    ROADMAP A12)."""
    ap.add_argument("--json-out", default="", metavar="PATH",
                    help="write the measured numbers as a JSON artifact")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="observatory bench ledger (ROADMAP A12: not "
                         "ported; only '' is accepted)")


def refuse_pending(args, pending: List[Tuple[str, str, object]]) -> None:
    """Raise ``NotImplementedError`` for the first option that was given
    but waits for a ROADMAP item: ``pending`` lists (flag, item, value
    that means "not given"). Always checks ``--ledger`` (A12)."""
    checks = list(pending)
    if hasattr(args, "ledger"):
        checks.append(("--ledger", "A12 (observatory ledger)", None))
    for flag, item, unset in checks:
        value = getattr(args, flag.lstrip("-").replace("-", "_"), unset)
        if value != unset and not (flag == "--ledger" and value == ""):
            raise NotImplementedError(
                f"{flag} is not ported yet: it waits for ROADMAP {item}")
