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
    """``--devices``, ``--device`` and (with ``mesh``) ``--mesh-shape``."""
    if mesh:
        ap.add_argument("--mesh-shape", type=mesh_shape, default=None,
                        metavar="X,Y,Z", help="shards along x, y and z")
    ap.add_argument("--devices", default=None,
                    help="comma list of torch devices, one per mesh "
                         "position (x fastest; repeats allowed)")
    ap.add_argument("--device", default=None,
                    help="one torch device for the whole mesh")


def devices_from_args(args) -> list:
    """The device list the flags name: ``--devices`` verbatim, else
    ``--device`` (or every visible CUDA device) — repeated over the mesh
    when ``--mesh-shape`` asks for more shards than that one device."""
    from ..parallel.mesh import resolve_devices

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
    near-cubic shape over the devices (x-unsharded when ``xfree``, as
    the halo paths want)."""
    from ..parallel.mesh import default_mesh_shape, default_mesh_shape_xfree

    devices = devices_from_args(args)
    shape = getattr(args, "mesh_shape", None)
    if shape is None:
        shape = tuple((default_mesh_shape_xfree if xfree
                       else default_mesh_shape)(len(devices)))
    return devices, tuple(shape)


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
