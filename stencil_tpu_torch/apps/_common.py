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

The bench artifacts (``emit_bench_artifacts``, JAX's
``apps/_common.py:260-340``): ``--json-out`` writes the app's JSON and
appends the observatory's schema-1 ledger records made from the same
payload (``observatory/ledger.payload_records``) to ``--ledger``, else
``$STENCIL_BENCH_LEDGER``, else ``~/.cache/stencil_tpu_torch/
ledger.jsonl`` (JAX's default is the checkout's ``bench/ledger.jsonl``;
the port leaves that folder as it is); ``--ledger ''`` (or the
variable set empty) turns the ledger off.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Tuple

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


def add_placement_flags(p: argparse.ArgumentParser) -> None:
    """``--trivial`` / ``--random`` (JAX ``apps/_common.py:138``); the
    default is the node-aware placement."""
    p.add_argument("--trivial", action="store_true",
                   help="trivial placement instead of node-aware")
    p.add_argument("--random", action="store_true",
                   help="random placement (experimental control)")


def placement_from_args(args):
    """The ``PlacementStrategy`` the placement flags name."""
    from ..placement import PlacementStrategy
    if getattr(args, "random", False):
        return PlacementStrategy.IntraNodeRandom
    if getattr(args, "trivial", False):
        return PlacementStrategy.Trivial
    return PlacementStrategy.NodeAware


def add_resilience_flags(ap: argparse.ArgumentParser,
                         ckpt_every: int = 10) -> argparse._ArgumentGroup:
    """The recovery driver's flags shared by the apps (JAX
    ``apps/jacobi3d.py:103-135``, ``apps/pic.py:99-112``); returns the
    group, for an app's own ``--chaos-*`` flags."""
    res = ap.add_argument_group(
        "resilience", "run under the checkpoint-rollback recovery driver "
        "(stencil_tpu_torch/resilience); the --chaos-* flags inject "
        "seeded faults")
    res.add_argument("--resilient", action="store_true",
                     help="run --iters iterations under run_resilient "
                          "instead of the timed loop")
    res.add_argument("--ckpt-dir", default="",
                     help="checkpoint/resume directory (preempted runs "
                          "resume from it on the next invocation)")
    res.add_argument("--ckpt-every", type=int, default=ckpt_every)
    res.add_argument("--check-every", type=int, default=1,
                     help="health-sentinel boundary cadence (steps), and "
                          "the segment length")
    res.add_argument("--max-retries", type=int, default=3)
    res.add_argument("--events-json", default="",
                     help="write the resilience event log (JSON) here")
    res.add_argument("--chaos-nan", type=int, default=0, metavar="STEP",
                     help="inject one NaN into shard 0 after STEP")
    res.add_argument("--chaos-save-fail", type=int, default=0,
                     metavar="STEP", help="the checkpoint save at STEP "
                     "raises transient IOErrors (retried)")
    res.add_argument("--chaos-seed", type=int, default=0)
    return res


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


def megastep_race(make_engine, make_sentinel, fields_fn, k: int,
                  n: int, probe_every: int = 1):
    """The stepwise-against-segments race (JAX ``apps/_common.py:
    213-262``): the stepwise side takes one ``step()`` and one health
    probe per iteration, the fused side one ``make_segment(k,
    probe_every)`` run per ``k`` steps with the probe rows kept on the
    device — the same problem and health coverage. Engines expose
    ``step()``, ``make_segment`` and ``block()``; a warm step and a warm
    segment run outside the timed windows. Returns
    ``(stepwise_steps_per_s, fused_steps_per_s, fused_over_stepwise)``."""
    eng = make_engine()
    sent = make_sentinel(eng)
    eng.step()
    sent.probe(fields_fn(eng), 0)
    sent.poll(block=True)
    eng.block()
    t0 = time.perf_counter()
    for i in range(n):
        eng.step()
        sent.probe(fields_fn(eng), i + 1)
        sent.poll()
    sent.poll(block=True)
    eng.block()
    step_dt = time.perf_counter() - t0

    engf = make_engine()
    fsent = make_sentinel(engf)
    seg = engf.make_segment(k, probe_every=probe_every)
    tr = seg.run(0)
    fsent.observe_segment(tr.array, tr.abs_steps)
    fsent.poll(block=True)
    fsent.reset()
    engf.block()
    t0 = time.perf_counter()
    done = 0
    while done < n:
        tr = seg.run(done)
        done += k
        fsent.observe_segment(tr.array, tr.abs_steps)
        fsent.poll()
    fsent.poll(block=True)
    engf.block()
    fused_dt = time.perf_counter() - t0
    return n / step_dt, n / fused_dt, step_dt / fused_dt


def add_bench_record_flags(ap: argparse.ArgumentParser) -> None:
    """``--json-out`` and ``--ledger``: where a ``--json-out`` run also
    appends its observatory bench records."""
    ap.add_argument("--json-out", default="", metavar="PATH",
                    help="write the measured numbers as a JSON artifact")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="bench trajectory ledger (JSONL) the --json-out "
                         "records are also appended to; default "
                         "$STENCIL_BENCH_LEDGER, else "
                         "~/.cache/stencil_tpu_torch/ledger.jsonl; '' "
                         "(or STENCIL_BENCH_LEDGER='') turns it off")


def resolve_ledger_path(args):
    """The ledger the records land in, or None when turned off: an
    environment variable set empty turns it off as ``--ledger ''``
    does; only an unset one falls through to the default."""
    from ..observatory.ledger import ENV_LEDGER, default_ledger_path

    led = getattr(args, "ledger", None)
    if led is None:
        led = os.environ.get(ENV_LEDGER)
        if led is None:
            led = str(default_ledger_path())
    return led or None


def emit_bench_artifacts(args, payload, source: str):
    """Write the ``--json-out`` artifact and append the ledger records
    made from the same payload (``observatory/ledger.payload_records``,
    provenance ``measured``), with the payload's tiling plan, link-class
    shares and wire layout stamped into each record's config after its
    fingerprint is fixed (JAX ``apps/_common.py:287-340``). Nothing
    without ``--json-out``. Returns the ledger path, or None."""
    import json

    if not getattr(args, "json_out", ""):
        return None
    with open(args.json_out, "w") as f:
        json.dump(payload, f, indent=2)
    ledger = resolve_ledger_path(args)
    if ledger:
        from ..observatory.ledger import append_record, payload_records

        records, skipped = payload_records(payload, source,
                                           provenance="measured",
                                           created=time.time())
        for rec in records:
            if payload.get("tiling_plan"):
                rec["config"].setdefault("tiling_plan",
                                         payload["tiling_plan"])
            if payload.get("link_classes"):
                rec["config"].setdefault(
                    "link_classes",
                    {k: round(v["share"], 6)
                     for k, v in payload["link_classes"].items()})
            if payload.get("wire_layout"):
                rec["config"].setdefault("wire_layout",
                                         payload["wire_layout"])
            append_record(ledger, rec)
        for s in skipped:
            print(f"{source}: ledger skip: {s}", file=sys.stderr)
        print(f"{source}: appended {len(records)} ledger record(s) -> "
              f"{ledger}", file=sys.stderr)
    return ledger
