"""Jacobi-3D heat demo over a mesh of shards.

PyTorch-port counterpart of ``apps/jacobi3d.py`` (reference:
bin/jacobi3d.cu): build the solver, time ``--iters`` iterations in
samples of ``--batch`` (two warm-up samples first; each sample ends in a
device synchronize), and print the reference's CSV result line

    bin,methods,devices,x,y,z,bytes_x,bytes_y,bytes_z,min (s),trimean (s),path,bytes/iter,exchange (s)

with per-iteration seconds. ``--x/--y/--z`` are the size of one shard:
the global grid is that times the mesh (weak scaling, as the reference
and the JAX app do), and the line prints the global size. Run it as

    python -m stencil_tpu_torch.apps.jacobi3d --x 512 --y 512 --z 512
    python -m stencil_tpu_torch.apps.jacobi3d --x 512 --y 256 --z 256 \\
        --kernel halo --mesh-shape 1,2,2 --devices cuda:0,cuda:0,cuda:0,cuda:0

The mesh runs on every visible CUDA device unless ``--devices`` lists
one device per mesh position (repeats allowed: shards sharing a card)
or ``--device`` names one (``--device cpu`` runs the plain PyTorch
twins). With no ``--mesh-shape``, the ``halo`` and ``auto`` kernels take
an x-unsharded mesh and the others a near-cubic one. The method flags
(``--slab``, ``--packed``, ``--allgather``, ``--pallas-dma``; JAX's
``apps/_common.py``) choose the exchange of the padded paths
(``--pallas-dma``: the remote-write kernel B4); the ``methods`` column
prints the one that ran. ``--exchange-every S`` is the temporal depth
(``Jacobi3D(exchange_every=S)``): N of the N-step kernels on ``wrap``
and ``halo``, one deep exchange per S steps on the padded paths
(``xla-temporal[s=S]``); ``--wrap-steps N`` sets STENCIL_WRAP_STEPS,
which an explicit ``--exchange-every`` overrides. ``--bf16`` runs a
bfloat16 field on the kernels' bfloat16 instances (up to 16 steps a
group, bfloat16's sublane tile), ``--f64`` a float64 one on the plain
paths, as JAX's ``--bf16`` / ``--f64`` do. ``--overlap`` hides the
exchange behind the interior (``Jacobi3D(overlap=True)``): B7 on the
``halo`` and ``auto`` kernels, the inner block queued between the
exchange's start and its landing on ``xla`` and ``pallas``.

One rank per card (``--backend nccl``, the default with a card), or
several ranks on one card (``--backend gloo``, messages staged through
host memory):

    python -m torch.distributed.run --nproc_per_node 2 \
        -m stencil_tpu_torch.apps.jacobi3d --x 512 --y 256 --z 256 \
        --kernel halo --mesh-shape 1,2,2 --devices cuda:0,cuda:0 \
        --backend gloo

Each rank's ``--devices`` are its own; rank 0 prints the line. Every
path runs across ranks: ``--overlap`` (B7) and ``--pallas-dma`` (B4)
store into the other ranks' shards over CUDA IPC, ordered by
device-side flags, with no message through the group:

    python -m torch.distributed.run --nproc_per_node 2 \
        -m stencil_tpu_torch.apps.jacobi3d --x 512 --y 256 --z 256 \
        --kernel halo --overlap --mesh-shape 1,2,2 \
        --devices cuda:0,cuda:0 --backend gloo

``--dcn-axis`` / ``--fake-slices`` block one grid axis across hosts (or
fake groups of the devices), as JAX's flags do.

Placement and output (JAX's flags): ``--trivial`` / ``--random`` choose
the placement strategy (node-aware by default), ``--prefix P`` writes
the plan file ``Pplan.txt`` and ``Pcomm_matrix.txt`` at realize, and
``--paraview`` dumps ParaView CSVs (``Pjacobi3d_init<i>.txt``, every
``--period`` samples ``Pjacobi3d_<n><i>.txt``, and
``Pjacobi3d_final<i>.txt``).

``--json-out`` writes the timed run's bench record (JAX's payload:
steps/s, the per-step times and the byte model; on a kernel path also
``tiling_plan``, the launch the port's planners choose for the shard,
``tuning/plan.tiling_record``) and appends it to the observatory's
ledger (``--ledger``, ``_common.emit_bench_artifacts``).

``--resilient`` runs ``--iters`` iterations under the checkpoint-rollback
driver (``Jacobi3D.run_resilient``) instead of the timed loop: health
probes every ``--check-every`` steps (the segment length), checkpoints
every ``--ckpt-every`` into ``--ckpt-dir`` (a preempted run resumes from
it), seeded faults from ``--chaos-nan``, ``--chaos-halo``,
``--chaos-save-fail`` and ``--chaos-preempt``, the event log into
``--events-json``; it prints JAX's line
``jacobi3d-resilient,methods,steps,rollbacks,save_retries,degradations,
preempted,final_config``:

    python -m stencil_tpu_torch.apps.jacobi3d --x 512 --y 512 --z 512 \
        --resilient --iters 40 --check-every 10 --ckpt-every 20 \
        --chaos-nan 25 --ckpt-dir /tmp/j3d_ckpt
"""

from __future__ import annotations

import argparse
import os

from ..parallel.multihost import initialize_distributed
from ._common import (KERNEL_CHOICES, add_bench_record_flags, add_dcn_flags,
                      add_device_flags, add_dtype_flags, add_method_flags,
                      add_placement_flags, add_resilience_flags, csv_line,
                      dcn_from_args, dtype_from_args, emit_bench_artifacts,
                      mesh_from_args, methods_from_args,
                      placement_from_args, sampled_steps_per_s)


def _run_resilient(j, args, rank: int) -> None:
    """The chaos entry (JAX ``apps/jacobi3d.py:24``): the recovery
    driver with the seeded faults of the ``--chaos-*`` flags, then a
    summary line and, optionally, the event-log JSON."""
    from ..resilience import (FaultPlan, HaloCorruption, NaNInjection,
                              Preemption, ResiliencePolicy,
                              TransientSaveFailure)

    plan = FaultPlan(seed=args.chaos_seed)
    if args.chaos_nan:
        plan.nans.append(NaNInjection(step=args.chaos_nan))
    if args.chaos_halo:
        plan.halos.append(HaloCorruption(step=args.chaos_halo))
    if args.chaos_save_fail:
        plan.save_failures.append(
            TransientSaveFailure(step=args.chaos_save_fail))
    if args.chaos_preempt:
        plan.preemptions.append(Preemption(step=args.chaos_preempt))
    policy = ResiliencePolicy(check_every=args.check_every,
                              ckpt_every=args.ckpt_every,
                              max_retries=args.max_retries,
                              base_delay=0.01,
                              fuse_segments=args.fuse_segments)
    report = j.run_resilient(args.iters, policy=policy,
                             ckpt_dir=args.ckpt_dir or None, faults=plan)
    if rank != 0:
        return
    if args.events_json:
        report.write(args.events_json)
    print(csv_line("jacobi3d-resilient", methods_from_args(args),
                   report.steps, report.rollbacks, report.save_retries,
                   len(report.degradations), int(report.preempted),
                   report.final_config))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--x", type=int, default=128, help="shard x size")
    ap.add_argument("--y", type=int, default=128)
    ap.add_argument("--z", type=int, default=128)
    ap.add_argument("--iters", "-n", type=int, default=30)
    ap.add_argument("--batch", type=int, default=10,
                    help="iterations per timing sample")
    ap.add_argument("--kernel", default="auto", choices=KERNEL_CHOICES,
                    help="compute path: wrap (CUDA, periodic wrap in the "
                         "kernel, one shard), halo (CUDA on resident "
                         "shards with slab exchange), pallas (CUDA on the "
                         "halo-padded shards), xla (plain PyTorch), or "
                         "auto")
    ap.add_argument("--wrap-steps", type=int, default=0, metavar="N",
                    help="steps per launch of the N-step wrap and halo "
                         "kernels (default 2; sets STENCIL_WRAP_STEPS)")
    ap.add_argument("--exchange-every", type=int, default=0, metavar="S",
                    help="temporal blocking depth: one depth-S exchange "
                         "per S steps (xla), S steps a launch (wrap, "
                         "halo); 0 leaves the default")
    ap.add_argument("--overlap", action="store_true",
                    help="overlap the exchange with the interior update")
    ap.add_argument("--prefix", default="", help="output prefix (plan "
                    "file, comm matrix, ParaView dumps)")
    ap.add_argument("--paraview", action="store_true")
    ap.add_argument("--period", type=int, default=0,
                    help="paraview dump every N samples")
    add_device_flags(ap)
    add_method_flags(ap)
    add_placement_flags(ap)
    add_dtype_flags(ap)
    add_dcn_flags(ap)
    add_bench_record_flags(ap)
    res = add_resilience_flags(ap)
    res.add_argument("--fuse-segments",
                     action=argparse.BooleanOptionalAction, default=True,
                     help="segments (default on): one segment per "
                          "--check-every boundary, the probe rows on the "
                          "device; --no-fuse-segments steps one by one")
    res.add_argument("--chaos-halo", type=int, default=0, metavar="STEP",
                     help="corrupt a halo cell after STEP")
    res.add_argument("--chaos-preempt", type=int, default=0,
                     metavar="STEP", help="deliver SIGTERM after STEP")
    args = ap.parse_args(argv)
    rank = initialize_distributed(backend=args.backend)
    if args.wrap_steps:
        os.environ["STENCIL_WRAP_STEPS"] = str(args.wrap_steps)

    from ..models.jacobi import Jacobi3D
    from ..parallel.methods import pick_method

    devices, shape = mesh_from_args(args,
                                    xfree=args.kernel in ("halo", "auto"))
    gx, gy, gz = args.x * shape[0], args.y * shape[1], args.z * shape[2]
    j = Jacobi3D(gx, gy, gz, dtype=dtype_from_args(args),
                 kernel=args.kernel, mesh_shape=shape,
                 devices=devices, methods=methods_from_args(args),
                 exchange_every=args.exchange_every or None,
                 overlap=args.overlap, placement=placement_from_args(args),
                 output_prefix=args.prefix, **dcn_from_args(args, devices))
    j.init()
    if args.paraview:
        j.dd.write_paraview(args.prefix + "jacobi3d_init")
    if args.resilient:
        _run_resilient(j, args, rank)
        return
    n = 0

    def one():
        nonlocal n
        j.run(args.batch)
        n += 1
        if args.paraview and args.period and n % args.period == 0:
            j.dd.write_paraview(f"{args.prefix}jacobi3d_{n}")

    stats, sps = sampled_steps_per_s(one, j.block,
                                     max(args.iters // args.batch, 1),
                                     args.batch)
    b = j.dd.exchange_bytes_per_axis()
    xstats = j.exchange_stats()
    ex_s = j.measure_exchange_seconds()
    if args.paraview:
        j.dd.write_paraview(args.prefix + "jacobi3d_final")
    if rank != 0:
        return
    print(csv_line(
        "jacobi3d", pick_method(j.dd.methods), j.dd.num_subdomains(),
        gx, gy, gz, b["x"], b["y"], b["z"],
        f"{stats.min() / args.batch:.6e}",
        f"{stats.trimean() / args.batch:.6e}",
        xstats["path"], int(xstats["bytes_per_iteration"]),
        f"{ex_s:.6e}"))
    # the launch the port's planners choose for this shard, on a kernel
    # path (JAX apps/jacobi3d.py:200-215 records its VMEM blocks)
    tiling_plan = None
    if "xla" not in xstats["path"]:
        from ..tuning import geometry_from_domain, tiling_record

        tiling_plan = tiling_record(geometry_from_domain(
            j.dd, j.dd.mesh_counts))
    emit_bench_artifacts(
        args,
        {"bench": "jacobi3d",
         **({"tiling_plan": tiling_plan} if tiling_plan else {}),
         "config": {"grid": [gx, gy, gz], "devices": j.dd.num_subdomains(),
                    "mesh": list(shape), "kernel": xstats["path"],
                    "methods": str(methods_from_args(args)),
                    "dtype": str(j._dtype).replace("torch.", ""),
                    "exchange_every": args.exchange_every or 1},
         "metrics": {"steps_per_s": sps,
                     "min_step_s": stats.min() / args.batch,
                     "trimean_step_s": stats.trimean() / args.batch,
                     "bytes_per_iteration_model":
                         float(xstats["bytes_per_iteration"]),
                     "exchange_s_per_iteration": ex_s}},
        "jacobi3d")


if __name__ == "__main__":
    main()
