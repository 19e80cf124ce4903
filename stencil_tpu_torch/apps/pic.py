"""Weak-scaling particle-in-cell demo (models/pic.py).

PyTorch-port counterpart of the JAX package's ``apps/pic.py``: charged
particles deposit onto the sharded grid (reverse halo-accumulate),
gather the field, push, and migrate between shards over the
fixed-capacity ring each step. CSV result line ``pic,methods,devices,x,
y,z,particles,deposition,min (s),trimean (s),particle_steps_per_s,
mig_bytes_per_shard,overflow``.

    python -m stencil_tpu_torch.apps.pic --devices cpu,cpu,cpu,cpu

Under torchrun every rank runs its own shards (``--devices`` are its
own; ``--backend gloo`` puts several ranks on one card), the deposit's
accumulate, the exchange and the migration send what crosses between
ranks as messages, and rank 0 prints:

    python -m torch.distributed.run --nproc_per_node 2 \
        -m stencil_tpu_torch.apps.pic --devices cuda:0,cuda:0,cuda:0,cuda:0 \
        --backend gloo --x 64 --y 64 --z 64 --particles 262144

``--fuse-segments`` (on by default, as JAX's): the segment race on one
device at the per-device size (``_common.megastep_race``): one step and
one health probe an iteration against one ``--fuse-check-every``-step
segment (the probe rows, overflow column included, kept on the device),
printed as ``pic-megastep,check_every,steps,stepwise steps/s,fused
steps/s,ratio`` and added to ``--json-out`` as ``fused``;
``--no-fuse-segments`` skips it. Under torchrun each rank races on
its own first device and rank 0 prints its race.

``--resilient`` runs ``--iters`` steps under the checkpoint-rollback
driver (``Pic.run_resilient``) instead of the timed loop, with the
seeded faults of the ``--chaos-*`` flags, checkpoints every
``--ckpt-every`` steps into ``--ckpt-dir`` (a preempted run resumes from
it) and the event log in ``--events-json``; it prints JAX's line
``pic-resilient,methods,steps,rollbacks,save_retries,preempted,
overflow,final_config``:

    python -m stencil_tpu_torch.apps.pic --devices cpu,cpu,cpu,cpu \
        --resilient --chaos-particle-loss 3 --ckpt-dir /tmp/pic_ckpt

``--json-out`` writes the timed run's JSON and appends its ledger
records (``--ledger``, ``_common.emit_bench_artifacts``);
``--metrics-json`` writes JAX's gauges
(``stencil_bench_particle_steps_per_s{deposition}``,
``stencil_bench_migration_bytes_per_shard{deposition}``) as a telemetry
snapshot.
"""

from __future__ import annotations

import argparse

from ._common import (add_bench_record_flags, add_device_flags,
                      add_dtype_flags, add_method_flags,
                      add_resilience_flags, csv_line, emit_bench_artifacts,
                      devices_from_args, dtype_from_args, megastep_race,
                      methods_from_args, sampled_steps_per_s)


def _run_resilient(p, args, rank: int) -> None:
    """The chaos entry (JAX ``apps/pic.py:24``): the recovery driver
    with the seeded faults of the ``--chaos-*`` flags, then a summary
    line and, optionally, the event-log JSON."""
    from ..resilience import (FaultPlan, NaNInjection, ParticleLoss,
                              ResiliencePolicy, TransientSaveFailure)

    plan = FaultPlan(seed=args.chaos_seed)
    if args.chaos_particle_loss:
        plan.particle_losses.append(
            ParticleLoss(step=args.chaos_particle_loss,
                         count=args.chaos_particle_count))
    if args.chaos_nan:
        plan.nans.append(NaNInjection(step=args.chaos_nan))
    if args.chaos_save_fail:
        plan.save_failures.append(
            TransientSaveFailure(step=args.chaos_save_fail))
    policy = ResiliencePolicy(check_every=args.check_every,
                              ckpt_every=args.ckpt_every,
                              max_retries=args.max_retries,
                              base_delay=0.01,
                              fuse_segments=args.fuse_segments)
    report = p.run_resilient(args.iters, policy=policy,
                             ckpt_dir=args.ckpt_dir or None, faults=plan)
    overflow = int(p.overflow_total())
    if rank != 0:
        return
    if args.events_json:
        report.write(args.events_json)
    print(csv_line("pic-resilient", methods_from_args(args),
                   report.steps, report.rollbacks, report.save_retries,
                   int(report.preempted), overflow, report.final_config))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--x", type=int, default=8, help="per-device x size")
    ap.add_argument("--y", type=int, default=8)
    ap.add_argument("--z", type=int, default=8)
    ap.add_argument("--particles", type=int, default=512, metavar="N",
                    help="particles per DEVICE (weak scaling)")
    ap.add_argument("--iters", "-n", type=int, default=20)
    ap.add_argument("--batch", type=int, default=5,
                    help="iterations per timing sample")
    ap.add_argument("--deposition", choices=("cic", "ngp"), default="cic")
    ap.add_argument("--dt", type=float, default=0.25)
    ap.add_argument("--capacity", type=int, default=0,
                    help="per-shard particle slots (0 = 2x mean fill)")
    ap.add_argument("--budget", type=int, default=0,
                    help="migration record slots per direction "
                         "(0 = capacity/4)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fuse-segments",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="race --fuse-check-every-step segments (probe "
                         "rows on the device) against the per-step loop "
                         "of one step and one probe, on one device")
    ap.add_argument("--fuse-check-every", type=int, default=8,
                    help="segment length for the race")
    ap.add_argument("--metrics-json", default="", metavar="PATH",
                    help="also record the measured numbers as a telemetry "
                         "metrics snapshot (gauges stencil_bench_particle_"
                         "steps_per_s{deposition=} and stencil_bench_"
                         "migration_bytes_per_shard{deposition=})")
    add_dtype_flags(ap)
    add_method_flags(ap)
    add_device_flags(ap, mesh=False)
    add_bench_record_flags(ap)
    res = add_resilience_flags(ap, ckpt_every=4)
    res.add_argument("--chaos-particle-loss", type=int, default=0,
                     metavar="STEP", help="NaN particle records of shard 0 "
                     "after STEP (ParticleLoss)")
    res.add_argument("--chaos-particle-count", type=int, default=2)
    args = ap.parse_args(argv)
    if args.resilient and args.json_out:
        ap.error("--json-out records the timed bench path; it is not "
                 "produced by --resilient (use --events-json there)")

    from ..models.pic import Pic
    from ..parallel.mesh import as_global, default_mesh_shape
    from ..parallel.multihost import initialize_distributed

    rank = initialize_distributed(backend=args.backend)
    devices = devices_from_args(args)
    ndev = len(devices)
    mesh = default_mesh_shape(ndev)
    gx, gy, gz = args.x * mesh.x, args.y * mesh.y, args.z * mesh.z
    n = args.particles * ndev
    p = Pic(gx, gy, gz, n, mesh_shape=mesh, dtype=dtype_from_args(args),
            devices=devices, methods=methods_from_args(args),
            capacity=args.capacity or None, budget=args.budget or None,
            deposition=args.deposition, dt=args.dt, seed=args.seed)
    if args.resilient:
        _run_resilient(p, args, rank)
        return
    stats, sps = sampled_steps_per_s(lambda: p.run(args.batch), p.block,
                                     max(args.iters // args.batch, 1),
                                     args.batch)
    mig = p.migration_stats()
    psps = n * sps  # particle steps advanced per second
    overflow = int(p.overflow_total())
    charge = p.total_charge()
    if rank == 0:
        print(csv_line("pic", methods_from_args(args), ndev, gx, gy, gz, n,
                       args.deposition, f"{stats.min() / args.batch:.6e}",
                       f"{1.0 / sps:.6e}", f"{psps:.6e}",
                       mig["migration_bytes_per_shard"], overflow))
    fused = None
    if args.fuse_segments:
        k = max(args.fuse_check_every, 1)
        nr = max(args.iters, k)
        nr -= nr % k
        # this rank's first device (a mesh of one, in this process)
        own = [as_global(d).device for d in devices
               if as_global(d).rank == rank][:1]

        def mk():
            return Pic(args.x, args.y, args.z, args.particles,
                       mesh_shape=(1, 1, 1), devices=own,
                       dtype=dtype_from_args(args),
                       deposition=args.deposition, dt=args.dt,
                       seed=args.seed)

        sps_s, fps, ratio = megastep_race(
            mk, lambda e: e.make_sentinel(), lambda e: e.state, k, nr)
        fused = {"check_every": k, "steps": nr,
                 "stepwise_steps_per_s": sps_s, "fused_steps_per_s": fps,
                 "fused_over_stepwise": ratio}
        if rank == 0:
            print(csv_line("pic-megastep", k, nr, f"{sps_s:.3f}",
                           f"{fps:.3f}", f"{ratio:.3f}"))
    if args.json_out and rank == 0:
        rec = {"bench": "pic",
               "config": {"grid": [gx, gy, gz], "devices": ndev,
                          "particles": n, "deposition": args.deposition,
                          "dt": args.dt, "capacity": p.capacity,
                          "budget": p.budget,
                          "dtype": str(p._dtype).replace("torch.", "")},
               "seconds_per_step": 1.0 / sps,
               "particle_steps_per_s": psps,
               "migration_bytes_per_shard": mig["migration_bytes_per_shard"],
               "overflow": overflow, "total_charge": charge}
        if fused is not None:
            rec["fused"] = fused
        emit_bench_artifacts(args, rec, "pic")
    if args.metrics_json and rank == 0:
        # the same figures as the JSON, as JAX's gauges
        from ..telemetry import MetricsRegistry

        reg = MetricsRegistry()
        reg.gauge("stencil_bench_particle_steps_per_s",
                  "measured particle steps/s of the PIC loop, by "
                  "deposition scheme").set(psps, deposition=args.deposition)
        reg.gauge("stencil_bench_migration_bytes_per_shard",
                  "static migration wire B/shard/step of the measured "
                  "configuration (analytic model)").set(
            mig["migration_bytes_per_shard"], deposition=args.deposition)
        reg.write_snapshot(args.metrics_json)


if __name__ == "__main__":
    main()
