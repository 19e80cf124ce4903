"""Weak-scaling particle-in-cell demo (models/pic.py).

PyTorch-port counterpart of the JAX package's ``apps/pic.py``: charged
particles deposit onto the sharded grid (reverse halo-accumulate),
gather the field, push, and migrate between shards over the
fixed-capacity ring each step. CSV result line ``pic,methods,devices,x,
y,z,particles,deposition,min (s),trimean (s),particle_steps_per_s,
mig_bytes_per_shard,overflow``.

    python -m stencil_tpu_torch.apps.pic --devices cpu,cpu,cpu,cpu

``--fuse-segments`` (on by default, as JAX's): the segment race on one
device at the per-device size (``_common.megastep_race``): one step and
one health probe an iteration against one ``--fuse-check-every``-step
segment (the probe rows, overflow column included, kept on the device),
printed as ``pic-megastep,check_every,steps,stepwise steps/s,fused
steps/s,ratio`` and added to ``--json-out`` as ``fused``;
``--no-fuse-segments`` skips it.

Not in this slice: ``--resilient`` and the ``--chaos-*`` fault plan wait
for ROADMAP A11, ``--metrics-json`` and ``--ledger`` for A12; each
raises when given.
"""

from __future__ import annotations

import argparse
import json

from ._common import (add_bench_record_flags, add_device_flags,
                      add_dtype_flags, add_method_flags, csv_line,
                      devices_from_args, dtype_from_args, megastep_race,
                      methods_from_args, refuse_pending, sampled_steps_per_s)


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
                    help="telemetry snapshot (ROADMAP A12: not ported)")
    add_dtype_flags(ap)
    add_method_flags(ap)
    add_device_flags(ap, mesh=False)
    add_bench_record_flags(ap)
    res = ap.add_argument_group(
        "resilience", "the checkpoint-rollback driver and its fault plan "
        "(ROADMAP A11: not ported)")
    res.add_argument("--resilient", action="store_true")
    res.add_argument("--ckpt-dir", default="")
    res.add_argument("--ckpt-every", type=int, default=4)
    res.add_argument("--check-every", type=int, default=1)
    res.add_argument("--max-retries", type=int, default=3)
    res.add_argument("--events-json", default="")
    res.add_argument("--chaos-particle-loss", type=int, default=0,
                     metavar="STEP")
    res.add_argument("--chaos-particle-count", type=int, default=2)
    res.add_argument("--chaos-nan", type=int, default=0, metavar="STEP")
    res.add_argument("--chaos-save-fail", type=int, default=0,
                     metavar="STEP")
    res.add_argument("--chaos-seed", type=int, default=0)
    args = ap.parse_args(argv)
    refuse_pending(args, [
        ("--resilient", "A11 (resilience)", False),
        ("--chaos-particle-loss", "A11 (resilience)", 0),
        ("--chaos-nan", "A11 (resilience)", 0),
        ("--chaos-save-fail", "A11 (resilience)", 0),
        ("--metrics-json", "A12 (telemetry)", "")])

    from ..models.pic import Pic
    from ..parallel.mesh import default_mesh_shape

    devices = devices_from_args(args)
    ndev = len(devices)
    mesh = default_mesh_shape(ndev)
    gx, gy, gz = args.x * mesh.x, args.y * mesh.y, args.z * mesh.z
    n = args.particles * ndev
    p = Pic(gx, gy, gz, n, mesh_shape=mesh, dtype=dtype_from_args(args),
            devices=devices, methods=methods_from_args(args),
            capacity=args.capacity or None, budget=args.budget or None,
            deposition=args.deposition, dt=args.dt, seed=args.seed)
    stats, sps = sampled_steps_per_s(lambda: p.run(args.batch), p.block,
                                     max(args.iters // args.batch, 1),
                                     args.batch)
    mig = p.migration_stats()
    psps = n * sps  # particle steps advanced per second
    print(csv_line("pic", methods_from_args(args), ndev, gx, gy, gz, n,
                   args.deposition, f"{stats.min() / args.batch:.6e}",
                   f"{1.0 / sps:.6e}", f"{psps:.6e}",
                   mig["migration_bytes_per_shard"],
                   int(p.overflow_total())))
    fused = None
    if args.fuse_segments:
        k = max(args.fuse_check_every, 1)
        nr = max(args.iters, k)
        nr -= nr % k

        def mk():
            return Pic(args.x, args.y, args.z, args.particles,
                       mesh_shape=(1, 1, 1), devices=devices[:1],
                       dtype=dtype_from_args(args),
                       deposition=args.deposition, dt=args.dt,
                       seed=args.seed)

        sps_s, fps, ratio = megastep_race(
            mk, lambda e: e.make_sentinel(), lambda e: e.state, k, nr)
        fused = {"check_every": k, "steps": nr,
                 "stepwise_steps_per_s": sps_s, "fused_steps_per_s": fps,
                 "fused_over_stepwise": ratio}
        print(csv_line("pic-megastep", k, nr, f"{sps_s:.3f}", f"{fps:.3f}",
                       f"{ratio:.3f}"))
    if args.json_out:
        rec = {"bench": "pic",
               "config": {"grid": [gx, gy, gz], "devices": ndev,
                          "particles": n, "deposition": args.deposition,
                          "dt": args.dt, "capacity": p.capacity,
                          "budget": p.budget,
                          "dtype": str(p._dtype).replace("torch.", "")},
               "seconds_per_step": 1.0 / sps,
               "particle_steps_per_s": psps,
               "migration_bytes_per_shard": mig["migration_bytes_per_shard"],
               "overflow": p.overflow_total(),
               "total_charge": p.total_charge()}
        if fused is not None:
            rec["fused"] = fused
        with open(args.json_out, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
