"""Fleet chaos smoke front end (serving/fleet).

PyTorch-port counterpart of the JAX package's ``apps/fleet.py``, with
its flags and its lines: drives a multi-replica serving fleet end to
end and exports the artifacts a gate reads: per-campaign sha256 digests
of the final field (the bitwise zero-loss comparison between a calm and
a chaos run), the fleet event log, the fleet metrics snapshot, and
every replica's metrics snapshot. Chaos is deterministic and declared
on the command line: kill a replica mid-batch (``--kill-replica``),
flood admission with low-priority junk (``--flood``), or both. The
replicas share the card(s) (every visible one unless ``--devices``
names others).

  # calm reference run, on the CPU
  python -m stencil_tpu_torch.apps.fleet --replicas 3 --tenants 4 \
      --devices cpu,cpu,cpu,cpu --fake-timer --tune-cache plans.json \
      --results-json calm.json
  # chaos run against the same plan cache: kill + flood
  python -m stencil_tpu_torch.apps.fleet --replicas 3 --tenants 4 \
      --devices cpu,cpu,cpu,cpu --fake-timer --tune-cache plans.json \
      --kill-replica 1 --kill-at-step 2 --flood 6 --max-queue-depth 3 \
      --results-json chaos.json --events-json events.json \
      --metrics-json metrics.json
"""

import argparse
import hashlib
import json
import shutil
import sys
import tempfile

from ._common import add_device_flags


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    add_device_flags(p, mesh=False)
    p.add_argument("--model", choices=("jacobi", "astaroth"),
                   default="jacobi")
    p.add_argument("--x", type=int, default=8)
    p.add_argument("--y", type=int, default=8)
    p.add_argument("--z", type=int, default=8)
    p.add_argument("--replicas", type=int, default=3)
    p.add_argument("--tenants", type=int, default=4,
                   help="concurrent fake tenants (t0..tN-1)")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--width", type=int, default=4,
                   help="per-replica ensemble width")
    p.add_argument("--ckpt-every", type=int, default=2)
    p.add_argument("--kill-replica", type=int, default=-1,
                   metavar="R",
                   help="hard-crash this replica index mid-batch "
                        "(chaos round 0; -1 = no crash; 'auto' via "
                        "--kill-owner-of)")
    p.add_argument("--kill-owner-of", default="", metavar="TENANT",
                   help="instead of an index, kill whichever replica "
                        "the rendezvous hash routes TENANT to — "
                        "guarantees the victim owns >= 1 campaign")
    p.add_argument("--kill-at-step", type=int, default=2,
                   metavar="STEP",
                   help="member step the armed crash fires at (after "
                        "that step's boundary work, checkpoints "
                        "included, has landed)")
    p.add_argument("--flood", type=int, default=0, metavar="N",
                   help="submit N priority-0 junk requests at chaos "
                        "round 0 (drives the shed path)")
    p.add_argument("--max-queue-depth", type=int, default=64,
                   help="SLO policy: shed sub-protected work when a "
                        "replica's exported queue depth reaches this")
    p.add_argument("--root", default="",
                   help="shared checkpoint root (default: tmpdir)")
    p.add_argument("--keep-root", action="store_true")
    p.add_argument("--fake-timer", action="store_true",
                   help="tune exchange plans with the deterministic "
                        "FakeTimer (CI: no hardware dependence)")
    p.add_argument("--tune-cache", default="",
                   help="shared tuning-plan cache path; point the "
                        "calm and chaos runs at ONE file so no chaos "
                        "replica ever re-measures")
    p.add_argument("--flight-dir", default="", metavar="DIR",
                   help="flight-recorder dump directory for every "
                        "replica (black-box dumps on crash)")
    p.add_argument("--results-json", default="", metavar="PATH",
                   help="write per-campaign digests + per-replica "
                        "metric readbacks here (the CI bitwise "
                        "artifact)")
    p.add_argument("--events-json", default="", metavar="PATH",
                   help="write the fleet event log here")
    p.add_argument("--metrics-json", default="", metavar="PATH",
                   help="write the fleet metrics snapshot here")
    args = p.parse_args(argv)

    import numpy as np

    from ..resilience.faults import AdmissionFlood, ReplicaCrash
    from ..serving import (CampaignRequest, Fleet, SloPolicy,
                           rendezvous_replica)
    from ..serving.queue import request_fingerprint
    from ..tuning import FakeTimer
    from ._common import devices_from_args

    devices = (devices_from_args(args) if args.devices or args.device
               else None)

    def request(tenant: str, seed: int) -> CampaignRequest:
        params = ({"hot_temp": 1.0 + 0.05 * seed}
                  if args.model == "jacobi" else
                  {"nu_visc": 5e-3 * (1.0 + 0.1 * seed)})
        return CampaignRequest(
            tenant=tenant, campaign="c0", model=args.model,
            grid=(args.x, args.y, args.z), n_steps=args.steps,
            ckpt_every=args.ckpt_every, init_seed=100 + seed,
            params=params)

    tenants = [f"t{i}" for i in range(args.tenants)]
    reqs = [request(t, i) for i, t in enumerate(tenants)]

    victim = args.kill_replica
    if args.kill_owner_of:
        names = [f"replica-{i}" for i in range(args.replicas)]
        fp = request_fingerprint(request(args.kill_owner_of, 0),
                                 devices=devices)
        owner = rendezvous_replica(f"{fp}|{args.kill_owner_of}", names)
        victim = int(owner.rsplit("-", 1)[1])
    chaos = []
    if victim >= 0:
        chaos.append(ReplicaCrash(step=0, replica=victim,
                                  at_member_step=args.kill_at_step))
        print(f"chaos: kill replica-{victim} at member step "
              f"{args.kill_at_step}", file=sys.stderr)
    if args.flood > 0:
        chaos.append(AdmissionFlood(step=0, tenant="flood",
                                    count=args.flood, priority=0,
                                    n_steps=1))
        print(f"chaos: flood {args.flood} priority-0 requests",
              file=sys.stderr)

    root = args.root or tempfile.mkdtemp(prefix="fleet_root.")
    fl = Fleet(
        root, n_replicas=args.replicas, devices=devices, width=args.width,
        tuner_timer=FakeTimer() if args.fake_timer else None,
        plan_cache_path=args.tune_cache or None,
        policy=SloPolicy(max_queue_depth=args.max_queue_depth),
        chaos=chaos,
        flight_recorder_dir=args.flight_dir or None)

    # artifacts export on the FAILURE path too — a lost campaign is
    # exactly when the event log and digests are needed
    results = {"run": fl.run_id, "killed": victim if victim >= 0 else None,
               "campaigns": {}, "replicas": {}}
    try:
        handles = [fl.submit(r) for r in reqs]
        fl.serve()
        for t, h in zip(tenants, handles):
            if not h.done():
                results["campaigns"][t] = {"ok": False,
                                           "error": "lost (unresolved)"}
                continue
            try:
                r = h.result(timeout=0)
            except Exception as e:  # noqa: BLE001 - recorded, gated in CI
                results["campaigns"][t] = {
                    "ok": False, "error": f"{type(e).__name__}: {e}"}
                continue
            field = np.ascontiguousarray(
                np.asarray(next(iter(r.final.values()))))
            results["campaigns"][t] = {
                "ok": True, "steps": r.steps,
                "resumed_from": r.resumed_from,
                "digest": hashlib.sha256(field.tobytes()).hexdigest()}
            print(f"{r.tenant}/{r.campaign}: steps={r.steps} "
                  f"resumed_from={r.resumed_from} "
                  f"digest={results['campaigns'][t]['digest'][:12]}")
        # per-replica readbacks come off the EXPORTED metrics text —
        # the same surface an external scraper would gate on
        from ..telemetry import metric_value
        for rep in fl.replicas:
            text = rep.service.metrics_text()
            results["replicas"][rep.name] = {
                "state": rep.state,
                "batches": metric_value(
                    text, "stencil_service_batches_total"),
                "compiles": metric_value(
                    text, "stencil_service_compiles_total"),
                "recompiles": metric_value(
                    text, "stencil_service_recompiles_total"),
                "tuner_measurements": metric_value(
                    text, "stencil_service_tuner_measurements_total"),
                "metrics": rep.service.metrics.snapshot()}
        results["fleet_metrics"] = fl.metrics_snapshot()
        states = [r["state"] for r in results["replicas"].values()]
        print(f"fleet: replicas={states} "
              f"campaigns_ok="
              f"{sum(1 for c in results['campaigns'].values() if c['ok'])}"
              f"/{len(tenants)}")
    finally:
        def attempt(what, fn) -> None:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - report, don't mask
                print(f"warning: {what} failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)

        if args.results_json:
            attempt("results export", lambda: (
                json.dump(results, open(args.results_json, "w"),
                          indent=1),
                print(f"results -> {args.results_json}",
                      file=sys.stderr)))
        if args.events_json:
            attempt("event log export", lambda: (
                fl.write_events(args.events_json),
                print(f"event log -> {args.events_json}",
                      file=sys.stderr)))
        if args.metrics_json:
            attempt("metrics snapshot export", lambda: (
                fl.metrics.write_snapshot(args.metrics_json),
                print(f"metrics snapshot -> {args.metrics_json}",
                      file=sys.stderr)))
        if not args.root and not args.keep_root:
            shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
