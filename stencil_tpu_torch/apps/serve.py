"""Ensemble campaign service front end (serving/).

PyTorch-port counterpart of the JAX package's ``apps/serve.py``, with
its flags and its lines: a first wave of concurrent fake-tenant
campaigns (distinct tenants, one shared problem fingerprint) is
submitted and served as ONE batched ensemble dispatch stream, then a
second fingerprint-identical wave proves the warm path: zero recompiles
(engine cache) and zero tuner measurements (plan cache). The event log
JSON is the service-smoke artifact.

The service runs on every visible card unless ``--devices`` (or
``--device``) names others; on the CPU:

  python -m stencil_tpu_torch.apps.serve --tenants 3 --steps 6 \
      --devices cpu,cpu,cpu,cpu --events-json events.json \
      --fake-timer --tune-cache plans.json
  python -m stencil_tpu_torch.apps.serve --tenants 2 --model astaroth \
      --steps 2 --devices cpu,cpu,cpu,cpu
"""

import argparse
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
    p.add_argument("--tenants", type=int, default=3,
                   help="concurrent fake tenants in the first wave")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--width", type=int, default=8,
                   help="ensemble width (members per dispatch)")
    p.add_argument("--ckpt-every", type=int, default=2)
    p.add_argument("--check-every", type=int, default=1)
    p.add_argument("--snapshot-every", type=int, default=3)
    p.add_argument("--second-wave", type=int, default=1,
                   help="fingerprint-identical requests submitted "
                        "after the first wave (the warm path)")
    p.add_argument("--chaos-nan", type=int, default=0, metavar="STEP",
                   help="poison tenant 0's campaign at this member "
                        "step (proves member-isolated rollback)")
    p.add_argument("--max-retries", type=int, default=None,
                   metavar="N",
                   help="per-campaign rollback budget before it fails "
                        "(default: the service default; 0 + "
                        "--chaos-nan drives the failure path, which "
                        "still exports every telemetry artifact)")
    p.add_argument("--root", default="",
                   help="checkpoint namespace root (default: tmpdir)")
    p.add_argument("--keep-root", action="store_true")
    p.add_argument("--events-json", default="",
                   help="write the service event log + stats here")
    p.add_argument("--metrics-port", type=int, default=-1,
                   metavar="PORT",
                   help="serve Prometheus /metrics (and /metrics.json)"
                        " on this port while running (0 = ephemeral; "
                        "default: disabled)")
    p.add_argument("--metrics-host", default="127.0.0.1",
                   metavar="HOST",
                   help="bind address for --metrics-port (default "
                        "loopback; 0.0.0.0 for a remote scraper)")
    p.add_argument("--metrics-json", default="", metavar="PATH",
                   help="write the final metrics snapshot JSON here "
                        "(the CI telemetry artifact)")
    p.add_argument("--trace-json", default="", metavar="PATH",
                   help="write the Chrome trace-event JSON of the "
                        "service spans here (load in Perfetto)")
    p.add_argument("--fuse-segments",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="megastep serving (default on): each batch "
                        "segment is ONE fused dispatch carrying the "
                        "per-member probe trace in-graph; "
                        "--no-fuse-segments restores the step-loop + "
                        "separate-probe path")
    p.add_argument("--fake-timer", action="store_true",
                   help="tune exchange plans with the deterministic "
                        "FakeTimer (CI: no hardware dependence)")
    p.add_argument("--tune-cache", default="",
                   help="tuning-plan cache path (shared across runs "
                        "-> the second process is a plan-cache hit)")
    p.add_argument("--flight-dir", default="", metavar="DIR",
                   help="arm the flight recorder: bounded black-box "
                        "dumps (events + spans + metrics + probe "
                        "history) land here on sentinel trip, "
                        "preemption, and unhandled batch errors "
                        "(default $STENCIL_FLIGHT_RECORDER_DIR)")
    p.add_argument("--retune-on-drift", action="store_true",
                   help="perf-drift healing: K consecutive attributed "
                        "segments outside tolerance invalidate the "
                        "plan-cache record so the next tune "
                        "re-measures")
    args = p.parse_args(argv)

    from ..serving import CampaignRequest, CampaignService
    from ..tuning import FakeTimer
    from ._common import devices_from_args

    devices = (devices_from_args(args) if args.devices or args.device
               else None)
    root = args.root or tempfile.mkdtemp(prefix="serve_root.")
    svc = CampaignService(
        root, devices=devices, width=args.width,
        tuner_timer=FakeTimer() if args.fake_timer else None,
        plan_cache_path=args.tune_cache or None,
        fuse_segments=args.fuse_segments,
        flight_recorder_dir=args.flight_dir or None,
        retune_on_drift=args.retune_on_drift)

    metrics_server = None
    if args.metrics_port >= 0:
        from ..telemetry import MetricsServer

        metrics_server = MetricsServer(svc.metrics,
                                       port=args.metrics_port,
                                       host=args.metrics_host)
        port = metrics_server.start()
        print(f"metrics: http://{args.metrics_host}:{port}/metrics",
              file=sys.stderr)

    def request(tenant: str, campaign: str, seed: int,
                chaos=None) -> CampaignRequest:
        params = ({"hot_temp": 1.0 + 0.05 * seed}
                  if args.model == "jacobi" else
                  {"nu_visc": 5e-3 * (1.0 + 0.1 * seed)})
        kw = {} if args.max_retries is None \
            else {"max_retries": args.max_retries}
        return CampaignRequest(
            tenant=tenant, campaign=campaign, model=args.model,
            grid=(args.x, args.y, args.z), n_steps=args.steps,
            ckpt_every=args.ckpt_every, check_every=args.check_every,
            snapshot_every=args.snapshot_every, init_seed=100 + seed,
            params=params, chaos_nan_step=chaos, **kw)

    # artifacts export on the FAILURE path too — a failed campaign is
    # exactly when the metrics/trace/event log are needed
    try:
        # submit the whole first wave BEFORE the worker starts so
        # admission packs it into one fingerprint-compatible batch
        handles = [svc.submit(request(
            f"tenant{i}", "wave1", i,
            chaos=args.chaos_nan if (args.chaos_nan and i == 0)
            else None))
            for i in range(args.tenants)]
        svc.start()
        for h in handles:
            r = h.result(timeout=600)
            print(f"{r.tenant}/{r.campaign}: steps={r.steps} "
                  f"rollbacks={r.rollbacks} "
                  f"snapshots={[s for s, _ in r.snapshots]}")

        for j in range(args.second_wave):
            h = svc.submit(request(f"tenant{args.tenants + j}",
                                   "wave2", args.tenants + j))
            r = h.result(timeout=600)
            print(f"{r.tenant}/{r.campaign}: steps={r.steps} "
                  f"rollbacks={r.rollbacks} (warm path)")

        s = svc.stats
        print(f"stats: batches={s.batches} compiles={s.compiles} "
              f"plan_cache_hits={s.plan_cache_hits} "
              f"tuner_measurements={s.tuner_measurements} "
              f"completed={s.completed} failed={s.failed} "
              f"rollbacks={s.rollbacks}")
    finally:
        # each step is best-effort: one unwritable artifact must not
        # mask the CampaignFailed being raised nor skip the others
        def attempt(what, fn) -> None:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - report, don't mask
                print(f"warning: {what} failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)

        attempt("service stop", svc.stop)
        if args.events_json:
            attempt("event log export", lambda: (
                svc.write_events(args.events_json),
                print(f"event log -> {args.events_json}",
                      file=sys.stderr)))
        if args.metrics_json:
            attempt("metrics snapshot export", lambda: (
                svc.metrics.write_snapshot(args.metrics_json),
                print(f"metrics snapshot -> {args.metrics_json}",
                      file=sys.stderr)))
        if args.trace_json:
            attempt("span trace export", lambda: (
                svc.export_trace(args.trace_json),
                print(f"span trace -> {args.trace_json}",
                      file=sys.stderr)))
        if metrics_server is not None:
            attempt("metrics server stop", metrics_server.stop)
        if not args.root and not args.keep_root:
            shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
