"""Halo-exchange micro-benchmark with face/edge/corner radius control.

PyTorch-port counterpart of ``apps/bench_exchange.py`` (reference:
bin/bench_exchange.cu — ``--fr/--er/--cr`` radius flags, trimean
seconds and trimean B/s, bin/bench_exchange.cu:58-64,86-100).

Temporal blocking: ``--exchange-every 1,4`` sweeps communication-
avoiding depths (``axis=value`` tokens such as ``z=4,y=1,x=1`` merge into
one per-axis candidate after the uniform ones). Each depth is measured
two ways: the per-exchange time of ``dd.exchange()`` on a domain built
with ``set_exchange_every(s)`` (deep slabs), printed as the CSV line

    bench_exchange,methods,devices,x,y,z,fr,er,cr,fields,exchange_every,bytes,trimean (s),B/s

and the steps/s of ``Jacobi3D(kernel="xla", exchange_every=s)``'s run
loop (the ``xla-temporal`` path, which pays the redundant ring compute
and the deeper slabs), with the amortized byte model beside it, on
stderr; ``--json-out`` writes both as JSON. ``--x/--y/--z`` are the size
of one shard: the grid is that times the mesh.

Wire layouts: ``--wire-layout slab,irredundant`` sweeps in the first
layout and races each further one at the smallest swept depth (JAX
``apps/bench_exchange.py:246-290``): the per-exchange seconds of
``dd.exchange()`` and the blocked Jacobi steps/s, as ratios against the
sweep's, with the bytes ratio from the byte model, printed as

    bench_exchange_layout,layout,baseline layout,exchange_every,bytes,trimean (s),bytes ratio,steps/s ratio

and added to ``--json-out`` as ``wire_layout_race``. Run it as

    python -m stencil_tpu_torch.apps.bench_exchange \\
        --devices cuda:0,cuda:0,cuda:0,cuda:0 --exchange-every 1,2,4

Segments: ``--fuse-segments`` races ``--check-every``-step segments
(``parallel/megastep.py``, the health probe's rows kept on the device)
against the per-step loop of one step and one probe an iteration, on
one device at the per-shard size, in three legs as JAX's
(``apps/bench_exchange.py:335-415``): Jacobi ``xla``, PIC (256 CIC
float32 particles, the whole state carried) and Astaroth's
``xla-temporal[s=2]``, printed as

    bench_exchange_megastep_<leg>,check_every,steps,stepwise steps/s,fused steps/s,ratio

and the Jacobi leg once more as ``bench_exchange_megastep``; ``--json-out``
adds them as ``fused``.

Under torchrun every rank runs its own shards (``--devices`` are its
own; ``--backend gloo`` puts several ranks on one card), every method
runs across the ranks (``--pallas-dma``: B4 storing into the other
ranks' shards over CUDA IPC on the card), each rank races the segments
on its own first device, and rank 0 prints and writes ``--json-out``:

    python -m torch.distributed.run --nproc_per_node 2 \
        -m stencil_tpu_torch.apps.bench_exchange --devices cuda:0,cuda:0 \
        --mesh-shape 1,2,2 --backend gloo --pallas-dma

The autotuner (``--autotune``, JAX ``apps/bench_exchange.py:289-331``):
tune the Jacobi problem itself (radius 1, one float32 field) through
``DistributedDomain.autotune`` (plan cache ``--tune-cache``, else
``$STENCIL_TUNE_CACHE``, else the default), print its report on stderr,
and race the plan's method and depth against ``Method.Default`` on the
blocked Jacobi loop, printed as

    bench_exchange_autotune,plan,provenance,default steps/s,tuned steps/s,ratio

and added to ``--json-out`` as ``autotune``. The link observatory
classifies the first swept depth's traffic matrix by mesh axis and link
class (``observatory/linkmap.link_attribution_for``): each one's bytes a
step, share, and utilization of its fitted peak at the measured
exchange time, in ``--json-out`` as ``link_classes``. ``--metrics-json``
writes JAX's gauges (``stencil_bench_steps_per_s{exchange_every}``,
``stencil_bench_bytes_per_step_model``, the tuned race, the segment
race and the link gauges) as a telemetry snapshot; ``--json-out`` also
appends the observatory's ledger records (``--ledger``,
``apps/_common.emit_bench_artifacts``).

Only CSV lines go to stdout.
"""

from __future__ import annotations

import argparse
import sys

from ._common import (add_bench_record_flags, add_device_flags,
                      add_method_flags, csv_line, emit_bench_artifacts,
                      grouped_steps_per_s, megastep_race, mesh_from_args,
                      methods_from_args, timed_samples)


def _parse_depths(text: str):
    """Comma list of depths to sweep. Plain integers are uniform depths;
    ``axis=value`` tokens (``z=4,y=1,x=1``) merge into ONE per-axis
    candidate appended after the uniform sweep."""
    ints = set()
    axes = {}
    for t in (t.strip() for t in text.split(",")):
        if not t:
            continue
        if "=" in t:
            k, v = t.split("=", 1)
            k = k.strip().lower()
            if k not in ("x", "y", "z"):
                raise SystemExit(f"--exchange-every axis token wants "
                                 f"x=/y=/z=, got {t!r}")
            axes[k] = int(v)
        else:
            ints.add(int(t))
    depths = sorted(ints)
    if axes:
        depths.append(axes)
    bad = any(s < 1 for s in ints) or any(v < 1 for v in axes.values())
    if not depths or bad:
        raise SystemExit(f"--exchange-every wants depths >= 1, got {text!r}")
    return depths


def _depth_max(s) -> int:
    return max(s.values()) if isinstance(s, dict) else int(s)


def _depth_label(s) -> str:
    """Uniform depths keep the bare integer; per-axis depths read
    ``x.y.z``."""
    if isinstance(s, dict):
        from ..geometry import normalize_depths
        d = normalize_depths(s)
        return f"{d.x}.{d.y}.{d.z}"
    return str(s)


#: this process's rank: only rank 0 prints
_RANK = [0]


def _say(*a, **kw) -> None:
    if _RANK[0] == 0:
        print(*a, **kw)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--x", type=int, default=128, help="per-shard x size")
    ap.add_argument("--y", type=int, default=128)
    ap.add_argument("--z", type=int, default=128)
    ap.add_argument("--fr", type=int, default=2, help="face radius")
    ap.add_argument("--er", type=int, default=2, help="edge radius")
    ap.add_argument("--cr", type=int, default=2, help="corner radius")
    ap.add_argument("--fields", type=int, default=1)
    ap.add_argument("--iters", "-n", type=int, default=30)
    ap.add_argument("--exchange-every", default="1", metavar="S[,S...]",
                    help="temporal-blocking depths to sweep (comma list; "
                         "1 = the per-step exchange; axis=value tokens "
                         "like z=4,y=1,x=1 merge into one per-axis "
                         "candidate)")
    ap.add_argument("--wire-layout", default="slab", metavar="L[,L...]",
                    help="halo wire message layouts (comma list of "
                         "slab,irredundant): the first is the sweep's "
                         "layout; each further layout races per-exchange "
                         "seconds and the blocked Jacobi steps/s against "
                         "the sweep's at its smallest depth")
    ap.add_argument("--metrics-json", default="", metavar="PATH",
                    help="also record the measured numbers as a telemetry "
                         "metrics snapshot (gauges stencil_bench_steps_"
                         "per_s{exchange_every=}, stencil_bench_bytes_per_"
                         "step_model{...})")
    ap.add_argument("--fuse-segments", action="store_true",
                    help="race --check-every-step segments (health probe "
                         "rows on the device) against the per-step loop "
                         "on the same problems, on one device")
    ap.add_argument("--check-every", type=int, default=8,
                    help="segment length for --fuse-segments")
    ap.add_argument("--autotune", action="store_true",
                    help="run the exchange autotuner and race the tuned "
                         "plan against Method.Default on the blocked "
                         "Jacobi loop")
    ap.add_argument("--tune-cache", default="", metavar="PATH",
                    help="plan cache file for --autotune (default: "
                         "$STENCIL_TUNE_CACHE or "
                         "~/.cache/stencil_tpu_torch/plans.json)")
    add_method_flags(ap)
    add_device_flags(ap)
    add_bench_record_flags(ap)
    args = ap.parse_args(argv)

    import torch

    from ..distributed import DistributedDomain
    from ..geometry import Radius
    from ..models.jacobi import Jacobi3D
    from ..parallel.methods import Method
    from ..parallel.packing import WIRE_LAYOUTS
    from ..parallel.mesh import as_global
    from ..parallel.multihost import initialize_distributed
    from ..utils.timers import device_sync

    _RANK[0] = rank = initialize_distributed(backend=args.backend)
    devices, mesh_shape = mesh_from_args(args)
    ndev = len(devices)
    gx, gy, gz = (args.x * mesh_shape[0], args.y * mesh_shape[1],
                  args.z * mesh_shape[2])
    depths = _parse_depths(args.exchange_every)
    methods = methods_from_args(args)
    layouts = [t.strip() for t in args.wire_layout.split(",") if t.strip()]
    bad = [t for t in layouts if t not in WIRE_LAYOUTS]
    if not layouts or bad:
        raise SystemExit(f"--wire-layout wants a comma list from "
                         f"{WIRE_LAYOUTS}, got {args.wire_layout!r}")
    primary_layout = layouts[0]

    def jacobi_steps_per_s(s, layout=primary_layout, methods=methods):
        """Steps/s of the blocked hot path: the Jacobi model's run loop
        (deep exchange + sub-steps, the redundant ring compute included)
        under this configuration."""
        j = Jacobi3D(gx, gy, gz, mesh_shape=mesh_shape, devices=devices,
                     dtype=torch.float32, kernel="xla", methods=methods,
                     exchange_every=s if _depth_max(s) > 1 else None,
                     wire_layout=layout)
        j.init()
        n, dt, _ = grouped_steps_per_s(j.run, j.block, args.iters,
                                       group=_depth_max(s))
        return n, dt, j

    def make_domain(s, layout=primary_layout):
        dd = DistributedDomain(gx, gy, gz, devices=devices)
        dd.set_mesh_shape(mesh_shape)
        dd.set_radius(Radius.face_edge_corner(args.fr, args.er, args.cr))
        dd.set_methods(methods)
        dd.set_wire_layout(layout)
        if _depth_max(s) > 1:
            dd.set_exchange_every(s)
        for i in range(args.fields):
            dd.add_data(f"q{i}", torch.float32)
        dd.realize()
        return dd

    def exchange_trimean(dd):
        return timed_samples(
            dd.exchange,
            lambda: device_sync([t for v in dd.curr.values() for t in v
                                 if t is not None]),
            args.iters).trimean()

    results = []
    link_classes = None  # the first depth's classified link map
    for s in depths:
        dd = make_domain(s)
        tm = exchange_trimean(dd)
        per_ex = dd.exchange_bytes_total()
        _say(csv_line("bench_exchange", dd.methods, ndev,
                       args.x, args.y, args.z, args.fr, args.er, args.cr,
                       args.fields, _depth_label(s), per_ex,
                       f"{tm:.6e}", f"{per_ex / tm:.6e}"), flush=True)
        amortized = dd.exchange_bytes_amortized_per_step()
        if s == depths[0]:
            link_classes = _link_classes(dd, _depth_max(s), tm)
        del dd
        n, dt, j = jacobi_steps_per_s(s)
        xs = j.exchange_stats()
        row_extra = {}
        if isinstance(s, dict):
            d = j.dd.exchange_depths
            row_extra["depths"] = [d.x, d.y, d.z]
        del j
        results.append({
            "exchange_every": (s if isinstance(s, int)
                               else _depth_label(s)),
            **row_extra,
            "steps": n,
            "seconds": dt,
            "steps_per_s": n / dt,
            "exchange_rounds_per_step": xs["rounds_per_iteration"],
            "bytes_per_exchange_model": per_ex,
            "amortized_bytes_per_step_model": amortized,
            "jacobi_bytes_per_step_model": xs["bytes_per_iteration"],
            "trimean_exchange_s": tm,
        })
        _say(f"bench_exchange steps: s={_depth_label(s)} "
              f"steps/s={n / dt:.3f} (jacobi blocked loop) "
              f"rounds/step={xs['rounds_per_iteration']:.3f} "
              f"amortized={amortized:.0f}B/step (model)", file=sys.stderr)

    layout_cmp = None
    if len(layouts) > 1:
        # each further layout re-runs the smallest swept depth's two
        # measurements, as ratios against the sweep's first row; the
        # bytes ratio comes from the byte model, so it is exact
        base = results[0]
        s0 = depths[0]
        layout_cmp = {"baseline_layout": primary_layout,
                      "exchange_every": s0, "races": {}}
        for layout in layouts[1:]:
            dd = make_domain(s0, layout)
            tm = exchange_trimean(dd)
            per_ex = dd.exchange_bytes_total()
            del dd
            n, dt, _ = jacobi_steps_per_s(s0, layout)
            sps = n / dt
            bytes_ratio = per_ex / (base["bytes_per_exchange_model"] or 1)
            sps_ratio = sps / base["steps_per_s"]
            layout_cmp["races"][layout] = {
                "bytes_per_exchange_model": per_ex,
                "bytes_ratio": bytes_ratio,
                "trimean_exchange_s": tm,
                "exchange_s_ratio": tm / base["trimean_exchange_s"],
                "steps_per_s": sps,
                "steps_per_s_ratio": sps_ratio,
            }
            _say(csv_line("bench_exchange_layout", layout, primary_layout,
                           _depth_label(s0), per_ex, f"{tm:.6e}",
                           f"{bytes_ratio:.4f}", f"{sps_ratio:.3f}"),
                  flush=True)
            _say(f"bench_exchange layout: {layout} {per_ex}B/exchange "
                  f"({bytes_ratio:.3f}x {primary_layout} bytes) "
                  f"{sps:.3f} steps/s (x{sps_ratio:.2f} blocked loop)",
                  file=sys.stderr)

    autotune_cmp = None
    if args.autotune:
        # tune the Jacobi problem itself (radius 1, one float32 field),
        # then race the plan against Method.Default on the blocked loop
        from ..utils.profiling import autotune_report

        dd = DistributedDomain(gx, gy, gz, devices=devices)
        dd.set_mesh_shape(mesh_shape)
        dd.set_radius(1)
        dd.add_data("temp", torch.float32)
        plan = dd.autotune(cache_path=args.tune_cache or None)
        _say(autotune_report(plan), file=sys.stderr)
        del dd
        base_row = next((r for r in results if r["exchange_every"] == 1
                         and methods == Method.Default), None)
        if base_row is not None:
            base_sps = base_row["steps_per_s"]
        else:
            n, dt, _ = jacobi_steps_per_s(1, methods=Method.Default)
            base_sps = n / dt
        n, dt, _ = jacobi_steps_per_s(plan.config.exchange_every,
                                      methods=Method[plan.config.method])
        tuned_sps = n / dt
        autotune_cmp = {"plan": plan.to_record(),
                        "default_steps_per_s": base_sps,
                        "tuned_steps_per_s": tuned_sps,
                        "tuned_over_default": tuned_sps / base_sps}
        _say(csv_line("bench_exchange_autotune", plan.config.key(),
                      plan.provenance, f"{base_sps:.3f}",
                      f"{tuned_sps:.3f}", f"{tuned_sps / base_sps:.3f}"),
             flush=True)
        _say(f"bench_exchange autotune: tuned {plan.config.key()} "
             f"({plan.provenance}) {tuned_sps:.3f} steps/s vs default "
             f"{base_sps:.3f} steps/s (x{tuned_sps / base_sps:.2f})",
             file=sys.stderr)

    fused_cmp = None
    if args.fuse_segments:
        fused_cmp = _megastep_legs(args, next(
            as_global(d).device for d in devices
            if as_global(d).rank == rank))

    if args.json_out and rank == 0:
        base = results[0]
        results_by_s = {str(r["exchange_every"]): r for r in results}
        payload = {
            "bench": "bench_exchange",
            "mesh": list(mesh_shape),
            "per_device_size": [args.x, args.y, args.z],
            "radius": [args.fr, args.er, args.cr],
            "fields": args.fields,
            "configs": results,
            # ratios against the smallest swept depth: exchange rounds
            # per step drop exactly s-fold; steps/s includes the
            # redundant ring compute
            "baseline_exchange_every": base["exchange_every"],
            "rounds_per_step_ratio": {
                k: r["exchange_rounds_per_step"]
                / base["exchange_rounds_per_step"]
                for k, r in results_by_s.items()},
            "steps_per_s_ratio": {
                k: r["steps_per_s"] / base["steps_per_s"]
                for k, r in results_by_s.items()},
            "wire_layout": primary_layout,
        }
        if layout_cmp is not None:
            payload["wire_layout_race"] = layout_cmp
        if autotune_cmp is not None:
            payload["autotune"] = autotune_cmp
        if fused_cmp is not None:
            payload["fused"] = fused_cmp
        if link_classes is not None:
            payload["link_classes"] = link_classes
        emit_bench_artifacts(args, payload, "bench_exchange")
        _say(f"bench_exchange: wrote {args.json_out}", file=sys.stderr)
    if args.metrics_json and rank == 0:
        _write_metrics(args.metrics_json, results, autotune_cmp,
                       fused_cmp, link_classes)
        _say(f"bench_exchange: metrics snapshot -> {args.metrics_json}",
             file=sys.stderr)


def _link_classes(dd, s: int, exchange_s: float):
    """Per-(axis, link class) bytes a step, share and utilization of the
    fitted peak during the measured exchange of ``dd`` (JAX
    ``apps/bench_exchange.py:222-244``); None on one shard."""
    from ..observatory.linkmap import link_attribution_for

    link = link_attribution_for(dd)
    if link is None:
        return None
    total = sum(link["bytes_per_step"].values()) or 1.0
    return {f"{axis}/{klass}": {
                "bytes_per_step": b, "share": b / total,
                "utilization": (b * s / exchange_s)
                / link["peak_bytes_per_s"].get(axis, 1e30)}
            for (axis, klass), b in sorted(link["bytes_per_step"].items())}


def _write_metrics(path, results, autotune_cmp, fused_cmp,
                   link_classes) -> None:
    """JAX's bench gauges (``apps/bench_exchange.py:464-523``) in a
    telemetry snapshot, set from the same numbers as the JSON."""
    from ..observatory.linkmap import (METRIC_LINK_BYTES_PER_STEP,
                                       METRIC_LINK_UTILIZATION)
    from ..telemetry import MetricsRegistry

    reg = MetricsRegistry()
    g_sps = reg.gauge("stencil_bench_steps_per_s",
                      "measured steps/s of the blocked Jacobi loop, by "
                      "temporal depth")
    g_bps = reg.gauge("stencil_bench_bytes_per_step_model",
                      "amortized exchange B/step (analytic model)")
    for r in results:
        label = str(r["exchange_every"])
        g_sps.set(r["steps_per_s"], exchange_every=label)
        g_bps.set(r["amortized_bytes_per_step_model"], exchange_every=label)
    if autotune_cmp is not None:
        g = reg.gauge("stencil_bench_tuned_steps_per_s",
                      "steps/s of the measured tuned plan vs "
                      "Method.Default")
        g.set(autotune_cmp["tuned_steps_per_s"], config="tuned")
        g.set(autotune_cmp["default_steps_per_s"], config="default")
    if fused_cmp is not None:
        g = reg.gauge("stencil_bench_fused_steps_per_s",
                      "segment race: steps/s by dispatch mode (fused = one "
                      "segment per check_every steps with the probe rows "
                      "on the device; stepwise = one step and one probe "
                      "per step)")
        ck = str(fused_cmp["check_every"])
        g.set(fused_cmp["fused_steps_per_s"], mode="fused", check_every=ck)
        g.set(fused_cmp["stepwise_steps_per_s"], mode="stepwise",
              check_every=ck)
    if link_classes is not None:
        g_lb = reg.gauge(METRIC_LINK_BYTES_PER_STEP,
                         "modeled wire B/step per mesh axis and link class")
        g_lu = reg.gauge(METRIC_LINK_UTILIZATION,
                         "achieved/fitted-peak utilization per mesh axis "
                         "and link class")
        for key, row in link_classes.items():
            axis, klass = key.split("/")
            g_lb.set(row["bytes_per_step"], axis=axis, link_class=klass)
            g_lu.set(row["utilization"], axis=axis, link_class=klass)
    reg.write_snapshot(path)


def _megastep_legs(args, device) -> dict:
    """The three segment races on ``device`` (JAX
    ``apps/bench_exchange.py:335-415``): Jacobi ``xla``, PIC and
    Astaroth ``xla-temporal[s=2]`` at the per-shard size, ``n`` steps
    rounded down to whole segments."""
    import torch

    from ..models.astaroth import Astaroth
    from ..models.jacobi import Jacobi3D
    from ..models.pic import Pic
    from ..resilience.health import HealthSentinel

    k = max(args.check_every, 1)
    n = max(args.iters, k)
    n -= n % k
    ast_s = 2

    def leg(name, make_engine, make_sentinel, fields_fn, **extra):
        sps, fps, ratio = megastep_race(make_engine, make_sentinel,
                                        fields_fn, k, n)
        row = {"check_every": k, "steps": n,
               "stepwise_steps_per_s": sps, "fused_steps_per_s": fps,
               "fused_over_stepwise": ratio, **extra}
        _say(csv_line(f"bench_exchange_megastep_{name}", k, n,
                       f"{sps:.3f}", f"{fps:.3f}", f"{ratio:.3f}"),
              flush=True)
        _say(f"bench_exchange megastep[{name}]: segments[k={k}] "
              f"{fps:.3f} steps/s vs per-step loop {sps:.3f} steps/s "
              f"(x{ratio:.2f})", file=sys.stderr)
        return row

    def mk_jacobi():
        j = Jacobi3D(args.x, args.y, args.z, mesh_shape=(1, 1, 1),
                     devices=[device], dtype=torch.float32, kernel="xla",
                     methods=methods_from_args(args))
        j.init()
        return j

    def mk_pic():
        return Pic(args.x, args.y, args.z, 256, mesh_shape=(1, 1, 1),
                   devices=[device], dtype=torch.float32,
                   deposition="cic")

    def mk_astaroth():
        a = Astaroth(args.x, args.y, args.z, mesh_shape=(1, 1, 1),
                     devices=[device], dtype=torch.float32, kernel="xla",
                     exchange_every=ast_s)
        a.init()
        return a

    fused = leg("jacobi", mk_jacobi, lambda e: HealthSentinel(e.dd),
                lambda e: e.dd.curr)
    fused["pic"] = leg("pic", mk_pic, lambda e: e.make_sentinel(),
                       lambda e: e.state)
    fused["astaroth_temporal"] = leg(
        "astaroth", mk_astaroth, lambda e: HealthSentinel(e.dd),
        lambda e: e.dd.curr, exchange_every=ast_s)
    _say(csv_line("bench_exchange_megastep", k, n,
                   f"{fused['stepwise_steps_per_s']:.3f}",
                   f"{fused['fused_steps_per_s']:.3f}",
                   f"{fused['fused_over_stepwise']:.3f}"), flush=True)
    return fused


if __name__ == "__main__":
    main()
