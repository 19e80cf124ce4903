"""``python -m stencil_tpu_torch.tune`` — the exchange autotuner CLI.

PyTorch-port counterpart of ``stencil_tpu/tune.py``: tunes an exchange
plan for a described problem (grid, radius, quantities, mesh) on the
given devices and stores it in the plan cache, so that later runs — or
a whole fleet pointed at one file through ``$STENCIL_TUNE_CACHE`` —
start with a cache hit. ``--fake-timer`` runs the whole search, fit and
cache on the analytic model, with no timing at all.

Examples::

    # tune a 512^3 one-field problem on four shards of one card
    python -m stencil_tpu_torch.tune --x 512 --y 512 --z 512 \\
        --devices cuda:0,cuda:0,cuda:0,cuda:0 --mesh-shape 1,2,2

    # deterministic, on the CPU: fake timer, scratch cache
    python -m stencil_tpu_torch.tune --x 64 --y 64 --z 64 \\
        --devices cpu,cpu,cpu,cpu --fake-timer --cache /tmp/plans.json \\
        --json plan.json

The devices default to every visible card; with none the command
raises, as every entry point of the port does.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _parse_ints(text: str) -> List[int]:
    return [int(t) for t in text.split(",") if t.strip()]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m stencil_tpu_torch.tune",
        description="Measurement-driven halo-exchange autotuner: "
                    "measure -> fit -> plan -> cache.")
    ap.add_argument("--x", type=int, default=128, help="global x size")
    ap.add_argument("--y", type=int, default=128)
    ap.add_argument("--z", type=int, default=128)
    ap.add_argument("--fr", type=int, default=1, help="face radius")
    ap.add_argument("--er", type=int, default=1, help="edge radius")
    ap.add_argument("--cr", type=int, default=1, help="corner radius")
    ap.add_argument("--fields", type=int, default=1,
                    help="number of quantities")
    ap.add_argument("--dtype", default="float32",
                    help="quantity dtype (float32, float64, bfloat16)")
    ap.add_argument("--mesh-shape", default="", metavar="MX,MY,MZ",
                    help="explicit subdomain grid (default: derived)")
    ap.add_argument("--depths", default="1,2,4,8", metavar="S[,S...]",
                    help="temporal-blocking depths to sweep")
    ap.add_argument("--max-measure", type=int, default=4,
                    help="timing runs after cost-model pruning")
    ap.add_argument("--cache", default="", metavar="PATH",
                    help="plan cache file (default: $STENCIL_TUNE_CACHE "
                         "or ~/.cache/stencil_tpu_torch/plans.json)")
    ap.add_argument("--no-cache", action="store_true",
                    help="neither read nor write the plan cache")
    ap.add_argument("--force", action="store_true",
                    help="ignore a cached plan; re-measure and rewrite")
    ap.add_argument("--fake-timer", action="store_true",
                    help="deterministic analytic measurements (no "
                         "timing; exercises the full search)")
    ap.add_argument("--topology", default="", metavar="PATH",
                    help="measured topology-fingerprint file "
                         "(observatory/linkmap.py): per-axis link "
                         "calibrations measured once and reused instead "
                         "of the ring-shift fit (default: "
                         "$STENCIL_TOPOLOGY_CACHE when set)")
    ap.add_argument("--json", default="", metavar="PATH",
                    help="write the tuned plan record as JSON")
    ap.add_argument("--devices", default=None,
                    help="comma list of torch devices, one per mesh "
                         "position (repeats allowed; cpu,cpu,... runs on "
                         "the host)")
    ap.add_argument("--device", default=None,
                    help="one torch device for every mesh position")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from .distributed import DistributedDomain, torch_dtype
    from .geometry import Radius
    from .tuning import FakeTimer
    from .utils.profiling import autotune_report

    devices = (args.devices.split(",") if args.devices else None)
    dd = DistributedDomain(args.x, args.y, args.z, device=args.device,
                           devices=devices)
    dd.set_radius(Radius.face_edge_corner(args.fr, args.er, args.cr))
    if args.mesh_shape:
        dd.set_mesh_shape(tuple(_parse_ints(args.mesh_shape)))
    for i in range(args.fields):
        dd.add_data(f"q{i}", torch_dtype(args.dtype))

    plan = dd.autotune(timer=FakeTimer() if args.fake_timer else None,
                       use_cache=not args.no_cache, force=args.force,
                       cache_path=args.cache or None,
                       max_measurements=args.max_measure,
                       depths=tuple(_parse_ints(args.depths)),
                       topology_path=args.topology or None)
    print(autotune_report(plan))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(plan.to_record(), f, indent=2, sort_keys=True)
        print(f"tune: wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
