"""CLI entry: ``python -m stencil_tpu_torch.analysis``.

The port's counterpart of ``stencil_tpu/analysis/__main__.py``. Exit
status: 0 when every checked invariant holds, 1 when any error-severity
finding exists, 2 on a usage error. ``--json PATH`` writes the report
(schema in ``report.py``). ``--only NAME`` restricts the run to one
checker when NAME is a checker name, or to the registry targets
matching NAME as a glob otherwise (``--only 'serving.*'``); repeatable,
and the two forms compose (checker filter AND target filter); a glob
that matches nothing, or filters that select nothing together, is a
usage error. ``--list`` prints the checkers and the registry's target
counts per group. Positional arguments are fixture files (defining
``TARGETS``) checked instead of the registry: the negative controls
under ``tests/fixtures/torch_lint/``, on each of which the CLI must exit
nonzero. ``--plan-tiling GLOB`` prints the port's launch plans (shared
memory, blocks an SM, z run, tiles) of the ``analysis.tiling.*``
targets matching GLOB. The ``cuda.`` targets run where an sm_90 card
is, and are skipped (with a metric saying why) elsewhere.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..utils.naming import glob_match as _match


def main(argv: Optional[List[str]] = None) -> int:
    from . import CHECKER_DOC, CHECKERS

    parser = argparse.ArgumentParser(
        prog="python -m stencil_tpu_torch.analysis",
        description="stencil-lint for the PyTorch port: footprint / "
                    "remote-store ordering / message pairing / "
                    "point-to-point only / byte model / Hopper budgets / "
                    "donation / host syncs / rebuilds / launch plans / "
                    "link matrix / schedule certificates / dtype flow")
    parser.add_argument("fixtures", nargs="*",
                        help="fixture files (defining TARGETS) to check "
                             "instead of the registry")
    parser.add_argument("--json", metavar="PATH",
                        help="write the JSON report here")
    parser.add_argument("--only", "--checker", action="append",
                        dest="only", metavar="CHECKER|GLOB",
                        help="run only this checker (a checker name) or "
                             "only the targets matching this glob "
                             "(repeatable; the forms compose)")
    parser.add_argument("--list", action="store_true", dest="list_",
                        help="list the checkers and the registry's target "
                             "counts per group, then exit")
    parser.add_argument("--plan-tiling", metavar="GLOB",
                        dest="plan_tiling",
                        help="print the launch plans of the "
                             "analysis.tiling.* targets matching GLOB "
                             "(--json writes them instead of findings)")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="suppress the per-target OK lines")
    args = parser.parse_args(argv)

    if args.list_:
        for name in CHECKERS:
            print(f"  {name:<12} {CHECKER_DOC[name]}")
        from .registry import NO_COUNTERPART, default_targets

        targets = default_targets()
        groups: dict = {}
        for t in targets:
            g = t.name.split(".", 1)[0]
            groups.setdefault(g, {})
            groups[g][t.checker] = groups[g].get(t.checker, 0) + 1
        print(f"\n  {len(targets)} registry targets by group:")
        for g in sorted(groups):
            per = " ".join(f"{c}={n}"
                           for c, n in sorted(groups[g].items()))
            print(f"    {g:<12} {sum(groups[g].values()):>3}  ({per})")
        print(f"\n  {len(NO_COUNTERPART)} JAX targets without a "
              f"counterpart (registry.NO_COUNTERPART)")
        return 0

    checkers = [v for v in (args.only or []) if v in CHECKERS]
    patterns = [v for v in (args.only or []) if v not in CHECKERS]

    if args.plan_tiling:
        from .registry import default_targets
        from .tiling import plan_tiling_report, render_plan_table

        tiling = [t for t in default_targets(card=False)
                  if t.name.startswith("analysis.tiling.")]
        chosen = [t for t in tiling
                  if _match(t.name, args.plan_tiling)
                  or _match(t.name.replace("analysis.tiling.", "", 1),
                            args.plan_tiling)]
        if not chosen:
            print(f"stencil-lint: no tiling targets match "
                  f"{args.plan_tiling!r} ({len(tiling)} registered under "
                  f"analysis.tiling.*)", file=sys.stderr)
            return 2
        rows = plan_tiling_report(chosen)
        print(render_plan_table(rows))
        if args.json:
            with open(args.json, "w", encoding="utf-8") as fh:
                json.dump({"tool": "stencil-lint", "mode": "plan-tiling",
                           "plans": rows}, fh, indent=2)
            print(f"stencil-lint: tiling plan report written to "
                  f"{args.json}")
        return 0

    from . import run_targets
    from .registry import default_targets, load_targets

    try:
        if args.fixtures:
            targets = []
            for path in args.fixtures:
                targets.extend(load_targets(path))
        else:
            targets = default_targets()
    except (ImportError, ValueError, OSError) as e:
        print(f"stencil-lint: cannot load targets: {e}", file=sys.stderr)
        return 2

    if patterns:
        # every pattern must match something: a mistyped glob among
        # several must fail the run, not drop its coverage
        unmatched = [p for p in patterns
                     if not any(_match(t.name, p) for t in targets)]
        if unmatched:
            print(f"stencil-lint: no targets match {unmatched} (values "
                  f"that are not checker names filter target names by "
                  f"glob)", file=sys.stderr)
            return 2
        targets = [t for t in targets
                   if any(_match(t.name, p) for p in patterns)]
    if checkers and not any(t.checker in checkers for t in targets):
        # a checker filter and a glob that meet nowhere would be a
        # vacuously green run
        print(f"stencil-lint: the --only filters select no targets "
              f"(checkers {checkers} x {len(targets)} matched "
              f"target(s))", file=sys.stderr)
        return 2

    report = run_targets(targets, checkers=checkers or None)

    if not args.quiet:
        flagged = {f.target.split(":", 1)[0] for f in report.findings}
        for name in report.targets_checked:
            if name not in flagged:
                print(f"  OK   {name}")
    for f in report.findings:
        tag = "ERROR" if f.severity == "error" else "warn "
        print(f"  {tag} {f}")
    n_err, n_warn = len(report.errors), len(report.warnings)
    skipped = sum("skipped" in m for m in report.metrics.values())
    timing = " ".join(f"{k}={v:.2f}s"
                      for k, v in sorted(report.checker_seconds.items()))
    print(f"stencil-lint: {len(report.targets_checked)} targets, "
          f"{n_err} error(s), {n_warn} warning(s)"
          + (f", {skipped} skipped (no sm_90 card)" if skipped else "")
          + (f" [{timing}]" if timing else ""))

    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            fh.write(report.to_json())
        print(f"stencil-lint: JSON report written to {args.json}")

    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
