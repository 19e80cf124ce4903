"""CLI entry: ``python -m stencil_tpu_torch.telemetry``.

PyTorch-port counterpart of ``stencil_tpu/telemetry/__main__.py``.
Subcommands (all read files; none touches a card):

* ``snapshot PATH``        — render a metrics snapshot JSON (the
  ``--metrics-json`` artifact) as Prometheus text; ``--json`` re-dumps
  it, schema-checked.
* ``validate-trace PATH``  — structural validation of a Chrome
  trace-event JSON export (``Tracer.export_chrome_trace``) against the
  format Perfetto loads; nonzero exit on problems.
* ``validate-events PATH`` — schema-check a unified event log: a JSON
  payload with an ``events`` array (a ``ResilienceReport``), a bare
  array, or JSONL; nonzero exit on problems.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _load_events(path: str) -> List[dict]:
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        payload = json.loads(text)
    except ValueError:
        # JSONL: one record per line
        return [json.loads(line) for line in text.splitlines() if line]
    if isinstance(payload, dict):
        events = payload.get("events")
        if isinstance(events, list):
            return events
        if "event" in payload:
            # a one-line JSONL file parses as a single record dict
            return [payload]
        raise ValueError(f"{path}: no 'events' array in payload")
    if isinstance(payload, list):
        return payload
    raise ValueError(f"{path}: neither an event array nor a payload")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m stencil_tpu_torch.telemetry",
        description="telemetry artifact tools: render metrics "
                    "snapshots, validate Perfetto traces and unified "
                    "event logs")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_snap = sub.add_parser("snapshot",
                            help="render a metrics snapshot JSON")
    p_snap.add_argument("path")
    p_snap.add_argument("--json", action="store_true",
                        help="re-dump the (schema-checked) snapshot "
                             "instead of rendering text")

    p_tr = sub.add_parser("validate-trace",
                          help="validate a Chrome trace-event export")
    p_tr.add_argument("path")

    p_ev = sub.add_parser("validate-events",
                          help="schema-check a unified event log")
    p_ev.add_argument("path")

    args = parser.parse_args(argv)

    if args.cmd == "snapshot":
        from .metrics import METRICS_SCHEMA_VERSION, render_snapshot_text

        try:
            with open(args.path, encoding="utf-8") as f:
                snap = json.load(f)
        except (OSError, ValueError) as e:
            print(f"telemetry: cannot load snapshot: {e}",
                  file=sys.stderr)
            return 2
        if snap.get("schema") != METRICS_SCHEMA_VERSION:
            print(f"telemetry: snapshot schema {snap.get('schema')!r} "
                  f"!= {METRICS_SCHEMA_VERSION}", file=sys.stderr)
            return 1
        if args.json:
            json.dump(snap, sys.stdout, indent=1)
            print()
        else:
            sys.stdout.write(render_snapshot_text(snap))
        return 0

    if args.cmd == "validate-trace":
        from .spans import validate_chrome_trace

        problems = validate_chrome_trace(args.path)
        for p in problems:
            print(f"  BAD  {p}")
        if problems:
            print(f"telemetry: trace {args.path}: "
                  f"{len(problems)} problem(s)")
            return 1
        with open(args.path, encoding="utf-8") as f:
            n = len(json.load(f).get("traceEvents", []))
        print(f"telemetry: trace {args.path} OK ({n} events)")
        return 0

    # validate-events
    from .events import validate_events

    try:
        events = _load_events(args.path)
    except (OSError, ValueError) as e:
        print(f"telemetry: cannot load events: {e}", file=sys.stderr)
        return 2
    problems = validate_events(events)
    for p in problems:
        print(f"  BAD  {p}")
    if problems:
        print(f"telemetry: events {args.path}: "
              f"{len(problems)} problem(s)")
        return 1
    runs = {e.get("run") for e in events}
    print(f"telemetry: events {args.path} OK ({len(events)} records, "
          f"{len(runs)} run(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
