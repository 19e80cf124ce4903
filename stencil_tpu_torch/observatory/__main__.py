"""CLI entry: ``python -m stencil_tpu_torch.observatory``.

PyTorch-port counterpart of ``stencil_tpu/observatory/__main__.py``.
Subcommands (all read or write files; none touches a card):

* ``validate PATH``  — schema-check a bench ledger (JSONL, or a single
  record / array of records) or a flight-recorder dump (told apart by
  shape); nonzero exit on problems.
* ``backfill --out LEDGER FILES...`` — convert the bench payloads it is
  given into ledger records with provenance ``legacy`` (unusable runs
  are reported as skipped), appended to ``--out`` in argument order.
* ``diff A [B]``     — metric-by-metric comparison: with one ledger,
  the two newest records of the newest record's (fingerprint, bench)
  group; with two paths, the last record of each.
* ``gate LEDGER``    — within every (fingerprint, bench) group of
  ``measured`` records the newest steps/s may not drop more than
  ``--threshold`` below the best earlier one; nonzero exit on any
  regression. An empty ledger passes with an explicit note;
  ``--min-groups N`` fails when fewer groups were compared.
* ``linkmap``        — the modeled per-(src, dst) traffic matrix, its
  link-class and direction-class shares, and (``--placement-report``)
  the QAP placement-quality gate over every registered mesh.
* ``replay DUMP``    — a flight-recorder dump's merged incident
  timeline (events, probes, spans).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _load_any(path: str):
    """(kind, payload): 'dump' | 'records'. A ledger is JSONL or a
    JSON array / single record; a flight dump is one JSON object with
    kind == flight_recorder."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        payload = json.loads(text)
    except ValueError:
        from .ledger import read_ledger
        return "records", read_ledger(path)
    if isinstance(payload, dict):
        if payload.get("kind") == "flight_recorder":
            return "dump", payload
        return "records", [payload]
    if isinstance(payload, list):
        return "records", payload
    raise ValueError(f"{path}: neither ledger records nor a flight dump")


def _print_diff(diff: dict) -> None:
    a_b, a_f = diff["bench"], diff["fingerprint"]
    print(f"diff: {a_b[0]} [{(a_f[0] or '?')[:12]}] -> "
          f"{a_b[1]} [{(a_f[1] or '?')[:12]}] "
          f"(provenance {diff['provenance'][0]} -> "
          f"{diff['provenance'][1]})")
    if not diff["comparable"]:
        print("  NOTE: records key different trajectories "
              "(bench/fingerprint differ) — ratios are apples/oranges")
    for name, row in diff["metrics"].items():
        ratio = row.get("ratio")
        tail = f"  (x{ratio:.3f})" if ratio is not None else ""
        print(f"  {name:<34} {row['a']!r:>16} -> {row['b']!r:>16}{tail}")


def _parse_dim3(text: str, what: str):
    toks = [int(t) for t in text.replace("x", ",").split(",") if t]
    if len(toks) != 3 or any(v < 1 for v in toks):
        raise SystemExit(f"--{what} wants three positive integers, "
                         f"got {text!r}")
    return tuple(toks)


def _parse_exchange_every(text: str):
    """``--exchange-every``: one integer (uniform depth), or
    ``axis=value`` tokens (``z=4,y=1,x=1``) normalized to a per-axis
    ``Dim3`` depth vector — the same syntax the bench CLI sweeps."""
    toks = [t for t in (t.strip() for t in str(text).split(",")) if t]
    axes = {}
    for t in toks:
        if "=" not in t:
            continue
        k, v = t.split("=", 1)
        k = k.strip().lower()
        if k not in ("x", "y", "z") or int(v) < 1:
            raise SystemExit(f"--exchange-every axis token wants "
                             f"x=/y=/z= with depth >= 1, got {t!r}")
        axes[k] = int(v)
    if axes:
        if len(axes) != len(toks):
            raise SystemExit(f"--exchange-every mixes axis tokens and "
                             f"bare integers: {text!r}")
        from ..geometry import normalize_depths
        return normalize_depths(axes)
    try:
        return max(int(toks[0]), 1) if toks else 1
    except ValueError:
        raise SystemExit(f"--exchange-every wants an integer or "
                         f"axis=value tokens, got {text!r}")


def _cmd_linkmap(args) -> int:
    """The ``linkmap`` subcommand: modeled traffic matrix + link-class
    summary, and the placement-quality QAP gate (artifact-facing —
    pure geometry/placement math, no accelerators touched)."""
    from ..geometry import Dim3, Radius
    from .linkmap import (REGISTERED_MESHES, classify, method_traffic,
                          placement_report, render_heatmap,
                          render_summary)

    counts = Dim3(*_parse_dim3(args.mesh, "mesh"))
    grid = (_parse_dim3(args.grid, "grid") if args.grid
            else tuple(8 * c for c in counts))
    if any(g % c for g, c in zip(grid, counts)):
        # this capacity-shard model cannot represent +-1 uneven
        # shards; a silently floor-divided grid would make the
        # rendered artifact misstate the stated configuration
        raise SystemExit(f"--grid {grid} is not divisible by --mesh "
                         f"{tuple(counts)}; pick a divisible grid")
    shard = tuple(g // c for g, c in zip(grid, counts))
    radius = Radius.constant(args.radius)
    elem_sizes = (4,) * max(int(args.fields), 1)
    dcn_axis = ({"x": 0, "y": 1, "z": 2}[args.dcn_axis]
                if args.dcn_axis else None)
    depths = _parse_exchange_every(args.exchange_every)
    uniform = isinstance(depths, int)
    s = depths if uniform else max(depths)
    s_label = (s if uniform
               else f"{depths.x}.{depths.y}.{depths.z}")
    tm = method_traffic(args.method, (shard[2], shard[1], shard[0]),
                        radius, counts, elem_sizes, steps=depths)
    summary = classify(tm, dcn_axis=dcn_axis,
                       n_slices=int(args.n_slices),
                       rounds_per_step=1.0 / s)
    print(f"linkmap: {args.method}[s={s_label}] on mesh "
          f"{counts.x}x{counts.y}x{counts.z}, grid {grid}, radius "
          f"{args.radius}, {args.fields} f32 field(s)")
    print(render_heatmap(tm))
    print(render_summary(summary))

    payload = {"schema": 1, "kind": "linkmap",
               "method": args.method, "exchange_every": s_label,
               "mesh": list(counts), "grid": list(grid),
               "radius": int(args.radius), "fields": int(args.fields),
               "matrix": tm.matrix().tolist(),
               "summary": summary.to_record()}
    rc = 0
    if args.placement_report:
        report = placement_report(REGISTERED_MESHES, radius=radius,
                                  elem_sizes=elem_sizes)
        payload["placement_report"] = report
        for row in report["meshes"]:
            verdict = "OK " if row["ok"] else "FAIL"
            print(f"  {verdict} placement {row['name']:<10} "
                  f"qap/trivial x{row['qap_over_trivial']:.3f} "
                  f"(trivial {row['trivial_cost']:.3e}, qap "
                  f"{row['qap_cost']:.3e}, deployed "
                  f"{row['deployed_cost']:.3e}"
                  + (f", dcn {row['dcn_axis']}x{row['n_slices']}"
                     if row["dcn_axis"] else "") + ")")
        if report["ok"]:
            print(f"observatory: placement gate OK — QAP and "
                  f"deployed (auto-mode) placement cost <= trivial on "
                  f"all {len(report['meshes'])} registered meshes")
        else:
            bad = [r["name"] for r in report["meshes"] if not r["ok"]]
            print(f"observatory: placement gate FAILED on {bad} — "
                  f"the QAP or deployed placement would move MORE "
                  f"modeled bytes than trivial device order")
            rc = 1
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=1)
        print(f"observatory: linkmap artifact -> {args.json}")
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m stencil_tpu_torch.observatory",
        description="performance observatory tools: validate bench "
                    "ledgers and flight-recorder dumps, convert bench "
                    "payloads, diff records, gate regressions, replay "
                    "incidents")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_val = sub.add_parser("validate", help="schema-check a ledger or "
                                            "flight dump")
    p_val.add_argument("path")

    p_bf = sub.add_parser("backfill", help="convert bench payload JSON "
                                           "files into ledger records")
    p_bf.add_argument("files", nargs="+")
    p_bf.add_argument("--out", required=True, metavar="LEDGER",
                      help="ledger JSONL to append the records to")

    p_diff = sub.add_parser("diff", help="compare two bench records")
    p_diff.add_argument("a")
    p_diff.add_argument("b", nargs="?", default=None)
    p_diff.add_argument("--bench", default=None,
                        help="single-ledger mode: diff this bench's "
                             "newest group instead of the newest "
                             "record's (glob; literal [ ] in bench "
                             "ids are matched as-is)")

    p_gate = sub.add_parser("gate", help="fail on same-fingerprint "
                                         "steps/s regressions")
    p_gate.add_argument("ledger")
    p_gate.add_argument("--threshold", type=float, default=0.2,
                        help="max tolerated relative steps/s drop "
                             "(default 0.2)")
    p_gate.add_argument("--bench", default=None,
                        help="gate only matching bench ids (glob; "
                             "literal [ ] in bench ids are matched "
                             "as-is)")
    p_gate.add_argument("--include-legacy", action="store_true",
                        help="also gate provenance=legacy records")
    p_gate.add_argument("--json", default=None, metavar="PATH",
                        help="write the gate verdict (records, "
                             "groups_checked, failures) as a JSON "
                             "artifact")
    p_gate.add_argument("--min-groups", type=int, default=0,
                        metavar="N",
                        help="fail when fewer than N comparable "
                             "(fingerprint, bench) groups were "
                             "actually gated — the committed coverage "
                             "floor that makes a vacuous pass loud")

    p_lm = sub.add_parser("linkmap",
                          help="render the modeled per-link traffic "
                               "matrix / placement-quality report")
    p_lm.add_argument("--mesh", default="2,2,2", metavar="X,Y,Z",
                      help="shard lattice (device counts per axis; "
                           "default 2,2,2)")
    p_lm.add_argument("--grid", default=None, metavar="X,Y,Z",
                      help="global grid (default 8 cells per shard "
                           "per axis)")
    p_lm.add_argument("--radius", type=int, default=1)
    p_lm.add_argument("--fields", type=int, default=1,
                      help="f32 quantities riding the exchange")
    p_lm.add_argument("--method", default="PpermuteSlab",
                      choices=("PpermuteSlab", "PpermutePacked",
                               "PallasDMA", "AllGather"))
    p_lm.add_argument("--exchange-every", default="1",
                      metavar="S|z=4,y=1,x=1",
                      help="temporal-blocking depth: one integer, or "
                           "axis=value tokens for per-axis asymmetric "
                           "depths")
    p_lm.add_argument("--dcn-axis", default=None,
                      choices=("x", "y", "z"),
                      help="slice-blocked axis (classifies its "
                           "slice-crossing edges as dcn)")
    p_lm.add_argument("--n-slices", type=int, default=1)
    p_lm.add_argument("--placement-report", action="store_true",
                      help="score QAP vs trivial placement over every "
                           "registered mesh; nonzero exit when QAP "
                           "placement would lose anywhere")
    p_lm.add_argument("--json", default=None, metavar="PATH",
                      help="write the linkmap / placement report as a "
                           "JSON artifact")

    p_rep = sub.add_parser("replay", help="render a flight dump's "
                                          "incident timeline")
    p_rep.add_argument("dump")

    args = parser.parse_args(argv)

    if args.cmd == "validate":
        from .ledger import validate_ledger
        from .recorder import validate_dump
        try:
            kind, payload = _load_any(args.path)
        except (OSError, ValueError) as e:
            print(f"observatory: cannot load {args.path}: {e}",
                  file=sys.stderr)
            return 2
        problems = (validate_dump(payload) if kind == "dump"
                    else validate_ledger(payload))
        for p in problems:
            print(f"  BAD  {p}")
        if problems:
            print(f"observatory: {kind} {args.path}: "
                  f"{len(problems)} problem(s)")
            return 1
        n = len(payload["events"]) if kind == "dump" else len(payload)
        what = ("flight dump" if kind == "dump"
                else f"ledger ({n} record(s))")
        print(f"observatory: {args.path} OK ({what})")
        return 0

    if args.cmd == "backfill":
        from .ledger import append_record, backfill_files
        try:
            records, skipped = backfill_files(args.files)
        except (OSError, ValueError, KeyError) as e:
            print(f"observatory: backfill failed: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            return 2
        for rec in records:
            append_record(args.out, rec)
        for s in skipped:
            print(f"  SKIP {s}")
        print(f"observatory: backfilled {len(records)} record(s) from "
              f"{len(args.files)} file(s) into {args.out}"
              + (f" ({len(skipped)} skipped)" if skipped else ""))
        return 0

    if args.cmd == "diff":
        from .ledger import diff_records, group_records
        try:
            _, recs_a = _load_any(args.a)
        except (OSError, ValueError) as e:
            print(f"observatory: cannot load {args.a}: {e}",
                  file=sys.stderr)
            return 2
        if args.b is not None:
            try:
                _, recs_b = _load_any(args.b)
            except (OSError, ValueError) as e:
                print(f"observatory: cannot load {args.b}: {e}",
                      file=sys.stderr)
                return 2
            if not recs_a or not recs_b:
                print("observatory: nothing to diff", file=sys.stderr)
                return 2
            _print_diff(diff_records(recs_a[-1], recs_b[-1]))
            return 0
        groups = group_records(recs_a)
        if args.bench is not None:
            from ..utils.naming import glob_match
            groups = {k: g for k, g in groups.items()
                      if glob_match(str(k[1]), args.bench)}
        pairs = [g for g in groups.values() if len(g) >= 2]
        if not pairs:
            # an empty/group-less ledger is not an error — but it must
            # be LOUD that nothing was compared, never a silent pass
            print(f"observatory: no measured trajectory to diff in "
                  f"{args.a} ({len(recs_a)} record(s), "
                  f"{len(groups)} group(s), none with two records)")
            return 0
        # the group whose newest record is newest overall
        group = max(pairs, key=lambda g: g[-1].get("created", 0.0))
        _print_diff(diff_records(group[-2], group[-1]))
        return 0

    if args.cmd == "gate":
        from .ledger import (PROVENANCES, gate_groups_checked,
                             gate_regressions, read_ledger,
                             validate_ledger)
        try:
            records = read_ledger(args.ledger)
        except (OSError, ValueError) as e:
            # an EMPTY ledger is "no measured trajectory"; a MISSING
            # or unreadable path is a usage error — exiting 0 there
            # would be the vacuous-pass-on-typo this command exists
            # to make loud
            print(f"observatory: cannot load {args.ledger}: {e}",
                  file=sys.stderr)
            return 2
        problems = validate_ledger(records)
        if problems:
            for p in problems:
                print(f"  BAD  {p}")
            print(f"observatory: ledger {args.ledger} is invalid — "
                  f"fix it before gating")
            return 2
        prov = PROVENANCES if args.include_legacy else ("measured",)
        failures = gate_regressions(records,
                                    threshold=args.threshold,
                                    provenances=prov, bench=args.bench)
        groups_checked = gate_groups_checked(records, provenances=prov,
                                             bench=args.bench)
        if args.json:
            with open(args.json, "w", encoding="utf-8") as fh:
                json.dump({"schema": 1, "kind": "ledger_gate",
                           "ledger": args.ledger,
                           "records": len(records),
                           "groups_checked": groups_checked,
                           "min_groups": args.min_groups,
                           "threshold": args.threshold,
                           "failures": failures}, fh, indent=1)
        for f in failures:
            print(f"  REGRESSION  {f}")
        if failures:
            print(f"observatory: gate FAILED "
                  f"({len(failures)} regression(s), "
                  f"{groups_checked} group(s) checked)")
            return 1
        if groups_checked < args.min_groups:
            print(f"observatory: gate FAILED — only {groups_checked} "
                  f"comparable group(s) gated, below the committed "
                  f"floor of {args.min_groups} (coverage regressed: "
                  f"benches stopped appending, or the ledger path is "
                  f"wrong)")
            return 1
        if groups_checked == 0:
            # exit 0, but LOUDLY distinguishable from a healthy gate:
            # nothing was compared, so nothing was proven
            print(f"observatory: gate OK — no measured trajectory to "
                  f"gate ({len(records)} record(s), 0 comparable "
                  f"groups; the gate proved nothing)")
            return 0
        print(f"observatory: gate OK ({len(records)} record(s), "
              f"{groups_checked} group(s) checked, "
              f"threshold {100 * args.threshold:.0f}%)")
        return 0

    if args.cmd == "linkmap":
        return _cmd_linkmap(args)

    # replay
    from .recorder import render_timeline, validate_dump
    problems = validate_dump(args.dump)
    if problems:
        for p in problems:
            print(f"  BAD  {p}")
        print(f"observatory: dump {args.dump}: "
              f"{len(problems)} problem(s)")
        return 1
    sys.stdout.write(render_timeline(args.dump))
    return 0


if __name__ == "__main__":
    sys.exit(main())
