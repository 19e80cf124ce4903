"""The bench trajectory ledger: one versioned record schema, appended.

PyTorch-port counterpart of ``stencil_tpu/observatory/ledger.py``; the
records are JAX's schema 1:

``{"schema": 1, "bench": <id>, "fingerprint": <hex>, "created": <unix
s>, "provenance": "measured"|"legacy", "source": <who wrote it>,
"config": {...}, "metrics": {"steps_per_s": <float>, ...}}``

* ``bench`` + ``fingerprint`` key a trajectory: records sharing both
  measured the same problem (the tuning fingerprint when the bench
  carries one, else :func:`config_fingerprint` of the bench id and
  config), so steps/s compares within a group and not across groups.
* ``metrics["steps_per_s"]`` is the mandatory headline (> 0).
* ``provenance`` separates live measurements from converted older
  payloads: :func:`gate_regressions` gates ``measured`` records only by
  default.

The file is append-only JSONL, flushed per record. Where the port's
apps append (``--ledger``): the path given, else
``$STENCIL_BENCH_LEDGER``, else :func:`default_ledger_path`
(``~/.cache/stencil_tpu_torch/ledger.jsonl``) — never the JAX package's
``bench/`` folder. ``python -m stencil_tpu_torch.observatory`` is the
CLI: ``validate`` / ``backfill`` / ``diff`` / ``gate``.
"""

from __future__ import annotations

import json
import math
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

#: bump when a record key changes meaning; the validator keys on this
LEDGER_SCHEMA_VERSION = 1

PROVENANCES = ("measured", "legacy")

#: the mandatory headline metric every record carries
HEADLINE_METRIC = "steps_per_s"

#: names the ledger the apps append to when ``--ledger`` is not given
ENV_LEDGER = "STENCIL_BENCH_LEDGER"


def default_ledger_path() -> Path:
    """``~/.cache/stencil_tpu_torch/ledger.jsonl``: outside the
    checkout, so that the JAX era's ``bench/`` folder stays as it is."""
    return Path(os.path.expanduser(
        "~/.cache/stencil_tpu_torch/ledger.jsonl"))


def config_fingerprint(bench: str, config: Dict) -> str:
    """Stable hash of the bench id + its configuration — the record
    key when no tuning fingerprint exists, hashed as the tuner hashes
    (``tuning/plan.fingerprint``)."""
    from ..tuning.plan import fingerprint
    return fingerprint({"bench": str(bench), "config": config})


def make_record(bench: str, config: Dict, metrics: Dict,
                provenance: str = "measured",
                fingerprint: Optional[str] = None,
                source: Optional[str] = None,
                created: Optional[float] = None) -> Dict:
    """A schema-v1 ledger record (validated — raises ``ValueError`` on
    a malformed one so bad records die at the producer, not in some
    later consumer's gate)."""
    rec = {
        "schema": LEDGER_SCHEMA_VERSION,
        "bench": str(bench),
        "fingerprint": (str(fingerprint) if fingerprint
                        else config_fingerprint(bench, config)),
        "created": float(created if created is not None else time.time()),
        "provenance": str(provenance),
        "source": str(source or ""),
        "config": dict(config),
        "metrics": dict(metrics),
    }
    problems = validate_record(rec)
    if problems:
        raise ValueError(f"invalid ledger record for bench {bench!r}: "
                         f"{problems}")
    return rec


def validate_record(rec) -> List[str]:
    """Schema-check one record; returns human-readable problems
    (empty = valid)."""
    problems: List[str] = []
    if not isinstance(rec, dict):
        return ["record is not an object"]
    if rec.get("schema") != LEDGER_SCHEMA_VERSION:
        problems.append(f"schema {rec.get('schema')!r} != "
                        f"{LEDGER_SCHEMA_VERSION}")
    for key in ("bench", "fingerprint"):
        v = rec.get(key)
        if not isinstance(v, str) or not v:
            problems.append(f"missing/invalid {key!r}")
    if not isinstance(rec.get("created"), (int, float)) \
            or isinstance(rec.get("created"), bool):
        problems.append("missing/invalid 'created'")
    if rec.get("provenance") not in PROVENANCES:
        problems.append(f"provenance {rec.get('provenance')!r} not in "
                        f"{PROVENANCES}")
    if not isinstance(rec.get("config"), dict):
        problems.append("missing/invalid 'config'")
    metrics = rec.get("metrics")
    if not isinstance(metrics, dict):
        problems.append("missing/invalid 'metrics'")
    else:
        sps = metrics.get(HEADLINE_METRIC)
        if not isinstance(sps, (int, float)) or isinstance(sps, bool) \
                or not math.isfinite(float(sps)) or float(sps) <= 0:
            problems.append(
                f"metrics[{HEADLINE_METRIC!r}] must be a positive "
                f"finite number, got {sps!r}")
    return problems


def validate_ledger(records: Sequence[Dict]) -> List[str]:
    """Validate a whole ledger; problems are prefixed with the record
    index."""
    problems: List[str] = []
    for i, rec in enumerate(records):
        problems.extend(f"record {i}: {p}" for p in validate_record(rec))
    return problems


def append_record(path: Union[str, Path], rec: Dict) -> Path:
    """Append one validated record to the JSONL ledger (flushed — the
    crash-durability contract), creating the file and parents."""
    problems = validate_record(rec)
    if problems:
        raise ValueError(f"refusing to append invalid record: {problems}")
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "a", encoding="utf-8") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")
        f.flush()
    return p


def read_ledger(path: Union[str, Path]) -> List[Dict]:
    """Every record of a JSONL ledger, in append order. Raises on a
    line that does not parse — a torn ledger must be noticed, not
    silently shortened."""
    out: List[Dict] = []
    with open(path, encoding="utf-8") as f:
        for n, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError as e:
                raise ValueError(f"{path}:{n}: unparseable ledger line "
                                 f"({e})") from e
    return out


def group_records(records: Sequence[Dict]
                  ) -> Dict[Tuple[str, str], List[Dict]]:
    """Records grouped by (fingerprint, bench) in append order — the
    comparable trajectories."""
    groups: Dict[Tuple[str, str], List[Dict]] = {}
    for rec in records:
        key = (str(rec.get("fingerprint")), str(rec.get("bench")))
        groups.setdefault(key, []).append(rec)
    return groups


def diff_records(a: Dict, b: Dict) -> Dict:
    """Metric-by-metric comparison of two records (``b`` relative to
    ``a``): every numeric metric appearing in either, with the ratio
    where computable. ``comparable`` is False when the records key
    different trajectories (fingerprint or bench differ) — the numbers
    still print, the caller decides what they mean."""
    am, bm = dict(a.get("metrics") or {}), dict(b.get("metrics") or {})
    out: Dict = {
        "bench": (a.get("bench"), b.get("bench")),
        "fingerprint": (a.get("fingerprint"), b.get("fingerprint")),
        "provenance": (a.get("provenance"), b.get("provenance")),
        "comparable": (a.get("bench") == b.get("bench")
                       and a.get("fingerprint") == b.get("fingerprint")),
        "metrics": {},
    }
    for key in sorted(set(am) | set(bm)):
        va, vb = am.get(key), bm.get(key)
        row = {"a": va, "b": vb}
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)) \
                and not isinstance(va, bool) and not isinstance(vb, bool) \
                and va:
            row["ratio"] = float(vb) / float(va)
        out["metrics"][key] = row
    return out


def gate_regressions(records: Sequence[Dict], threshold: float = 0.2,
                     provenances: Sequence[str] = ("measured",),
                     bench: Optional[str] = None) -> List[str]:
    """The regression gate: within every (fingerprint, bench) group,
    the NEWEST record's ``steps_per_s`` may not drop more than
    ``threshold`` (relative) below the best earlier record of the same
    group. Returns human-readable failures (empty = gate passes;
    nonzero CLI exit otherwise).

    Only ``provenances`` records participate (default: ``measured``
    only — backfilled legacy snapshots come from different sessions
    and machines, so they seed the trajectory but do not gate it);
    ``bench`` restricts the gate to matching bench ids — a glob with
    literal-bracket tolerance (``utils.naming.glob_match``), so
    ``--bench 'bench_exchange*'`` and ids carrying ``[...]`` both
    work."""
    from ..utils.naming import glob_match

    failures: List[str] = []
    eligible = [r for r in records
                if r.get("provenance") in tuple(provenances)
                and (bench is None
                     or glob_match(str(r.get("bench")), bench))]
    for (fp, b), group in group_records(eligible).items():
        if len(group) < 2:
            continue
        newest = group[-1]
        new_sps = float(newest["metrics"][HEADLINE_METRIC])
        best_prev = max(float(r["metrics"][HEADLINE_METRIC])
                        for r in group[:-1])
        if best_prev <= 0:
            continue
        drop = 1.0 - new_sps / best_prev
        if drop > float(threshold):
            failures.append(
                f"{b} [{fp[:12]}...]: steps/s regressed "
                f"{100 * drop:.1f}% (newest {new_sps:.3f} vs best "
                f"earlier {best_prev:.3f}; threshold "
                f"{100 * float(threshold):.0f}%, {len(group)} records)")
    return failures


def gate_groups_checked(records: Sequence[Dict],
                        provenances: Sequence[str] = ("measured",),
                        bench: Optional[str] = None) -> int:
    """How many (fingerprint, bench) groups the gate actually
    COMPARED (>= 2 eligible records). The gate's coverage figure: a
    healthy gate and a vacuous one both exit 0, but only this number
    tells them apart — the CLI stamps it into the ``--json`` artifact
    and ``--min-groups`` ratchets it. ``bench`` matches like
    :func:`gate_regressions` — glob with literal-bracket tolerance."""
    from ..utils.naming import glob_match

    eligible = [r for r in records
                if r.get("provenance") in tuple(provenances)
                and (bench is None
                     or glob_match(str(r.get("bench")), bench))]
    return sum(1 for g in group_records(eligible).values()
               if len(g) >= 2)


# ---------------------------------------------------------------------------
# payload conversion: bench artifacts -> records


def payload_records(payload: Dict, source: str,
                    provenance: str = "legacy",
                    created: float = 0.0
                    ) -> Tuple[List[Dict], List[str]]:
    """Convert one bench artifact (the ``--json-out`` payload shapes)
    into ledger records. ONE converter serves both directions: the
    live apps emit through it with ``provenance="measured"`` and the
    backfill CLI with ``provenance="legacy"`` — so a live record and
    its backfilled ancestor land in the same (fingerprint, bench)
    trajectory group by construction. Returns ``(records, skipped)``
    — ``skipped`` names sub-results that carry no usable measurement
    (a failed or suspect run is reported as skipped, never invented).
    Raises ``ValueError`` on a shape no converter knows."""
    records: List[Dict] = []
    skipped: List[str] = []

    def legacy(bench, config, metrics, fingerprint=None):
        records.append(make_record(bench, config, metrics,
                                   provenance=provenance,
                                   fingerprint=fingerprint,
                                   source=source, created=created))

    if payload.get("bench") == "bench_exchange":
        base_cfg = {"mesh": payload.get("mesh"),
                    "per_device_size": payload.get("per_device_size"),
                    "radius": payload.get("radius"),
                    "fields": payload.get("fields")}
        for cfg in payload.get("configs", ()):
            s = cfg.get("exchange_every")
            legacy("bench_exchange", {**base_cfg, "exchange_every": s},
                   {HEADLINE_METRIC: cfg["steps_per_s"],
                    "seconds": cfg.get("seconds"),
                    "trimean_exchange_s": cfg.get("trimean_exchange_s"),
                    "exchange_rounds_per_step":
                        cfg.get("exchange_rounds_per_step"),
                    "amortized_bytes_per_step_model":
                        cfg.get("amortized_bytes_per_step_model")})
            # per-axis depth provenance: the (x, y, z) depth vector an
            # asymmetric leg ran, stamped AFTER the fingerprint is
            # fixed (the label string in exchange_every already keys
            # the trajectory; the structured vector is a note that
            # never forks a group)
            if cfg.get("depths"):
                records[-1]["config"].setdefault(
                    "depths", [int(v) for v in cfg["depths"]])
        fused = payload.get("fused")
        if fused:
            legacy("bench_exchange.megastep",
                   {**base_cfg, "check_every": fused.get("check_every")},
                   {HEADLINE_METRIC: fused["fused_steps_per_s"],
                    "stepwise_steps_per_s":
                        fused.get("stepwise_steps_per_s"),
                    "fused_over_stepwise":
                        fused.get("fused_over_stepwise")})
            # the newly fused carry contracts' race legs (PIC, the
            # astaroth temporal path) land their OWN trajectories —
            # these paths had no measured history before the segment
            # compiler
            for leg in ("pic", "astaroth_temporal"):
                sub = fused.get(leg)
                if not sub:
                    continue
                cfg = {**base_cfg,
                       "check_every": sub.get("check_every",
                                              fused.get("check_every"))}
                if "exchange_every" in sub:
                    cfg["exchange_every"] = sub["exchange_every"]
                legacy(f"bench_exchange.megastep.{leg}", cfg,
                       {HEADLINE_METRIC: sub["fused_steps_per_s"],
                        "stepwise_steps_per_s":
                            sub.get("stepwise_steps_per_s"),
                        "fused_over_stepwise":
                            sub.get("fused_over_stepwise")})
        at = payload.get("autotune")
        if at:
            plan = at.get("plan") or {}
            legacy("bench_exchange.autotune",
                   {**base_cfg, "plan_config": plan.get("config")},
                   {HEADLINE_METRIC: at["tuned_steps_per_s"],
                    "default_steps_per_s": at.get("default_steps_per_s"),
                    "tuned_over_default": at.get("tuned_over_default")},
                   fingerprint=plan.get("fingerprint"))
        return records, skipped

    if payload.get("bench") == "pic":
        sps = payload.get("seconds_per_step")
        if not sps or sps <= 0:
            skipped.append("pic: no seconds_per_step")
            return records, skipped
        legacy("pic", dict(payload.get("config") or {}),
               {HEADLINE_METRIC: 1.0 / float(sps),
                "seconds_per_step": sps,
                "particle_steps_per_s":
                    payload.get("particle_steps_per_s"),
                "migration_bytes_per_shard":
                    payload.get("migration_bytes_per_shard"),
                "overflow": payload.get("overflow")})
        fused = payload.get("fused")
        if fused:
            # the pic smoke's fused/stepwise megastep race (its own
            # trajectory, gated in CI next to megastep_ratio.json)
            legacy("pic.megastep",
                   {**dict(payload.get("config") or {}),
                    "check_every": fused.get("check_every")},
                   {HEADLINE_METRIC: fused["fused_steps_per_s"],
                    "stepwise_steps_per_s":
                        fused.get("stepwise_steps_per_s"),
                    "fused_over_stepwise":
                        fused.get("fused_over_stepwise")})
        return records, skipped

    if "parsed" in payload:  # a parsed harness result (BENCH_r0*.json)
        parsed = payload.get("parsed")
        if not isinstance(parsed, dict):
            skipped.append(f"{source}: run failed (rc="
                           f"{payload.get('rc')}), nothing parsed")
            return records, skipped
        value = parsed.get("value")
        if parsed.get("suspect") or not isinstance(value, (int, float)) \
                or isinstance(value, bool) or not value or value <= 0:
            skipped.append(f"{source}: suspect/empty measurement "
                           f"(value={value!r})")
            return records, skipped
        extra = parsed.get("extra") or {}
        # identity keys only: run-varying measured figures must not
        # leak into the config, or every record keys its own group
        config = {k: extra.get(k)
                  for k in ("devices", "mesh", "platform")
                  if k in extra}
        config["unit"] = parsed.get("unit")
        legacy(str(parsed.get("metric") or "graft_bench"), config,
               {HEADLINE_METRIC: float(value),
                "vs_baseline": parsed.get("vs_baseline")})
        return records, skipped

    if isinstance(payload.get("bench"), str) \
            and isinstance(payload.get("config"), dict) \
            and isinstance(payload.get("metrics"), dict):
        # the generic shape new apps emit: bench + config + metrics
        legacy(payload["bench"], payload["config"], payload["metrics"],
               fingerprint=payload.get("fingerprint"))
        return records, skipped

    raise ValueError(f"{source}: no ledger converter for this shape "
                     f"(keys: {sorted(payload)[:8]})")


def backfill_records(payload: Dict, source: str,
                     created: float = 0.0
                     ) -> Tuple[List[Dict], List[str]]:
    """Convert one LEGACY bench artifact (``provenance="legacy"``) —
    the ``observatory backfill`` entry over :func:`payload_records`."""
    return payload_records(payload, source, provenance="legacy",
                           created=created)


def backfill_files(paths: Sequence[Union[str, Path]]
                   ) -> Tuple[List[Dict], List[str]]:
    """Backfill several legacy artifacts (in the given order — append
    order IS trajectory order), stamping each record's ``created`` from
    the file's mtime so the legacy trajectory keeps its real
    chronology."""
    records: List[Dict] = []
    skipped: List[str] = []
    for path in paths:
        p = Path(path)
        with open(p, encoding="utf-8") as f:
            payload = json.load(f)
        recs, skips = backfill_records(payload, source=p.name,
                                       created=os.path.getmtime(p))
        records.extend(recs)
        skipped.extend(skips)
    return records, skipped
