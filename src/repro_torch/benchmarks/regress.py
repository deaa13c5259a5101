"""Noise-aware perf-regression check between two runs of the port's suites.

The port's copy of the JAX package's ``benchmarks/regress.py``: it reads
JSON only.  It compares ``BENCH_torch_<suite>.json`` payloads (written by
``repro_torch.benchmarks.run``) of two runs on the card:

  python -m repro_torch.benchmarks.regress --check \\
      --baseline-dir old_run --fresh-dir new_run

and exits non-zero on a regression.  It is a check between two runs the
caller keeps, not a baseline the repo carries: no ``BENCH_torch_*.json``
is committed, and it is no substitute for a benchmark configuration that
records medians run after run.  Three refusal rules keep the comparison
honest (timings that are not apples-to-apples are *skipped*, never
averaged):

* **schema match** — payloads must share ``schema_version``.
* **environment match** — the ``environment`` stamp
  (``repro_torch/benchmarks/common.py``: platform, machine, device kind and
  count, fast mode, and the card's power limit, under which a card set
  below its maximum runs slower) must be identical; a run on another card
  never gates against this one.  Payloads without the stamp are *legacy*: skipped
  unless ``--allow-legacy`` (which compares rows but flags the missing
  stamp).
* **noise floor** — a row regresses only when fresh >= ``--threshold`` x
  baseline (default 1.5x) AND the absolute delta >= ``--min-us`` (default
  1000µs): ratio alone would flag 3µs -> 5µs scheduler jitter, the floor
  alone would miss a real 2x on a slow row.

Outputs: a ``regress_report.json`` artifact (every row's verdict) and,
with ``--history``, an append-only JSONL line per run (suite, git SHA,
environment, per-row µs).  Exit codes: 0 ok/skipped, 1 regression, 2
usage/IO error.  ``--strict`` also fails on suites missing from the
baseline dir (new suites pass by default — they have no baseline yet).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .common import BENCH_SCHEMA_VERSION

REGRESS_SCHEMA_VERSION = 1

#: the port's suites are named apart from the JAX package's (run.SUITE_NAMES)
SUITE_PREFIX = "torch_"

#: environment-stamp fields that must match for timings to be comparable
ENV_MATCH_FIELDS = ("platform", "machine", "device_kind", "device_count",
                    "fast", "power_limit")


def load_suite(path: Path) -> dict:
    """Load one BENCH payload; raises ValueError on a non-dict or a
    pre-versioned bare-rows file (those predate the envelope and carry no
    suite name to match on)."""
    data = json.loads(path.read_text())
    if not isinstance(data, dict) or "rows" not in data:
        raise ValueError(f"{path}: not a BENCH payload (no 'rows')")
    return data


def env_mismatch(base: dict, fresh: dict) -> list[str]:
    """Environment-stamp fields that differ (empty = comparable)."""
    be, fe = base.get("environment"), fresh.get("environment")
    if be is None or fe is None:
        return []                # legacy handling is the caller's decision
    return [f for f in ENV_MATCH_FIELDS if be.get(f) != fe.get(f)]


def compare_suites(base: dict, fresh: dict, *, threshold: float,
                   min_us: float, allow_legacy: bool) -> dict:
    """Row-by-row comparison of one suite.  Returns the suite verdict:
    ``status`` is ``ok`` | ``regression`` | ``skipped`` (with a
    ``reason``), plus per-row records for the report artifact."""
    suite = fresh.get("suite", "?")
    if base.get("schema_version") != fresh.get("schema_version"):
        return {"suite": suite, "status": "skipped",
                "reason": f"schema_version mismatch "
                          f"({base.get('schema_version')} vs "
                          f"{fresh.get('schema_version')})", "rows": []}
    legacy = base.get("environment") is None
    if legacy and not allow_legacy:
        return {"suite": suite, "status": "skipped",
                "reason": "baseline has no environment stamp "
                          "(legacy; rerun with --allow-legacy to compare)",
                "rows": []}
    bad_fields = env_mismatch(base, fresh)
    if bad_fields:
        return {"suite": suite, "status": "skipped",
                "reason": f"environment mismatch on {bad_fields}",
                "rows": []}

    rows = []
    regressed = False
    for name, brow in sorted(base["rows"].items()):
        frow = fresh["rows"].get(name)
        if frow is None:
            rows.append({"name": name, "status": "missing_in_fresh"})
            continue
        b, f = float(brow["us_per_call"]), float(frow["us_per_call"])
        ratio = f / b if b > 0 else float("inf")
        is_reg = ratio >= threshold and (f - b) >= min_us
        regressed |= is_reg
        rows.append({"name": name, "baseline_us": b, "fresh_us": f,
                     "ratio": round(ratio, 3),
                     "status": "regression" if is_reg else "ok"})
    for name in sorted(set(fresh["rows"]) - set(base["rows"])):
        rows.append({"name": name, "status": "new_in_fresh"})
    return {"suite": suite,
            "status": "regression" if regressed else "ok",
            "legacy_baseline": legacy, "rows": rows}


def append_history(history: Path, payload: dict) -> None:
    """One longitudinal JSONL line per fresh suite run."""
    line = {"schema_version": REGRESS_SCHEMA_VERSION,
            "suite": payload.get("suite"),
            "git_sha": payload.get("git_sha"),
            "environment": payload.get("environment"),
            "rows": {name: row.get("us_per_call")
                     for name, row in payload.get("rows", {}).items()}}
    with open(history, "a", encoding="utf-8") as f:
        f.write(json.dumps(line, sort_keys=True) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.regress", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--check", action="store_true",
                   help="exit 1 when any comparable suite regresses")
    p.add_argument("--baseline-dir", type=Path, default=Path("."),
                   help="directory of the baseline run's BENCH_torch_*.json")
    p.add_argument("--fresh-dir", type=Path, default=Path("."),
                   help="directory of the fresh run's BENCH_torch_*.json")
    p.add_argument("--threshold", type=float, default=1.5,
                   help="regression ratio: fresh/baseline (default 1.5)")
    p.add_argument("--min-us", type=float, default=1000.0,
                   help="absolute regression floor in µs (default 1000)")
    p.add_argument("--report", type=Path, default=Path("regress_report.json"),
                   help="verdict artifact path")
    p.add_argument("--history", type=Path, default=None,
                   help="append one JSONL line per fresh suite here")
    p.add_argument("--allow-legacy", action="store_true",
                   help="compare against baselines without an environment "
                        "stamp instead of skipping them")
    p.add_argument("--strict", action="store_true",
                   help="also fail on fresh suites with no baseline")
    args = p.parse_args(argv)

    fresh_paths = sorted(args.fresh_dir.glob(f"BENCH_{SUITE_PREFIX}*.json"))
    if not fresh_paths:
        print(f"regress: no BENCH_{SUITE_PREFIX}*.json under {args.fresh_dir}",
              file=sys.stderr)
        return 2

    results = []
    missing_baseline = []
    for fp in fresh_paths:
        try:
            fresh = load_suite(fp)
        except (ValueError, json.JSONDecodeError) as e:
            print(f"regress: unreadable fresh payload: {e}", file=sys.stderr)
            return 2
        bp = args.baseline_dir / fp.name
        if not bp.exists():
            missing_baseline.append(fresh.get("suite", fp.name))
            results.append({"suite": fresh.get("suite", fp.name),
                            "status": "skipped",
                            "reason": "no baseline", "rows": []})
        else:
            try:
                base = load_suite(bp)
            except (ValueError, json.JSONDecodeError) as e:
                print(f"regress: unreadable baseline: {e}", file=sys.stderr)
                return 2
            results.append(compare_suites(
                base, fresh, threshold=args.threshold, min_us=args.min_us,
                allow_legacy=args.allow_legacy))
        if args.history is not None:
            append_history(args.history, fresh)

    report = {"schema_version": REGRESS_SCHEMA_VERSION,
              "threshold": args.threshold, "min_us": args.min_us,
              "schema_expected": BENCH_SCHEMA_VERSION,
              "suites": results}
    args.report.write_text(json.dumps(report, indent=2, sort_keys=True))

    regressions = [r for r in results if r["status"] == "regression"]
    for r in results:
        detail = r.get("reason", "")
        bad = [row["name"] for row in r["rows"]
               if row.get("status") == "regression"]
        if bad:
            detail = f"rows: {', '.join(bad)}"
        print(f"regress: {r['suite']}: {r['status']}"
              + (f" ({detail})" if detail else ""))
    print(f"# wrote {args.report}", file=sys.stderr)

    if args.check and regressions:
        return 1
    if args.check and args.strict and missing_baseline:
        print(f"regress: --strict: no baseline for {missing_baseline}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
