"""The report plane: one experiment directory per run.

The port's copy of ``repro.obs.report`` (pure Python, as the reference's):
the same names, records and JSON, so the two packages' outputs compare
field by field; the span rows add the thread's CPU time, ``cpu_us``, which
the port's span records carry.

:func:`write_report` turns a run's observability payloads — the telemetry
sink, the tracer's span records, the metrics registry, optionally the
``StreamResult`` trial log — into ``<out_dir>/<run_id>/`` (DESIGN.md §13):

  summary.json   machine-readable roll-up: telemetry summary, metrics
                 snapshot, span aggregation by path, run metadata
  timeline.csv   the run as a flat time series (trial launches and
                 observations, queue-depth samples) for ad-hoc plotting
  report.html    self-contained operator view: flamegraph-style span
                 breakdown bars, SLO / regret / utilization tables —
                 zero external assets, opens from a CI artifact
  trace.json     raw span dump (only when a tracer with spans is given)
  alerts.jsonl   health-plane alert records (only when alerts are given)
  forensics.jsonl per-decision attribution stream (only when given); the
                 html tabulates the smallest-margin decisions and counts
                 uniform-cost counterfactual flips

Everything is stdlib-rendered (json/csv/html): the report plane must run
in the same zero-dependency envelope as the engines it observes.  The
layout follows the per-run ``reports/`` + ``experiments/`` convention of
the pyotest framework the ROADMAP points at: a run id names a directory,
and every artifact inside is self-describing.
"""

from __future__ import annotations

import csv
import html
import json
from pathlib import Path

REPORT_SCHEMA_VERSION = 1


def aggregate_spans(records: list[dict]) -> dict[str, dict]:
    """Fold span records into a flamegraph-style path aggregation.

    A span's *path* is the '/'-joined name chain from its trace's root
    (``decide/posterior``), so identical code paths across traces land in
    one row.  Each row carries call count, total time, *self* time (total
    minus direct children — the unattributed share lives in the parent's
    self time) and the thread's total CPU time (``cpu_us``).  Rows come
    back sorted by total time, descending.
    """
    by_key = {(s["trace"], s["span"]): s for s in records}
    paths: dict[tuple, str] = {}

    def path_of(s: dict) -> str:
        key = (s["trace"], s["span"])
        got = paths.get(key)
        if got is None:
            if s["parent"] is None:
                got = s["name"]
            else:
                parent = by_key.get((s["trace"], s["parent"]))
                got = (f"{path_of(parent)}/{s['name']}"
                       if parent is not None else s["name"])
            paths[key] = got
        return got

    agg: dict[str, dict] = {}
    for s in records:
        row = agg.setdefault(path_of(s), {"count": 0, "total_us": 0.0,
                                          "self_us": 0.0, "cpu_us": 0.0})
        row["count"] += 1
        row["total_us"] += s["dur_us"]
        row["self_us"] += s["dur_us"]
        row["cpu_us"] += s["cpu_us"]
    for s in records:           # subtract children from their parent's self
        if s["parent"] is None:
            continue
        parent = by_key.get((s["trace"], s["parent"]))
        if parent is not None:
            agg[path_of(parent)]["self_us"] -= s["dur_us"]
    for row in agg.values():
        row["mean_us"] = row["total_us"] / row["count"]
    return dict(sorted(agg.items(),
                       key=lambda kv: -kv[1]["total_us"]))


def _timeline_rows(telemetry, result) -> list[list]:
    rows: list[list] = []    # kind, t, tenant, model, device, value
    if result is not None:
        for t in result.trials:
            rows.append(["launch", t.start, t.tenant_key, t.model,
                         t.device, t.end - t.start])
            if t.z is not None:
                rows.append(["observation", t.end, t.tenant_key, t.model,
                             t.device, t.z])
    if telemetry is not None:
        for t, depth in telemetry.queue_depth_samples:
            rows.append(["queue_depth", t, "", "", "", depth])
    rows.sort(key=lambda r: (r[1], r[0]))
    return rows


# ---- HTML rendering ---------------------------------------------------------

_CSS = """
body { font: 14px/1.45 system-ui, sans-serif; margin: 2em auto;
       max-width: 72em; color: #1a1a2e; padding: 0 1em; }
h1 { font-size: 1.4em; } h2 { font-size: 1.1em; margin-top: 2em; }
table { border-collapse: collapse; margin: 0.5em 0; }
th, td { border: 1px solid #d5d5e0; padding: 0.25em 0.7em;
         text-align: right; font-variant-numeric: tabular-nums; }
th { background: #f0f0f6; } td.l, th.l { text-align: left; }
.bar { display: inline-block; height: 0.85em; background: #5470c6;
       vertical-align: baseline; min-width: 1px; }
.bar.self { background: #91cc75; }
.muted { color: #777; } code { background: #f4f4f8; padding: 0 0.25em; }
"""


def _fmt(v, digits=3):
    if v is None:
        return "–"
    if isinstance(v, float):
        return f"{v:.{digits}f}"
    return str(v)


def _table(headers: list[str], rows: list[list], left: set[int]) -> str:
    out = ["<table><tr>"]
    for i, h in enumerate(headers):
        cls = ' class="l"' if i in left else ""
        out.append(f"<th{cls}>{html.escape(h)}</th>")
    out.append("</tr>")
    for row in rows:
        out.append("<tr>")
        for i, cell in enumerate(row):
            cls = ' class="l"' if i in left else ""
            out.append(f"<td{cls}>{cell}</td>")
        out.append("</tr>")
    out.append("</table>")
    return "".join(out)


def _span_section(span_agg: dict[str, dict]) -> str:
    if not span_agg:
        return ("<p class='muted'>No spans recorded — run with tracing "
                "enabled (<code>Tracer(enabled=True)</code>) for the "
                "decision-path breakdown.</p>")
    total = max((r["total_us"] for r in span_agg.values()), default=0.0)
    rows = []
    for path, r in span_agg.items():
        depth = path.count("/")
        share = r["total_us"] / total if total > 0 else 0.0
        self_share = max(r["self_us"], 0.0) / total if total > 0 else 0.0
        label = ("&nbsp;" * (2 * depth)) + html.escape(path.split("/")[-1])
        bar = (f'<span class="bar" style="width:{share * 28:.2f}em"></span>'
               f'<span class="bar self" '
               f'style="width:{self_share * 28:.2f}em"></span>')
        rows.append([label, r["count"], f"{r['total_us']:.1f}",
                     f"{max(r['self_us'], 0.0):.1f}",
                     f"{r['mean_us']:.1f}", f"{100 * share:.1f}%",
                     f'<span class="l">{bar}</span>'])
    legend = ("<p class='muted'>bars: <span class='bar' "
              "style='width:1.2em'></span> total &nbsp; <span class='bar "
              "self' style='width:1.2em'></span> self (excl. children); "
              "widths share one scale (largest total)</p>")
    return legend + _table(
        ["span path", "count", "total µs", "self µs", "mean µs", "share",
         ""], rows, left={0, 6})


def _alerts_section(alerts: list[dict]) -> str:
    if not alerts:
        return ("<p class='muted'>No alerts fired — run with a "
                "<code>HealthMonitor</code> attached for SLO burn-rate "
                "and watchdog coverage.</p>")
    rows = []
    for a in alerts:
        detail = ", ".join(f"{k}={_fmt(v)}"
                           for k, v in sorted(a.get("detail", {}).items()))
        rows.append([_fmt(a["t"], 2), a["event_index"],
                     html.escape(a["kind"]), html.escape(a["severity"]),
                     html.escape(str(a["subject"])), html.escape(detail)])
    return _table(["t", "event", "kind", "severity", "subject", "detail"],
                  rows, left={2, 3, 4, 5})


def _forensics_section(records: list[dict], limit: int = 30) -> str:
    if not records:
        return ("<p class='muted'>No forensics recorded — run with a "
                "<code>ForensicsRecorder</code> attached for per-decision "
                "attribution.</p>")
    cf_flips = sum(1 for r in records
                   if (r.get("uniform_cost") or {}).get("changes_pick"))
    # smallest-margin decisions are the interesting ones: the pick was
    # nearly something else
    ranked = sorted((r for r in records if r.get("margin") is not None),
                    key=lambda r: r["margin"])[:limit]
    rows = []
    for r in ranked:
        w, ru = r["winner"], r["runner_up"]
        cf = r.get("uniform_cost") or {}
        rows.append([
            _fmt(r["t"], 2), r["event_index"], r["seq"],
            html.escape(str(r.get("device_class") or "–")),
            w["model"], _fmt(w["eirate"], 5), _fmt(w["ei"], 5),
            _fmt(w["cost"], 3),
            ru["model"] if ru else "–",
            _fmt(r["margin"], 6),
            ("flips&rarr;" + str(cf.get("model"))
             if cf.get("changes_pick") else "no"),
        ])
    head = (f"<p class='muted'>{len(records)} decisions recorded; "
            f"{cf_flips} would flip under uniform cost "
            f"(cheapness-driven picks); showing the {len(rows)} "
            f"smallest-margin decisions.</p>")
    return head + _table(
        ["t", "event", "seq", "class", "winner", "EIrate", "EI", "cost",
         "runner-up", "margin", "uniform-cost"], rows, left={3, 10})


def _capacity_section(sample: dict | None) -> str:
    if not sample:
        return ("<p class='muted'>No capacity samples — run with a "
                "<code>CapacityAccountant</code> attached for posterior "
                "byte accounting and shard occupancy.</p>")
    scalar_rows = []
    for key in ("gp_blocks", "gp_obs", "gp_alloc_bytes", "gp_active_bytes",
                "gp_readout_bytes", "gp_bytes", "gp_bytes_projected",
                "slots_total", "slots_live", "slots_free", "load_imbalance",
                "autoscale_joins", "autoscale_leaves", "scoring_passes"):
        if key in sample:
            scalar_rows.append([html.escape(key), _fmt(sample[key])])
    for cls, n in sorted((sample.get("devices") or {}).items()):
        scalar_rows.append([f"devices[{html.escape(cls)}]", n])
    head = (f"<p class='muted'>final sample at t={_fmt(sample['t'], 2)} "
            f"(event {sample['event_index']}); projected bytes use the "
            f"accountant's horizon slope fit.</p>")
    out = head + _table(["capacity metric", "value"], scalar_rows, left={0})
    shard_slots = sample.get("shard_slots")
    if shard_slots:
        out += _table(["shard", "live slots"],
                      [[s, n] for s, n in enumerate(shard_slots)],
                      left=set())
    return out


def _slo_section(summary: dict, slo: dict) -> str:
    rows = []
    for key in ("ttfo_p50", "ttfo_p99", "serve_gap_p50", "serve_gap_max",
                "tenant_regret_mean", "tenant_regret_max",
                "device_utilization", "speed_weighted_utilization"):
        val = summary.get(key)
        target = slo.get(key)
        if target is None:
            att = "–"
        elif val is None:
            att = "no data"
        else:
            # utilization SLOs are floors, latency/regret SLOs are ceilings
            ok = (val >= target if "utilization" in key else val <= target)
            att = "met" if ok else "MISSED"
        rows.append([html.escape(key), _fmt(val), _fmt(target), att])
    return _table(["metric", "value", "target", "attainment"], rows,
                  left={0, 3})


def _render_html(run_id: str, meta: dict, summary: dict,
                 span_agg: dict[str, dict], metrics: dict | None,
                 per_tenant: dict | None, per_device: dict | None,
                 alerts: list[dict] | None = None,
                 forensics: list[dict] | None = None,
                 capacity: dict | None = None) -> str:
    parts = [f"<!doctype html><html><head><meta charset='utf-8'>"
             f"<title>run {html.escape(run_id)}</title>"
             f"<style>{_CSS}</style></head><body>"]
    parts.append(f"<h1>Run report — <code>{html.escape(run_id)}</code></h1>")
    if meta:
        items = ", ".join(f"{html.escape(str(k))}={html.escape(str(v))}"
                          for k, v in sorted(meta.items()) if k != "slo")
        parts.append(f"<p class='muted'>{items}</p>")

    parts.append("<h2>Decision-path span breakdown</h2>")
    parts.append(_span_section(span_agg))

    parts.append("<h2>SLO attainment</h2>")
    parts.append(_slo_section(summary, dict(meta.get("slo") or {})))

    parts.append("<h2>Health alerts</h2>")
    parts.append(_alerts_section(list(alerts or [])))

    parts.append("<h2>Capacity</h2>")
    parts.append(_capacity_section(capacity))

    parts.append("<h2>Decision forensics</h2>")
    parts.append(_forensics_section(list(forensics or [])))

    parts.append("<h2>Service summary</h2>")
    parts.append(_table(
        ["metric", "value"],
        [[html.escape(k), _fmt(v)] for k, v in sorted(summary.items())],
        left={0}))

    if metrics:
        hrows = [[html.escape(name), h["count"], _fmt(h["mean"], 6),
                  _fmt(h["p50"], 6), _fmt(h["p99"], 6), _fmt(h["max"], 6)]
                 for name, h in sorted(metrics["histograms"].items())]
        crows = [[html.escape(k), v]
                 for k, v in sorted(metrics["counters"].items())]
        grows = [[html.escape(k), _fmt(v["value"]), _fmt(v["max"])]
                 for k, v in sorted(metrics["gauges"].items())]
        parts.append("<h2>Metrics registry</h2>")
        if hrows:
            parts.append(_table(["histogram", "count", "mean", "p50",
                                 "p99", "max"], hrows, left={0}))
        if crows:
            parts.append(_table(["counter", "value"], crows, left={0}))
        if grows:
            parts.append(_table(["gauge", "value", "max"], grows, left={0}))

    if per_tenant:
        ranked = sorted(per_tenant.items(),
                        key=lambda kv: -(kv[1].get("regret") or 0.0))[:25]
        parts.append("<h2>Per-tenant regret (worst 25)</h2>")
        parts.append(_table(
            ["tenant", "arrived", "admitted", "departed", "obs", "best z",
             "regret"],
            [[k, _fmt(v["arrived"], 2), _fmt(v["admitted"], 2),
              _fmt(v["departed"], 2), v["num_obs"], _fmt(v["best_z"]),
              _fmt(v["regret"], 5)] for k, v in ranked], left=set()))

    if per_device:
        parts.append("<h2>Per-device utilization</h2>")
        parts.append(_table(
            ["device", "speed", "joined", "left", "trials", "busy s",
             "busy fraction"],
            [[d, _fmt(v["speed"], 1), _fmt(v["joined"], 2),
              _fmt(v["left"], 2), v["trials"], _fmt(v["busy_seconds"], 2),
              _fmt(v["utilization"])]
             for d, v in sorted(per_device.items())], left=set()))

    parts.append("</body></html>")
    return "".join(parts)


# ---- the entry point --------------------------------------------------------

def write_report(out_dir: str | Path, run_id: str, *, telemetry=None,
                 tracer=None, metrics=None, result=None,
                 meta: dict | None = None, alerts=None,
                 forensics=None, accounting=None) -> Path:
    """Render one per-run experiment directory and return its path.

    Args:
      out_dir:   reports root; the run directory is ``out_dir / run_id``.
      run_id:    directory name — caller-chosen (trace name, seed, ...).
      telemetry: a ``TelemetrySink`` (summary + per-tenant/per-device
                 tables); optional.
      tracer:    a ``Tracer`` whose spans feed the breakdown; optional.
      metrics:   a ``MetricsRegistry``; optional.
      result:    a ``StreamResult`` for the trial timeline; optional.
      meta:      run metadata echoed into summary.json and the report
                 header.  ``meta["slo"]`` (metric name -> target) drives
                 the SLO-attainment column.
      alerts:    health-plane alert records (``Alert`` objects or their
                 ``to_record()`` dicts — e.g. ``HealthMonitor.alerts`` or
                 ``EventLog.alerts``); rendered as the alert table and
                 re-emitted to ``alerts.jsonl`` in the run dir.
      forensics: per-decision attribution records
                 (``ForensicsRecorder.records``); the smallest-margin
                 decisions are tabulated and the raw stream lands in
                 ``forensics.jsonl``.
      accounting: a ``CapacityAccountant`` (its final sample feeds the
                 capacity section and ``summary.json["capacity"]``).
    """
    meta = dict(meta or {})
    alert_recs = [a.to_record() if hasattr(a, "to_record") else a
                  for a in (alerts or [])]
    forensic_recs = list(forensics or [])
    run_dir = Path(out_dir) / run_id
    run_dir.mkdir(parents=True, exist_ok=True)

    summary = telemetry.summary() if telemetry is not None else {}
    per_tenant = telemetry.per_tenant() if telemetry is not None else None
    per_device = (telemetry.per_device()
                  if telemetry is not None and telemetry.devices else None)
    records = tracer.records() if tracer is not None else []
    span_agg = aggregate_spans(records)
    metric_snap = metrics.snapshot() if metrics is not None else None

    cf_flips = sum(1 for r in forensic_recs
                   if (r.get("uniform_cost") or {}).get("changes_pick"))
    payload = {
        "schema_version": REPORT_SCHEMA_VERSION,
        "run_id": run_id,
        "meta": meta,
        "telemetry": summary,
        "metrics": metric_snap,
        "spans": span_agg,
        "num_spans": len(records),
        "alerts": {
            "total": len(alert_recs),
            "by_kind": {k: sum(1 for a in alert_recs if a["kind"] == k)
                        for k in sorted({a["kind"] for a in alert_recs})},
        },
        "forensics": {
            "decisions": len(forensic_recs),
            "uniform_cost_flips": cf_flips,
        },
        "capacity": (accounting.latest()
                     if accounting is not None else None),
    }
    (run_dir / "summary.json").write_text(
        json.dumps(payload, indent=2, sort_keys=True, allow_nan=False))

    with open(run_dir / "timeline.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["kind", "t", "tenant", "model", "device", "value"])
        w.writerows(_timeline_rows(telemetry, result))

    (run_dir / "report.html").write_text(_render_html(
        run_id, meta, summary, span_agg, metric_snap, per_tenant,
        per_device, alerts=alert_recs, forensics=forensic_recs,
        capacity=accounting.latest() if accounting is not None else None))

    if alert_recs:
        with open(run_dir / "alerts.jsonl", "w") as f:
            for a in alert_recs:
                f.write(json.dumps(a, allow_nan=False) + "\n")
    if forensic_recs:
        with open(run_dir / "forensics.jsonl", "w") as f:
            for r in forensic_recs:
                f.write(json.dumps(r, allow_nan=False) + "\n")

    if records:
        tracer.to_json(run_dir / "trace.json")
    return run_dir


__all__ = ["write_report", "aggregate_spans", "REPORT_SCHEMA_VERSION"]
