"""Streaming metrics export: windowed JSONL + Prometheus text rendering.

The port's copy of ``repro.obs.export`` (pure Python, as the reference's):
the same names, records and JSON, so the two packages' outputs compare
field by field.

The passive registry (``obs/metrics.py``) only surfaces at end of run —
this module samples it *live* from inside the engine pop loops
(DESIGN.md §14).  :class:`MetricsExporter` is ticked once per processed
event with the engine's **sim-time** clock; whenever the event stream
crosses a window boundary it appends one snapshot record to an append-only
JSONL stream.  Export *timing* is therefore a pure function of the event
log — a crash-recovered run re-emits windows for the replayed suffix at
exactly the sim-times the uninterrupted run used (the exporter's window
cursor rides in the engine snapshot).  Export *content* includes
wall-clock histograms (decision latency), which is fine: nothing consumes
exports back into the decision path, and the replay oracle never compares
them (same observation-only discipline as spans, §13).

``prometheus_text`` renders a registry snapshot in the Prometheus
exposition format — labeled series produced by
``MetricsRegistry.counter(name, labels=...)`` already carry
``name{k="v"}`` flat keys, so the rendering is mostly name sanitization
plus histogram summary expansion (``_count``/``_sum``/quantile series).
The capacity plane's gauges (``capacity.gp_bytes``,
``capacity.shard_slots{shard="0"}`` ... — obs/accounting.py) flow through
unchanged; health-plane alert *counts* are not registry metrics, so the
exporter renders them itself (``health_alerts_total{kind="..."}``) when a
``HealthMonitor`` is attached — alerts previously reached only
alerts.jsonl and the report, never the scrape surface.
"""

from __future__ import annotations

import json
import re


def _split_key(key: str) -> tuple[str, str]:
    """``name{k="v"}`` -> (name, ``{k="v"}``); bare names get ``""``."""
    if "{" in key:
        name, rest = key.split("{", 1)
        return name, "{" + rest
    return key, ""


def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _prom_val(v) -> str:
    if v is None:
        return "NaN"
    return repr(float(v)) if isinstance(v, float) else str(v)


def prometheus_text(snapshot: dict) -> str:
    """Render a ``MetricsRegistry.snapshot()`` in Prometheus exposition
    format.  Deterministic: snapshot dicts are sorted, label items are
    sorted at key-construction time."""
    lines: list[str] = []
    seen_type: set[str] = set()

    def typed(name: str, kind: str) -> None:
        if name not in seen_type:
            seen_type.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for key, v in snapshot.get("counters", {}).items():
        name, labels = _split_key(key)
        name = _prom_name(name) + "_total"
        typed(name, "counter")
        lines.append(f"{name}{labels} {_prom_val(v)}")
    for key, g in snapshot.get("gauges", {}).items():
        name, labels = _split_key(key)
        name = _prom_name(name)
        typed(name, "gauge")
        lines.append(f"{name}{labels} {_prom_val(g['value'])}")
        typed(name + "_max", "gauge")
        lines.append(f"{name}_max{labels} {_prom_val(g['max'])}")
    for key, s in snapshot.get("histograms", {}).items():
        name, labels = _split_key(key)
        name = _prom_name(name)
        typed(name, "summary")
        for q, field in (("0.5", "p50"), ("0.99", "p99")):
            qlab = (labels[:-1] + f',quantile="{q}"}}' if labels
                    else f'{{quantile="{q}"}}')
            lines.append(f"{name}{qlab} {_prom_val(s[field])}")
        lines.append(f"{name}_sum{labels} {_prom_val(s['sum'])}")
        lines.append(f"{name}_count{labels} {_prom_val(s['count'])}")
    return "\n".join(lines) + "\n"


EXPORT_SCHEMA_VERSION = 1


class MetricsExporter:
    """Sim-time-windowed registry sampler.

    ``tick(t, event_index)`` is called once per processed event; the first
    event whose sim-time lands in a new ``window``-second window emits one
    snapshot record (so idle windows emit nothing and emission is a
    deterministic function of the event stream).  Records accumulate
    in-memory and — when ``path`` is given — stream write-through to
    append-only JSONL, one object per line.

    The only mutable cursor (``last window emitted``) has
    ``state_dict``/``load_state`` hooks; engines persist it in their
    snapshots so a recovered run's suffix emits the identical windows.

    ``health`` (a ``HealthMonitor``, attached by the engine when both
    planes run) folds per-kind alert counts into every snapshot record and
    into the Prometheus rendering as ``health_alerts_total{kind="..."}``.
    Alert counts are a pure function of the event stream (health.py), so
    the records stay replay-stable.
    """

    def __init__(self, metrics, path: str | None = None,
                 window: float = 10.0, health=None):
        if window <= 0:
            raise ValueError("window must be positive")
        self.metrics = metrics
        self.window = float(window)
        self.health = health
        self.records: list[dict] = []
        self._last_window = -1
        self._fh = open(path, "a", encoding="utf-8") if path else None

    def _emit(self, rec: dict) -> None:
        self.records.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec, allow_nan=False) + "\n")
            self._fh.flush()

    def _alert_counts(self) -> dict[str, int] | None:
        if self.health is None:
            return None
        counts: dict[str, int] = {}
        for a in self.health.alerts:
            counts[a.kind] = counts.get(a.kind, 0) + 1
        return dict(sorted(counts.items()))

    def _record(self, t: float, event_index: int, **extra) -> dict:
        rec = {"schema_version": EXPORT_SCHEMA_VERSION,
               "window": int(t // self.window), "t": float(t),
               "event_index": int(event_index), **extra,
               "metrics": self.metrics.snapshot()}
        alerts = self._alert_counts()
        if alerts is not None:
            rec["alerts"] = alerts
        return rec

    def tick(self, t: float, event_index: int) -> None:
        w = int(t // self.window)
        if w <= self._last_window:
            return
        self._last_window = w
        self._emit(self._record(t, event_index))

    def final(self, t: float, event_index: int) -> None:
        """End-of-run flush: one closing record regardless of window
        position (both the uninterrupted run and a resumed run end at the
        same sim-time, so this too replays stably)."""
        self._emit(self._record(t, event_index, final=True))

    def prometheus(self) -> str:
        text = prometheus_text(self.metrics.snapshot())
        alerts = self._alert_counts()
        if alerts is None:
            return text
        lines = ["# TYPE health_alerts_total counter"]
        for kind, n in alerts.items():
            lines.append(f'health_alerts_total{{kind="{kind}"}} {n}')
        return text + "\n".join(lines) + "\n"

    def state_dict(self) -> dict:
        return {"last_window": self._last_window}

    def load_state(self, state: dict) -> None:
        self._last_window = int(state["last_window"])

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


__all__ = ["MetricsExporter", "prometheus_text", "EXPORT_SCHEMA_VERSION"]
