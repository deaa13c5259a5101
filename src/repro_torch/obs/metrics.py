"""Service metrics registry: counters, gauges, fixed-bucket histograms.

The port's copy of ``repro.obs.metrics`` (pure Python, as the reference's):
the same names, records and JSON, so the two packages' outputs compare
field by field.

The lightweight, zero-dependency registry the streaming engines feed
(DESIGN.md §13): decision counts and latency, admission-queue depth,
compaction pause, snapshot latency, per-device busy fraction.  Everything
is a plain Python accumulator — no locks (the engines are single-threaded
event loops), no background threads, no exporters.  ``snapshot()`` returns
a JSON-able dict that rides along in the telemetry sink's payload
(``TelemetrySink.to_json(metrics=...)``) and the per-run report
(``obs/report.py``).

Metrics are observation-only by construction: they never enter engine
snapshots and the crash-anywhere replay oracle never compares them, so
wall-clock-valued histograms cannot break byte-identical replay.

Histograms use fixed bucket upper bounds (default: 5 buckets per decade
from 1µs to 100s — trial durations and decision latencies both fit).
``percentile(q)`` interpolates linearly inside the located bucket and
clamps to the observed min/max, so p50/p99 are bucket-resolution estimates,
not exact order statistics — the right trade for an always-on hot-path
counter.  Observations above the last finite bound land in an explicit
``+inf`` overflow bucket; percentiles falling there interpolate between the
top bound and the observed max, and ``summary()`` reports ``saturated``
so readers know the tail estimate is max-clamped rather than
bucket-resolved.

Counters and gauges accept optional ``labels`` (per-device-class,
per-priority, ...): each label set is its own time series, snapshot under
the Prometheus-style flat key ``name{k="v",...}`` (label items sorted, so
keys are deterministic).  Unlabeled metrics keep their bare names —
``snapshot()``'s schema is backward compatible.  ``series(name)`` returns
the (labels, metric) pairs of a labeled family so export and health rules
never parse mangled metric keys.
"""

from __future__ import annotations

import math


def _default_time_buckets() -> tuple[float, ...]:
    # 5 per decade, 1e-6s .. 1e2s: 41 finite bounds + implicit overflow
    return tuple(10.0 ** (-6 + i / 5) for i in range(41))


DEFAULT_TIME_BUCKETS = _default_time_buckets()


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-set value, plus the max ever set (queue-depth style series
    often only need "current" and "worst")."""

    __slots__ = ("value", "max")

    def __init__(self):
        self.value = None
        self.max = None

    def set(self, v: float) -> None:
        self.value = v
        self.max = v if self.max is None else max(self.max, v)


class Histogram:
    """Fixed-bucket histogram with p50/p99 snapshot estimates.

    ``bounds`` are ascending finite upper bounds; values above the last
    bound land in the explicit ``+inf`` overflow bucket
    (``counts[len(bounds)]``) — never silently attributed to the last
    finite bucket.  ``saturated`` is True once that bucket is non-empty:
    percentile estimates that land there are max-clamped interpolations,
    not bucket-resolved.  Non-finite observations are counted separately
    (``dropped``) instead of poisoning the stats.
    """

    __slots__ = ("bounds", "counts", "count", "total", "min", "max",
                 "dropped")

    def __init__(self, bounds: tuple[float, ...] = DEFAULT_TIME_BUCKETS):
        if list(bounds) != sorted(bounds) or len(bounds) == 0:
            raise ValueError("bounds must be non-empty and ascending")
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)   # + explicit +inf bucket
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.dropped = 0

    def observe(self, v: float) -> None:
        if v is None or not math.isfinite(v):
            self.dropped += 1
            return
        # linear scan is fine: bucket lists are ~40 long and observe() is
        # called once per *decision*, not per model
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q: float) -> float | None:
        """Bucket-interpolated q-th percentile (q in [0, 100]); None when
        empty."""
        if self.count == 0:
            return None
        target = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else (
                    self.min if self.min is not None else 0.0)
                hi = self.bounds[i] if i < len(self.bounds) else (
                    self.max if self.max is not None else lo)
                frac = (target - cum) / c
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return float(min(max(est, self.min), self.max))
            cum += c
        return float(self.max)   # pragma: no cover - cum==count handled above

    @property
    def saturated(self) -> bool:
        """True once any observation exceeded the top finite bound (mass
        sits in the ``+inf`` bucket; tail percentiles are max-clamped)."""
        return self.counts[len(self.bounds)] > 0

    def summary(self) -> dict:
        mean = self.total / self.count if self.count else None
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            "max": self.max,
            "mean": mean,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
            "dropped_non_finite": self.dropped,
            "saturated": self.saturated,
        }


def _labeled_key(name: str, labels: dict | None) -> str:
    """Prometheus-style flat series key: ``name{k="v",...}`` with label
    items sorted so the key is deterministic; bare ``name`` when
    unlabeled."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Named metric store with get-or-create accessors.  Asking for an
    existing name with the same kind (and labels) returns the same object
    (engines cache handles at construction; ad-hoc callers just look up by
    name).  Labeled series share one *family* name — the whole family must
    be one kind."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._kinds: dict[str, dict] = {}     # family name -> owning store
        self._labels: dict[str, dict] = {}    # series key -> labels dict

    def _check_free(self, name: str, own: dict) -> None:
        store = self._kinds.setdefault(name, own)
        if store is not own:
            raise ValueError(f"metric {name!r} already registered "
                             "with a different kind")

    def counter(self, name: str, labels: dict | None = None) -> Counter:
        self._check_free(name, self._counters)
        key = _labeled_key(name, labels)
        if labels:
            self._labels[key] = dict(labels)
        return self._counters.setdefault(key, Counter())

    def gauge(self, name: str, labels: dict | None = None) -> Gauge:
        self._check_free(name, self._gauges)
        key = _labeled_key(name, labels)
        if labels:
            self._labels[key] = dict(labels)
        return self._gauges.setdefault(key, Gauge())

    def histogram(self, name: str,
                  bounds: tuple[float, ...] | None = None) -> Histogram:
        self._check_free(name, self._histograms)
        h = self._histograms.get(name)
        if h is None:
            h = Histogram(bounds or DEFAULT_TIME_BUCKETS)
            self._histograms[name] = h
        return h

    def series(self, name: str) -> list:
        """All series of the family ``name`` as ``(labels, metric)`` pairs
        (labels ``{}`` for the unlabeled series) — the structured view
        export and health rules use instead of parsing flat keys."""
        store = self._kinds.get(name)
        if store is None:
            return []
        out = []
        for key, m in store.items():
            if key == name or key.startswith(name + "{"):
                out.append((self._labels.get(key, {}), m))
        return out

    def snapshot(self) -> dict:
        """JSON-able dump of every metric — the payload that rides in the
        telemetry sink's ``to_json`` and the per-run report."""
        return {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: {"value": g.value, "max": g.max}
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self._histograms.items())},
        }


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_TIME_BUCKETS"]
