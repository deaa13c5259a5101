"""Capacity accounting: the resource half of the observability story.

The port's copy of ``repro.obs.accounting`` (pure Python, as the reference's):
the same names, records and JSON, so the two packages' outputs compare
field by field.

The third observation plane (DESIGN.md §15, after §13's flight recorder and
§14's live health plane).  The service's dominant state is the per-tenant
GP posterior — preallocated (m, m) Cholesky/readout buffers whose *active*
share grows O(obs·m) per tenant (O(obs²) when the block tracks its observed
set) — and the sharded index space that decides how M devices split the
scoring work.  Neither was measurable before this plane: memory grew
invisibly, and the sharded scorer's weak scaling had no metric naming a
cause.

:class:`CapacityAccountant` samples both, from inside the engine pop loops:

* **posterior accounting** — ``ControlPlane.capacity_stats()`` introspects
  every live tenant block through ``BlockIncrementalGP.resource_stats()``
  (analytic byte formulas, no device syncs) and the accountant publishes
  aggregate gauges (``capacity.gp_alloc_bytes``, ``capacity.gp_obs`` ...)
  plus per-tenant labeled gauges (``capacity.tenant_bytes{tenant="3"}``).
* **shard occupancy** — ``ShardLayout.occupancy()`` gives per-shard live
  slot counts and the max/mean load-imbalance index
  (``capacity.shard_slots{shard="0"}``, ``capacity.load_imbalance``).
* **projection** — a least-squares slope over the recent byte samples
  projects total posterior bytes ``horizon`` sim-seconds ahead
  (``capacity.gp_bytes_projected``); the health plane's ``memory_runaway``
  watchdog consumes it, so the alert fires *before* the budget is blown.
* **fleet composition** — live device counts per class
  (``capacity.devices{cls="fast"}``) and whatever the engine's
  ``_capacity_extra()`` hook adds (the devplane engine reports autoscale
  joins/leaves and scoring passes).

Discipline (the same as every other plane): observation-only — gauges never
feed a decision, a run with the accountant attached is byte-identical to a
bare twin — and replay-stable — samples fire at sim-time window boundaries
(a pure function of the event stream), the sample cursor + projection
history ride in the engine snapshot under ``meta["obs"]["capacity"]``, so
a crash-recovered run re-emits the identical gauge/alert suffix.
"""

from __future__ import annotations

ACCOUNTING_SCHEMA_VERSION = 1


def _fit_slope(samples: list[tuple[float, float]]) -> float:
    """Least-squares d(bytes)/d(sim-second) over ``(t, bytes)`` samples;
    0.0 when under-determined (fewer than 2 distinct times)."""
    if len(samples) < 2:
        return 0.0
    n = len(samples)
    mt = sum(t for t, _ in samples) / n
    mb = sum(b for _, b in samples) / n
    den = sum((t - mt) ** 2 for t, _ in samples)
    if den <= 0.0:
        return 0.0
    num = sum((t - mt) * (b - mb) for t, b in samples)
    return num / den


class CapacityAccountant:
    """Windowed capacity sampler fed once per processed event.

    ``tick(t, event_index, engine)`` is the engine pop-loop site: the first
    event whose sim-time crosses a ``window``-second boundary takes one
    sample (so idle windows cost nothing and sampling is deterministic);
    the end-of-run path calls :meth:`sample` directly so short runs still
    publish gauges.  Construct with the run's ``MetricsRegistry`` and hand
    to ``StreamEngine(accounting=...)``.

    ``horizon`` is the projection lookahead in sim-seconds;
    ``history`` bounds the projection fit window (samples, not seconds).
    """

    def __init__(self, metrics, *, window: float = 10.0,
                 horizon: float = 60.0, history: int = 8):
        if window <= 0:
            raise ValueError("window must be positive")
        if history < 2:
            raise ValueError("history must be >= 2 (projection needs a fit)")
        self.metrics = metrics
        self.window = float(window)
        self.horizon = float(horizon)
        self.history = int(history)
        self.samples: list[dict] = []
        self._last_window = -1
        self._byte_hist: list[tuple[float, float]] = []

    # -- the engine feed ---------------------------------------------------

    def tick(self, t: float, event_index: int, engine) -> None:
        w = int(t // self.window)
        if w <= self._last_window:
            return
        self._last_window = w
        self.sample(t, event_index, engine)

    def sample(self, t: float, event_index: int, engine) -> dict:
        """Take one capacity sample: introspect, publish gauges, project,
        and feed the health plane's memory watchdog.  Returns the sample
        record (also appended to ``self.samples`` for the report plane)."""
        stats = engine.cp.capacity_stats()
        gp, layout = stats.get("gp"), stats.get("layout")
        rec = {"schema_version": ACCOUNTING_SCHEMA_VERSION,
               "t": float(t), "event_index": int(event_index)}
        g = self.metrics.gauge if self.metrics is not None else None

        total_bytes = 0.0
        if gp is not None:
            alloc = gp.get("alloc_bytes", 0)
            readout = gp.get("readout_bytes", 0)
            total_bytes = float(alloc + readout)
            rec.update(gp_blocks=gp.get("num_blocks", 1),
                       gp_obs=gp.get("obs_total", gp.get("obs", 0)),
                       gp_alloc_bytes=int(alloc),
                       gp_active_bytes=int(gp.get("active_bytes", 0)),
                       gp_readout_bytes=int(readout),
                       gp_bytes=int(total_bytes))
            if g is not None:
                g("capacity.gp_blocks").set(rec["gp_blocks"])
                g("capacity.gp_obs").set(rec["gp_obs"])
                g("capacity.gp_alloc_bytes").set(rec["gp_alloc_bytes"])
                g("capacity.gp_active_bytes").set(rec["gp_active_bytes"])
                g("capacity.gp_readout_bytes").set(rec["gp_readout_bytes"])
                g("capacity.gp_bytes").set(rec["gp_bytes"])
                for tid, bstat in (gp.get("tenants") or {}).items():
                    labels = {"tenant": str(tid)}
                    g("capacity.tenant_bytes", labels).set(
                        bstat["alloc_bytes"])
                    g("capacity.tenant_obs", labels).set(bstat["obs"])

        if layout is not None:
            rec.update(slots_total=layout["slots_total"],
                       slots_live=layout["slots_live"],
                       slots_free=layout["slots_free"],
                       shard_slots=list(layout["per_shard"]),
                       load_imbalance=float(layout["imbalance"]))
            if g is not None:
                g("capacity.slots_total").set(layout["slots_total"])
                g("capacity.slots_live").set(layout["slots_live"])
                g("capacity.slots_free").set(layout["slots_free"])
                g("capacity.load_imbalance").set(float(layout["imbalance"]))
                for s, live in enumerate(layout["per_shard"]):
                    g("capacity.shard_slots", {"shard": str(s)}).set(live)

        by_cls: dict[str, int] = {}
        for sl in engine.fleet.slices:
            if not sl.retired:
                by_cls[sl.cls] = by_cls.get(sl.cls, 0) + 1
        rec["devices"] = dict(sorted(by_cls.items()))
        if g is not None:
            for cls, n in sorted(by_cls.items()):
                g("capacity.devices", {"cls": cls}).set(n)

        extra = engine._capacity_extra()
        for key, val in sorted(extra.items()):
            rec[key] = val
            if g is not None:
                g(f"capacity.{key}").set(val)

        # projection: bytes-at-horizon from the recent sample slope.  The
        # history is (t, bytes) pairs only — small, JSON-able, snapshot-safe.
        self._byte_hist.append((float(t), total_bytes))
        del self._byte_hist[:-self.history]
        slope = _fit_slope(self._byte_hist)
        projected = total_bytes + slope * self.horizon
        rec["gp_bytes_projected"] = int(max(projected, 0.0))
        rec["gp_bytes_slope"] = float(slope)
        if g is not None:
            g("capacity.gp_bytes_projected").set(rec["gp_bytes_projected"])

        if getattr(engine, "health", None) is not None:
            engine.health.on_capacity(
                t, event_index, bytes_now=total_bytes,
                projected_bytes=float(max(projected, 0.0)))

        self.samples.append(rec)
        return rec

    def latest(self) -> dict | None:
        """The most recent sample (the report plane's capacity section)."""
        return self.samples[-1] if self.samples else None

    # -- persistence (rides in the engine snapshot) ------------------------

    def state_dict(self) -> dict:
        return {"schema_version": ACCOUNTING_SCHEMA_VERSION,
                "last_window": self._last_window,
                "byte_hist": [[t, b] for t, b in self._byte_hist]}

    def load_state(self, state: dict) -> None:
        self._last_window = int(state["last_window"])
        self._byte_hist = [(float(t), float(b))
                           for t, b in state["byte_hist"]]
        # samples are NOT restored: like alerts, a resumed run re-emits
        # only its suffix — the cursor above keeps the timing identical
        self.samples = []


__all__ = ["CapacityAccountant", "ACCOUNTING_SCHEMA_VERSION"]
