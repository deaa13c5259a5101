"""SLO burn-rate alerts and anomaly watchdogs over the streaming engines.

The port's copy of ``repro.obs.health`` (pure Python, as the reference's):
the same names, records and JSON, so the two packages' outputs compare
field by field.

The live half of the health story (DESIGN.md §14): where ``obs/report.py``
grades SLO attainment after the run, :class:`HealthMonitor` watches it
*during* the run and emits structured :class:`Alert` records the moment a
budget starts burning or a pathology pattern fires.

Every detector input is **sim-time-derived** — queue depth, launch/
observation events, telemetry summaries (themselves computed from sim
timestamps), and the GP Cholesky pivot ``d²`` (a pure function of the
folded observations).  Wall-clock series (decision latency histograms)
are deliberately *not* inputs: alert content must be a pure function of
the event stream so a crash-recovered run re-emits the identical alert
sequence for its replayed suffix.  Detector state (stall counters, armed
flags, window cursors) has ``state_dict``/``load_state`` and rides in the
engine snapshot; emitted alerts stream to the event log's durable
``alerts.jsonl``, so ``prefix-from-log + suffix-from-resume`` equals the
uninterrupted run's alert list exactly (tests/test_eventlog.py).

Detectors:

* **slo_burn** — at every ``window``-second sim-time boundary, grade the
  telemetry summary against the ``meta["slo"]`` targets (utilization
  targets are floors, latency/regret targets are ceilings — the
  ``report.py`` semantics) and track the violating-window fraction over
  the last ``burn_windows`` windows; alert when it reaches
  ``burn_threshold`` (severity ``page`` when *every* window burned).
* **regret_stall** — a tenant whose incumbent has not improved for
  ``stall_k`` consecutive observations while its trials keep burning
  budget; re-arms on the next improvement.
* **queue_runaway** — admission-queue depth crosses ``queue_limit`` while
  rising; re-arms once depth drains below half the limit.
* **class_starvation** — a device class with free capacity and a nonempty
  backlog that has not launched a trial for ``starvation_window``
  sim-seconds; re-arms on its next launch.
* **gp_conditioning** — the incremental Cholesky pivot ``d²`` for a fold
  dropped to within ``conditioning_scale`` of the jitter floor: the
  posterior update is numerically degenerate (near-duplicate model under
  the kernel), deduped to one alert per tenant per window.
* **memory_runaway** — the capacity plane's projected posterior bytes at
  its horizon (``obs/accounting.py``, a pure function of the event
  stream) crossed ``memory_budget_bytes``: the admission rate is
  outrunning the memory budget and will blow it *before* it actually
  does.  Severity ``page`` once current bytes already exceed the budget;
  re-arms when the projection drops back under 80% of it.

Failure-domain detectors (DESIGN.md §16), fed by trial supervision and
the device quarantine scoreboard:

* **straggler** — trial supervision killed a trial at its deadline; the
  device is producing overruns.  Deduped to one alert per device per
  sim-time window.
* **retry_storm** — ``retry_storm_k`` or more backoff re-queues landed
  inside one sliding ``window``: the fleet is thrashing on retries
  instead of making progress (severity ``page``); re-arms once the
  windowed count drains to half the threshold.
* **quarantine_flap** — the same device got quarantined twice within
  ``flap_window`` sim-seconds: probation keeps re-admitting a device
  that keeps failing (severity ``page``), deduped per device per window.
* **poisoned_observation** — the GP-ingest guard rejected a non-finite
  loss (every occurrence alerts: poisoned losses are rare and each one
  is a diverged training run someone should look at).
"""

from __future__ import annotations

from dataclasses import dataclass, field

HEALTH_SCHEMA_VERSION = 1

#: alert kinds, in severity-report order
ALERT_KINDS = ("slo_burn", "regret_stall", "queue_runaway",
               "class_starvation", "gp_conditioning", "memory_runaway",
               "straggler", "retry_storm", "quarantine_flap",
               "poisoned_observation")


@dataclass(frozen=True)
class Alert:
    """One structured health event — JSON-able via :meth:`to_record`."""

    t: float
    event_index: int
    kind: str           # one of ALERT_KINDS
    severity: str       # "warn" | "page"
    subject: str        # tenant key / slo key / device class
    detail: dict = field(default_factory=dict)

    def to_record(self) -> dict:
        return {"schema_version": HEALTH_SCHEMA_VERSION,
                "t": self.t, "event_index": self.event_index,
                "kind": self.kind, "severity": self.severity,
                "subject": self.subject, "detail": self.detail}

    @classmethod
    def from_record(cls, rec: dict) -> "Alert":
        return cls(t=rec["t"], event_index=rec["event_index"],
                   kind=rec["kind"], severity=rec["severity"],
                   subject=rec["subject"], detail=dict(rec["detail"]))


def _slo_ok(key: str, val: float, target: float) -> bool:
    # report.py::_slo_section semantics: utilization targets are floors,
    # latency/regret targets are ceilings
    return val >= target if "utilization" in key else val <= target


class HealthMonitor:
    """Rule-based watchdog fed per-event by the engine pop loops.

    Construct with the run's SLO table (same shape as the report plane's
    ``meta["slo"]``) and hand to ``StreamEngine(health=...)``.  All
    thresholds are sim-time/count-valued so alerting is deterministic.
    """

    def __init__(self, slo: dict | None = None, *, window: float = 20.0,
                 burn_windows: int = 3, burn_threshold: float = 0.75,
                 stall_k: int = 12, queue_limit: int = 16,
                 starvation_window: float = 30.0,
                 conditioning_scale: float = 10.0,
                 memory_budget_bytes: float | None = None,
                 retry_storm_k: int = 4,
                 flap_window: float | None = None):
        if window <= 0:
            raise ValueError("window must be positive")
        self.slo = dict(slo or {})
        self.window = float(window)
        self.burn_windows = int(burn_windows)
        self.burn_threshold = float(burn_threshold)
        self.stall_k = int(stall_k)
        self.queue_limit = int(queue_limit)
        self.starvation_window = float(starvation_window)
        self.conditioning_scale = float(conditioning_scale)
        self.memory_budget_bytes = (None if memory_budget_bytes is None
                                    else float(memory_budget_bytes))
        self.retry_storm_k = int(retry_storm_k)
        self.flap_window = (10.0 * self.window if flap_window is None
                            else float(flap_window))

        self.alerts: list[Alert] = []
        self._drained = 0
        # detector state — everything here must round-trip state_dict()
        self._last_window = -1
        self._slo_hist: dict[str, list[int]] = {}   # key -> recent 0/1 fails
        self._slo_armed: dict[str, bool] = {}
        self._stall: dict[str, int] = {}            # tenant -> obs since improve
        self._stall_armed: dict[str, bool] = {}
        self._queue_prev = 0
        self._queue_armed = True
        self._class_last: dict[str, float] = {}     # cls -> last launch/seen t
        self._class_armed: dict[str, bool] = {}
        self._cond_last_window: dict[str, int] = {}  # tenant -> window
        self._mem_armed = True
        # failure-domain detector state (DESIGN.md §16)
        self._straggler_last_window: dict[str, int] = {}  # device -> window
        self._retry_times: list[float] = []          # retries inside window
        self._retry_armed = True
        self._flap_times: dict[str, list[float]] = {}   # device -> quarantines
        self._flap_last_window: dict[str, int] = {}

    # -- emission ---------------------------------------------------------

    def _alert(self, t: float, event_index: int, kind: str, severity: str,
               subject: str, **detail) -> None:
        self.alerts.append(Alert(float(t), int(event_index), kind, severity,
                                 str(subject), detail))

    def drain_new(self) -> list[Alert]:
        """Alerts appended since the last drain — the engine forwards these
        to the durable event log."""
        new = self.alerts[self._drained:]
        self._drained = len(self.alerts)
        return new

    # -- engine feeds -----------------------------------------------------

    def on_launch(self, t: float, event_index: int, tenant, model: int,
                  cls: str) -> None:
        self._class_last[cls] = float(t)
        self._class_armed[cls] = True

    def on_observation(self, t: float, event_index: int, tenant,
                       improved: bool, d2: float | None = None,
                       jitter: float | None = None,
                       model: int = -1) -> None:
        key = str(tenant)
        if improved:
            self._stall[key] = 0
            self._stall_armed[key] = True
        else:
            n = self._stall.get(key, 0) + 1
            self._stall[key] = n
            if (n >= self.stall_k
                    and self._stall_armed.setdefault(key, True)):
                self._stall_armed[key] = False
                self._alert(t, event_index, "regret_stall", "warn", key,
                            observations_since_improvement=n)
        if d2 is not None and jitter is not None:
            if d2 <= self.conditioning_scale * jitter:
                w = int(t // self.window)
                if self._cond_last_window.get(key) != w:
                    self._cond_last_window[key] = w
                    self._alert(t, event_index, "gp_conditioning", "warn",
                                key, model=int(model), d2=float(d2),
                                jitter=float(jitter))

    # -- failure-domain feeds (DESIGN.md §16) ------------------------------

    def on_timeout(self, t: float, event_index: int, device, tenant,
                   overrun: float = 0.0) -> None:
        """Trial supervision killed a straggler on ``device`` — one
        ``straggler`` alert per device per sim-time window."""
        key = str(device)
        w = int(t // self.window)
        if self._straggler_last_window.get(key) != w:
            self._straggler_last_window[key] = w
            self._alert(t, event_index, "straggler", "warn", key,
                        tenant=str(tenant), overrun_seconds=float(overrun))

    def on_retry(self, t: float, event_index: int, tenant, model: int,
                 attempt: int) -> None:
        """A backoff re-queue landed; ``retry_storm_k`` of them inside one
        sliding window pages (the fleet is thrashing, not progressing)."""
        self._retry_times.append(float(t))
        self._retry_times = [x for x in self._retry_times
                             if t - x <= self.window]
        n = len(self._retry_times)
        if n >= self.retry_storm_k and self._retry_armed:
            self._retry_armed = False
            self._alert(t, event_index, "retry_storm", "page", "fleet",
                        retries_in_window=int(n), window=self.window,
                        limit=self.retry_storm_k)
        elif n <= self.retry_storm_k // 2:
            self._retry_armed = True

    def on_quarantine(self, t: float, event_index: int, device,
                      count: int = 1) -> None:
        """The scoreboard quarantined ``device``; a second quarantine of the
        same device within ``flap_window`` means probation keeps re-admitting
        a bad device — the flap alert, deduped per device per window."""
        key = str(device)
        times = self._flap_times.setdefault(key, [])
        times.append(float(t))
        self._flap_times[key] = times = [x for x in times
                                         if t - x <= self.flap_window]
        if len(times) >= 2:
            w = int(t // self.window)
            if self._flap_last_window.get(key) != w:
                self._flap_last_window[key] = w
                self._alert(t, event_index, "quarantine_flap", "page", key,
                            quarantines_in_window=len(times),
                            flap_window=self.flap_window,
                            total_quarantines=int(count))

    def on_poisoned(self, t: float, event_index: int, tenant,
                    model: int) -> None:
        """The GP-ingest guard rejected a non-finite loss."""
        self._alert(t, event_index, "poisoned_observation", "warn",
                    str(tenant), model=int(model))

    def on_capacity(self, t: float, event_index: int, *, bytes_now: float,
                    projected_bytes: float) -> None:
        """Fed by the capacity accountant at its sample boundaries (so the
        input cadence — and thus the alert sequence — is a pure function of
        the event stream).  No-op without a configured budget."""
        budget = self.memory_budget_bytes
        if budget is None:
            return
        if projected_bytes >= budget:
            if self._mem_armed:
                self._mem_armed = False
                self._alert(t, event_index, "memory_runaway",
                            "page" if bytes_now >= budget else "warn",
                            "gp_posterior",
                            bytes_now=float(bytes_now),
                            projected_bytes=float(projected_bytes),
                            budget_bytes=float(budget))
        elif projected_bytes <= 0.8 * budget:
            self._mem_armed = True

    def on_event(self, t: float, event_index: int, *, queue_depth: int,
                 backlog: int, free_classes: tuple[str, ...] = (),
                 summary_fn=None) -> None:
        """Once per processed event, after the engine's own bookkeeping."""
        # queue runaway: depth crossing the limit while rising
        if (queue_depth >= self.queue_limit
                and queue_depth > self._queue_prev and self._queue_armed):
            self._queue_armed = False
            self._alert(t, event_index, "queue_runaway", "page", "admission",
                        depth=int(queue_depth), limit=self.queue_limit)
        elif queue_depth <= self.queue_limit // 2:
            self._queue_armed = True
        self._queue_prev = int(queue_depth)

        # device-class starvation: free capacity + backlog, but no launch
        # on this class for a full starvation window.  With no backlog the
        # class is idle by lack of demand, not starvation — the clock
        # restarts, so ``idle_for`` only accumulates demand-present time
        # (as observed at event ticks).
        if backlog > 0:
            for cls in free_classes:
                last = self._class_last.setdefault(cls, float(t))
                if (t - last >= self.starvation_window
                        and self._class_armed.setdefault(cls, True)):
                    self._class_armed[cls] = False
                    self._alert(t, event_index, "class_starvation", "warn",
                                cls, idle_for=float(t - last),
                                backlog=int(backlog))
        else:
            for cls in free_classes:
                self._class_last[cls] = float(t)

        # SLO burn rate, evaluated at window boundaries only
        w = int(t // self.window)
        if w > self._last_window and self.slo and summary_fn is not None:
            self._last_window = w
            summary = summary_fn()
            for key, target in self.slo.items():
                if target is None:
                    continue
                val = summary.get(key)
                if val is None:
                    continue
                hist = self._slo_hist.setdefault(key, [])
                hist.append(0 if _slo_ok(key, val, target) else 1)
                del hist[:-self.burn_windows]
                burn = sum(hist) / len(hist)
                if hist[-1] == 0:
                    self._slo_armed[key] = True
                elif (len(hist) >= self.burn_windows
                        and burn >= self.burn_threshold
                        and self._slo_armed.setdefault(key, True)):
                    self._slo_armed[key] = False
                    self._alert(t, event_index, "slo_burn",
                                "page" if burn >= 1.0 else "warn", key,
                                burn_rate=float(burn), value=float(val),
                                target=float(target))

    # -- persistence (rides in the engine snapshot) -----------------------

    def state_dict(self) -> dict:
        return {
            "schema_version": HEALTH_SCHEMA_VERSION,
            "last_window": self._last_window,
            "slo_hist": {k: list(v) for k, v in self._slo_hist.items()},
            "slo_armed": dict(self._slo_armed),
            "stall": dict(self._stall),
            "stall_armed": dict(self._stall_armed),
            "queue_prev": self._queue_prev,
            "queue_armed": self._queue_armed,
            "class_last": dict(self._class_last),
            "class_armed": dict(self._class_armed),
            "cond_last_window": dict(self._cond_last_window),
            "mem_armed": self._mem_armed,
            "straggler_last_window": dict(self._straggler_last_window),
            "retry_times": list(self._retry_times),
            "retry_armed": self._retry_armed,
            "flap_times": {k: list(v) for k, v in self._flap_times.items()},
            "flap_last_window": dict(self._flap_last_window),
        }

    def load_state(self, state: dict) -> None:
        self._last_window = int(state["last_window"])
        self._slo_hist = {k: list(v) for k, v in state["slo_hist"].items()}
        self._slo_armed = {k: bool(v)
                           for k, v in state["slo_armed"].items()}
        self._stall = {k: int(v) for k, v in state["stall"].items()}
        self._stall_armed = {k: bool(v)
                             for k, v in state["stall_armed"].items()}
        self._queue_prev = int(state["queue_prev"])
        self._queue_armed = bool(state["queue_armed"])
        self._class_last = {k: float(v)
                            for k, v in state["class_last"].items()}
        self._class_armed = {k: bool(v)
                             for k, v in state["class_armed"].items()}
        self._cond_last_window = {k: int(v) for k, v
                                  in state["cond_last_window"].items()}
        # tolerant of pre-capacity-plane snapshots (no mem_armed key)
        self._mem_armed = bool(state.get("mem_armed", True))
        # tolerant of pre-supervision snapshots (no failure-domain keys)
        self._straggler_last_window = {
            k: int(v) for k, v
            in state.get("straggler_last_window", {}).items()}
        self._retry_times = [float(x) for x in state.get("retry_times", [])]
        self._retry_armed = bool(state.get("retry_armed", True))
        self._flap_times = {k: [float(x) for x in v] for k, v
                            in state.get("flap_times", {}).items()}
        self._flap_last_window = {k: int(v) for k, v
                                  in state.get("flap_last_window", {}).items()}
        # alerts are NOT restored: the durable prefix lives in the event
        # log's alerts.jsonl; a resumed run re-emits only its suffix
        self.alerts = []
        self._drained = 0


__all__ = ["Alert", "HealthMonitor", "ALERT_KINDS",
           "HEALTH_SCHEMA_VERSION"]
