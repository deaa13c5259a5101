"""Service telemetry for the streaming control plane.

The engine calls the ``on_*`` hooks as events happen; the sink aggregates
them into the metrics a service operator watches:

  * per-tenant regret — ``z(x*) - z(best observed)`` at session end, plus
    the max over live tenants (the streaming analogue of the paper's
    max-over-tenants / global-happiness regret);
  * fairness — time-since-served per tenant (gap between consecutive
    observations for the same tenant), distribution + worst case;
  * device utilization — busy seconds over in-service windows, per device
    and fleet-wide, plus the *speed-weighted* fleet utilization
    (Σ busy_d·speed_d / Σ window_d·speed_d) — on a heterogeneous fleet an
    idle fast device hurts more than an idle slow one (DESIGN.md §11);
  * admission-queue depth over time (admission control backpressure);
  * time-to-first-observation per session, p50/p99.

``summary()`` returns a plain dict; ``to_json(path)`` writes it.  The port's
copy of ``repro.stream.telemetry``: the same hooks, state and summary.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


@dataclass
class _TenantStats:
    arrived: float
    admitted: float | None = None
    departed: float | None = None
    first_obs: float | None = None
    last_served: float | None = None
    num_obs: int = 0
    best_z: float = -np.inf
    best_possible: float = -np.inf
    serve_gaps: list[float] = field(default_factory=list)


@dataclass
class _DeviceStats:
    joined: float
    speed: float
    left: float | None = None
    busy_seconds: float = 0.0
    trials: int = 0
    initial: bool = False    # part of the t=0 fleet (vs a runtime join)


def _pct(values, q) -> float | None:
    """Percentile over the finite entries, or an explicit None.

    Callers accumulate gaps/latencies incrementally and edge cases (tenant
    departing before its first observation, a missing sample recorded as
    None) can leave None or ±inf in the list — filter rather than let
    ``np.percentile`` fold them into NaN/-inf in ``summary()``."""
    clean = [v for v in values
             if v is not None and np.isfinite(v)]
    return float(np.percentile(clean, q)) if clean else None


class TelemetrySink:
    """Aggregates engine events into service-level metrics (module docstring)."""

    def __init__(self):
        self.tenants: dict[int, _TenantStats] = {}
        self.devices: dict[int, _DeviceStats] = {}
        self.queue_depth_samples: list[tuple[float, int]] = []
        self.busy_seconds = 0.0
        self.num_trials = 0
        self.num_failed_trials = 0
        self.num_rejected_observations = 0
        self.num_preemptions = 0
        # failure-domain lifecycle (DESIGN.md §16)
        self.num_trials_timed_out = 0
        self.num_trials_retried = 0
        self.num_trials_abandoned = 0
        self.num_devices_quarantined = 0
        self.num_poisoned_observations = 0
        self.end_time = 0.0
        self.num_slices = 0

    # ---- hooks the engine drives ------------------------------------------

    def on_arrive(self, t: float, tenant_key: int, best_possible: float) -> None:
        self.tenants[tenant_key] = _TenantStats(
            arrived=t, best_possible=best_possible)

    def on_admit(self, t: float, tenant_key: int) -> None:
        st = self.tenants[tenant_key]
        st.admitted = t
        st.last_served = t   # staleness clock starts at admission

    def on_depart(self, t: float, tenant_key: int) -> None:
        # a tenant can depart before the sink ever saw it (e.g. a trace
        # replayed from mid-stream) — ignore rather than KeyError
        st = self.tenants.get(tenant_key)
        if st is not None:
            st.departed = t

    def on_queue_depth(self, t: float, depth: int) -> None:
        self.queue_depth_samples.append((t, depth))

    def on_launch(self, t: float, tenant_key: int, model: int, device: int,
                  duration: float) -> None:
        self.num_trials += 1
        ds = self.devices.get(device)
        if ds is not None:
            ds.trials += 1

    # ---- device lifecycle (the elastic device plane, DESIGN.md §11) --------

    def on_device_join(self, t: float, device: int, speed: float,
                       initial: bool = False) -> None:
        """A slice enters service (the engine registers the initial fleet
        with ``initial=True`` at t=0; elastic joins as they land)."""
        self.devices[device] = _DeviceStats(joined=t, speed=speed,
                                            initial=initial)

    def on_device_leave(self, t: float, device: int) -> None:
        ds = self.devices.get(device)
        if ds is not None:
            ds.left = t

    def on_preemption(self, t: float, tenant_key: int, model: int,
                      busy_seconds: float, device: int | None = None) -> None:
        """A trial was evicted by a preemption (counted separately from
        failures; the occupied time still counts as busy)."""
        self.num_preemptions += 1
        self._add_busy(busy_seconds, device)

    def _add_busy(self, seconds: float, device: int | None) -> None:
        self.busy_seconds += seconds
        if device is not None:
            ds = self.devices.get(device)
            if ds is not None:
                ds.busy_seconds += seconds

    def on_observation(self, t: float, tenant_key: int, model: int,
                       z: float, duration: float,
                       device: int | None = None) -> None:
        self._add_busy(duration, device)
        st = self.tenants.get(tenant_key)
        if st is None:
            return
        if st.first_obs is None:
            st.first_obs = t
        if st.last_served is not None:
            st.serve_gaps.append(t - st.last_served)
        st.last_served = t
        st.num_obs += 1
        st.best_z = max(st.best_z, z)

    def on_trial_failed(self, t: float, tenant_key: int, model: int,
                        busy_seconds: float, device: int | None = None) -> None:
        self.num_failed_trials += 1
        self._add_busy(busy_seconds, device)   # occupied until death

    def on_rejected_observation(self, t: float, tenant_key: int,
                                duration: float,
                                device: int | None = None) -> None:
        """A trial finished after its tenant departed — result discarded,
        but the slice was busy for the full duration."""
        self.num_rejected_observations += 1
        self._add_busy(duration, device)

    # ---- failure-domain lifecycle (DESIGN.md §16) ---------------------------

    def on_trial_timeout(self, t: float, tenant_key: int, model: int,
                         busy_seconds: float, device: int | None = None,
                         retrying: bool = False) -> None:
        """Trial supervision killed a straggler at its deadline.  The device
        was occupied until the kill; ``retrying=False`` means the model's
        retry budget is exhausted — it is abandoned (never observed)."""
        self.num_trials_timed_out += 1
        if not retrying:
            self.num_trials_abandoned += 1
        self._add_busy(busy_seconds, device)

    def on_trial_retry(self, t: float, tenant_key: int, model: int,
                       attempt: int) -> None:
        """A timed-out model's backoff expired and it re-entered the launch
        queue (attempt counts from 1)."""
        self.num_trials_retried += 1

    def on_quarantine(self, t: float, device: int) -> None:
        """The device scoreboard quarantined ``device`` (strike threshold)."""
        self.num_devices_quarantined += 1

    def on_poisoned_observation(self, t: float, tenant_key: int, model: int,
                                duration: float,
                                device: int | None = None) -> None:
        """A trial returned a non-finite loss; the GP-ingest guard rejected
        it.  The slice was busy for the full duration."""
        self.num_poisoned_observations += 1
        self._add_busy(duration, device)

    def on_end(self, t: float, num_slices: int) -> None:
        self.end_time = t
        self.num_slices = num_slices

    # ---- snapshot / restore (the event-sourced engine, DESIGN.md §12) ------

    def state_dict(self) -> dict:
        """Full sink state as a JSON-able dict.  Floats survive the JSON
        round trip exactly (repr-based), including the ±inf sentinels, so a
        restored sink's aggregates are byte-identical — the crash-anywhere
        oracle compares ``summary()`` / ``per_tenant()`` outputs directly."""
        return {
            "tenants": {str(k): [st.arrived, st.admitted, st.departed,
                                 st.first_obs, st.last_served, st.num_obs,
                                 st.best_z, st.best_possible,
                                 list(st.serve_gaps)]
                        for k, st in self.tenants.items()},
            "devices": {str(k): [ds.joined, ds.speed, ds.left,
                                 ds.busy_seconds, ds.trials, ds.initial]
                        for k, ds in self.devices.items()},
            "queue_depth_samples": [[t, d]
                                    for t, d in self.queue_depth_samples],
            "busy_seconds": self.busy_seconds,
            "num_trials": self.num_trials,
            "num_failed_trials": self.num_failed_trials,
            "num_rejected_observations": self.num_rejected_observations,
            "num_preemptions": self.num_preemptions,
            "num_trials_timed_out": self.num_trials_timed_out,
            "num_trials_retried": self.num_trials_retried,
            "num_trials_abandoned": self.num_trials_abandoned,
            "num_devices_quarantined": self.num_devices_quarantined,
            "num_poisoned_observations": self.num_poisoned_observations,
            "end_time": self.end_time,
            "num_slices": self.num_slices,
        }

    def load_state(self, d: dict) -> None:
        """Overwrite this sink with :meth:`state_dict` output.  Dict
        insertion order is preserved through JSON, which keeps the order-
        sensitive float reductions in ``summary()`` byte-stable."""
        self.tenants = {
            int(k): _TenantStats(arrived=v[0], admitted=v[1], departed=v[2],
                                 first_obs=v[3], last_served=v[4],
                                 num_obs=v[5], best_z=v[6],
                                 best_possible=v[7], serve_gaps=list(v[8]))
            for k, v in d["tenants"].items()}
        self.devices = {
            int(k): _DeviceStats(joined=v[0], speed=v[1], left=v[2],
                                 busy_seconds=v[3], trials=v[4], initial=v[5])
            for k, v in d["devices"].items()}
        self.queue_depth_samples = [(t, depth)
                                    for t, depth in d["queue_depth_samples"]]
        self.busy_seconds = d["busy_seconds"]
        self.num_trials = d["num_trials"]
        self.num_failed_trials = d["num_failed_trials"]
        self.num_rejected_observations = d["num_rejected_observations"]
        self.num_preemptions = d["num_preemptions"]
        # tolerant restore: pre-supervision snapshots lack these keys
        self.num_trials_timed_out = d.get("num_trials_timed_out", 0)
        self.num_trials_retried = d.get("num_trials_retried", 0)
        self.num_trials_abandoned = d.get("num_trials_abandoned", 0)
        self.num_devices_quarantined = d.get("num_devices_quarantined", 0)
        self.num_poisoned_observations = d.get("num_poisoned_observations", 0)
        self.end_time = d["end_time"]
        self.num_slices = d["num_slices"]

    # ---- aggregation -------------------------------------------------------

    def summary(self, now: float | None = None) -> dict:
        """The roll-up.  ``now`` substitutes for ``end_time`` while a run
        is still in progress (the health plane grades SLOs mid-run at
        sim-time ``now``); the default — end-of-run shape — is untouched,
        which the replay oracle's byte-identity leans on."""
        end_time = self.end_time if now is None else max(float(now),
                                                         self.end_time)
        served = [st for st in self.tenants.values() if st.first_obs is not None]
        ttfo = [st.first_obs - st.arrived for st in served]
        gaps = [g for st in self.tenants.values() for g in st.serve_gaps
                if g is not None and np.isfinite(g)]
        # a served tenant has >=1 observation so best_z is finite, but be
        # explicit: regret stays a finite number or is excluded — summary()
        # must stay json.dumps(..., allow_nan=False)-clean
        regrets = [st.best_possible - st.best_z for st in served
                   if np.isfinite(st.best_possible)
                   and np.isfinite(st.best_z)]
        admitted = [st for st in self.tenants.values() if st.admitted is not None]
        left_queued = [st for st in self.tenants.values()
                       if st.departed is not None and st.admitted is None]
        queue_max = max((d for _, d in self.queue_depth_samples), default=0)
        elapsed = max(end_time, 1e-12)
        # device windows: joined -> left (or end of run).  With the initial
        # fleet registered at t=0 and no churn this denominator equals the
        # legacy num_slices * elapsed.
        windows = {d: max((ds.left if ds.left is not None else end_time)
                          - ds.joined, 0.0)
                   for d, ds in self.devices.items()}
        wall = sum(windows.values())
        if self.devices:
            utilization = self.busy_seconds / max(wall, 1e-12)
            speed_wall = sum(w * self.devices[d].speed
                             for d, w in windows.items())
            speed_busy = sum(ds.busy_seconds * ds.speed
                             for ds in self.devices.values())
            speed_weighted = speed_busy / max(speed_wall, 1e-12)
        else:
            utilization = (self.busy_seconds / (self.num_slices * elapsed)
                           if self.num_slices else 0.0)
            speed_weighted = None
        return {
            "sessions": len(self.tenants),
            "sessions_admitted": len(admitted),
            "sessions_served": len(served),
            "sessions_departed_while_queued": len(left_queued),
            "trials": self.num_trials,
            "trials_failed": self.num_failed_trials,
            "trials_preempted": self.num_preemptions,
            "trials_timed_out": self.num_trials_timed_out,
            "trials_retried": self.num_trials_retried,
            "trials_abandoned": self.num_trials_abandoned,
            "devices_quarantined": self.num_devices_quarantined,
            "observations_rejected": self.num_poisoned_observations,
            "observations_rejected_after_depart": self.num_rejected_observations,
            "end_time": end_time,
            "device_utilization": utilization,
            "speed_weighted_utilization": speed_weighted,
            "devices_joined": sum(1 for ds in self.devices.values()
                                  if not ds.initial),
            "devices_left": sum(1 for ds in self.devices.values()
                                if ds.left is not None),
            "queue_depth_max": queue_max,
            "ttfo_p50": _pct(ttfo, 50),
            "ttfo_p99": _pct(ttfo, 99),
            "serve_gap_p50": _pct(gaps, 50),
            "serve_gap_max": max(gaps, default=None),
            "tenant_regret_mean": float(np.mean(regrets)) if regrets else None,
            "tenant_regret_max": float(np.max(regrets)) if regrets else None,
        }

    def per_tenant(self) -> dict[int, dict]:
        out = {}
        for key, st in self.tenants.items():
            out[key] = {
                "arrived": st.arrived,
                "admitted": st.admitted,
                "departed": st.departed,
                "first_obs": st.first_obs,
                "num_obs": st.num_obs,
                "best_z": None if not np.isfinite(st.best_z) else st.best_z,
                "regret": (st.best_possible - st.best_z
                           if np.isfinite(st.best_possible)
                           and np.isfinite(st.best_z) else None),
            }
        return out

    def per_device(self) -> dict[int, dict]:
        """Per-device utilization: busy / in-service window, plus the
        speed-weighted view (busy*speed / window*speed == plain utilization
        per device; the *fleet* speed-weighted number in ``summary()`` is
        where the weights matter)."""
        out = {}
        for d, ds in self.devices.items():
            window = max((ds.left if ds.left is not None else self.end_time)
                         - ds.joined, 0.0)
            out[d] = {
                "joined": ds.joined,
                "left": ds.left,
                "speed": ds.speed,
                "trials": ds.trials,
                "busy_seconds": ds.busy_seconds,
                "utilization": ds.busy_seconds / window if window > 0 else 0.0,
            }
        return out

    def to_json(self, path: str | Path, include_tenants: bool = True,
                metrics=None, alerts=None) -> Path:
        """Write the sink payload; ``metrics`` (a
        ``repro_torch.obs.MetricsRegistry``) rides along under a
        ``"metrics"`` key in the same schema, and ``alerts`` (a list of
        ``repro_torch.obs.Alert`` records, e.g. ``HealthMonitor.alerts`` or
        the event log's durable ``alerts`` list) under ``"alerts"``.  Both
        are ride-alongs: ``summary()``/``state_dict()`` stay untouched, so
        the replay oracle's byte-identity never sees them.
        ``allow_nan=False`` is load-bearing: the summary must contain
        explicit nulls, never NaN/±inf."""
        payload = {"summary": self.summary()}
        if self.devices:
            payload["devices"] = {str(k): v
                                  for k, v in self.per_device().items()}
        if include_tenants:
            payload["tenants"] = {str(k): v for k, v in self.per_tenant().items()}
        if metrics is not None:
            payload["metrics"] = metrics.snapshot()
        if alerts is not None:
            payload["alerts"] = [a.to_record() if hasattr(a, "to_record")
                                 else a for a in alerts]
        path = Path(path)
        path.write_text(json.dumps(payload, indent=2, sort_keys=True,
                                   allow_nan=False))
        return path
