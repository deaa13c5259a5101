"""Append-only event log + crash/recovery plumbing for the streaming engine.

The port's counterpart of ``repro.stream.eventlog``: the same JSONL streams
and records, so a log written by either package replays in the other.

The streaming control plane is deterministic: given a trace, a config, and a
seed, every decision, trial, and telemetry sample is a pure fold over the
event sequence.  This module makes that fold *durable* and *restartable*
(DESIGN.md §12):

* :class:`EventLog` — the append-only log.  Two streams:

    - **external** events (:class:`~repro_torch.stream.workload.TenantArrive` /
      ``TenantDepart`` / ``SliceFail`` / ``DeviceJoin`` / ``DeviceLeave`` /
      ``DevicePreempt``), serialized losslessly (float64 arrays round-trip
      exactly through JSON's repr-based floats) — the replayable input;
    - **processed** records ``(index, t, kind, payload)`` — one per heap pop
      the engine handled, in order.  These are the *audit* stream: a restored
      engine regenerates the suffix, and any divergence from the pre-crash
      records pinpoints the first event where replay went wrong.  With
      tracing enabled the record grows a fifth field, the obs-plane trace id
      (``repro_torch.obs.Tracer``), correlating each audit record with its span
      tree; untraced runs keep the 4-field shape.

  With a directory the log is write-through (flushed per append); without
  one it is in-memory only (every engine gets one by default).

  A third, optional stream carries the health plane's **alerts**
  (``alerts.jsonl``): structured records from
  ``repro_torch.obs.HealthMonitor``, appended by the engine as they fire.
  Alert *content* is a pure function of the event stream (sim-time inputs
  only — DESIGN.md §14), so the durable prefix plus a recovered run's
  re-emitted suffix reproduces the uninterrupted run's alert sequence
  exactly.  The file only exists for runs with a health monitor attached;
  its absence keeps old logs loading unchanged (no schema bump).

* :class:`FaultInjector` / :class:`SimulatedCrash` — the crash-anywhere
  hook.  The engine calls ``check(point)`` at its fault points (``before`` /
  ``after`` each event, ``mid_compact``, ``mid_launch``); the injector
  raises at the first matching point at/after ``crash_index``.  Tests sweep
  ``crash_index`` over every event of a trace (tests/test_eventlog.py).

* :func:`recover` — snapshot + replay: rebuild an engine from the latest
  checkpoint (written through ``repro_torch.checkpoint.store``, the
  reference's layout) and the log's external events, ready to
  :meth:`~repro_torch.stream.engine.StreamEngine.resume`.
  The universal correctness property — ``snapshot + replay(suffix) ==
  uninterrupted run`` — is what every engine must satisfy.

* :func:`first_divergence` — compare two processed streams; the dict it
  returns is the replay-divergence artifact CI uploads on failure.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..checkpoint.store import CheckpointError, latest_step, load_arrays
from .workload import (
    DeviceJoin,
    DeviceLeave,
    DevicePreempt,
    Event,
    MeshShrink,
    SliceFail,
    TenantArrive,
    TenantDepart,
    TrialHang,
    TrialPoison,
)

LOG_SCHEMA_VERSION = 1


# ---- event (de)serialization ------------------------------------------------
# JSON floats are repr-round-trip exact for float64, so every array and
# timestamp survives serialize -> deserialize bit-identically — the replay
# oracle's byte-identical claim rests on this.

def serialize_event(ev: Event) -> dict:
    if not isinstance(ev, (TenantArrive, TenantDepart, SliceFail,
                           DeviceJoin, DeviceLeave, DevicePreempt,
                           TrialHang, TrialPoison, MeshShrink)):
        raise TypeError(f"unknown event {ev!r}")
    d: dict = {"type": type(ev).__name__, "at": float(ev.at)}
    if isinstance(ev, TenantArrive):
        d.update(tenant_key=int(ev.tenant_key),
                 K_block=np.asarray(ev.K_block, np.float64).tolist(),
                 mu0=np.asarray(ev.mu0, np.float64).tolist(),
                 cost=np.asarray(ev.cost, np.float64).tolist(),
                 z_true=np.asarray(ev.z_true, np.float64).tolist())
    elif isinstance(ev, TenantDepart):
        d.update(tenant_key=int(ev.tenant_key))
    elif isinstance(ev, SliceFail):
        d.update(slice_id=int(ev.slice_id), downtime=float(ev.downtime))
    elif isinstance(ev, DeviceJoin):
        d.update(chips=int(ev.chips), speed=float(ev.speed), cls=ev.cls)
    elif isinstance(ev, (DeviceLeave, DevicePreempt, TrialHang, TrialPoison)):
        d.update(slice_id=int(ev.slice_id))
    elif isinstance(ev, MeshShrink):
        d.update(num_shards=int(ev.num_shards))
    else:
        raise TypeError(f"unknown event {ev!r}")
    return d


def deserialize_event(d: dict) -> Event:
    t = d["type"]
    if t == "TenantArrive":
        return TenantArrive(
            at=d["at"], tenant_key=d["tenant_key"],
            K_block=np.asarray(d["K_block"], np.float64),
            mu0=np.asarray(d["mu0"], np.float64),
            cost=np.asarray(d["cost"], np.float64),
            z_true=np.asarray(d["z_true"], np.float64))
    if t == "TenantDepart":
        return TenantDepart(at=d["at"], tenant_key=d["tenant_key"])
    if t == "SliceFail":
        return SliceFail(at=d["at"], slice_id=d["slice_id"],
                         downtime=d["downtime"])
    if t == "DeviceJoin":
        return DeviceJoin(at=d["at"], chips=d["chips"], speed=d["speed"],
                          cls=d["cls"])
    if t == "DeviceLeave":
        return DeviceLeave(at=d["at"], slice_id=d["slice_id"])
    if t == "DevicePreempt":
        return DevicePreempt(at=d["at"], slice_id=d["slice_id"])
    if t == "TrialHang":
        return TrialHang(at=d["at"], slice_id=d["slice_id"])
    if t == "TrialPoison":
        return TrialPoison(at=d["at"], slice_id=d["slice_id"])
    if t == "MeshShrink":
        return MeshShrink(at=d["at"], num_shards=d["num_shards"])
    raise TypeError(f"unknown event type {t!r}")


# ---- the log ----------------------------------------------------------------

class EventLog:
    """Append-only external + processed event streams (module docstring).

    ``path=None`` keeps everything in memory; with a directory every append
    is written through (``external.jsonl`` / ``processed.jsonl`` /
    ``meta.json``), and :meth:`load` reads a directory back into memory.
    """

    def __init__(self, path: str | Path | None = None):
        self.path = Path(path) if path is not None else None
        self.meta: dict = {"schema_version": LOG_SCHEMA_VERSION}
        self.external: list[Event] = []
        self.processed: list[tuple[int, float, str, list]] = []
        self.alerts: list[dict] = []
        self._ext_f = self._proc_f = self._alert_f = None
        if self.path is not None:
            self.path.mkdir(parents=True, exist_ok=True)
            self._write_meta()
            self._ext_f = open(self.path / "external.jsonl", "a")
            self._proc_f = open(self.path / "processed.jsonl", "a")

    def _write_meta(self) -> None:
        if self.path is not None:
            (self.path / "meta.json").write_text(json.dumps(self.meta))

    def set_meta(self, **kw) -> None:
        self.meta.update(kw)
        self._write_meta()

    def append_external(self, ev: Event) -> None:
        self.external.append(ev)
        if self._ext_f is not None:
            self._ext_f.write(json.dumps(serialize_event(ev)) + "\n")
            self._ext_f.flush()

    def append_processed(self, index: int, t: float, kind: str,
                         data: list, trace: int | None = None) -> None:
        # ``trace`` is the obs-plane correlation key (the Tracer's trace id
        # for this event).  It is only materialized when tracing is on, so
        # untraced runs keep the 4-field record shape byte-for-byte.
        rec = ((index, float(t), kind, data) if trace is None
               else (index, float(t), kind, data, trace))
        self.processed.append(rec)
        if self._proc_f is not None:
            self._proc_f.write(json.dumps(rec) + "\n")
            self._proc_f.flush()

    def append_alert(self, record: dict) -> None:
        """Durable health-alert stream (``alerts.jsonl``), write-through
        like the others.  The file is created lazily on the first alert so
        health-less runs leave no empty stream behind."""
        self.alerts.append(record)
        if self.path is not None:
            if self._alert_f is None:
                self._alert_f = open(self.path / "alerts.jsonl", "a")
            self._alert_f.write(json.dumps(record, allow_nan=False) + "\n")
            self._alert_f.flush()

    def external_events(self) -> list[Event]:
        return list(self.external)

    def close(self) -> None:
        for f in (self._ext_f, self._proc_f, self._alert_f):
            if f is not None:
                f.close()
        self._ext_f = self._proc_f = self._alert_f = None

    @classmethod
    def load(cls, path: str | Path) -> "EventLog":
        """Read a durable log directory back into an in-memory log (the
        recovery path: the restored engine appends to its *own* fresh log,
        so the pre-crash files are never mutated)."""
        path = Path(path)
        log = cls()
        meta = json.loads((path / "meta.json").read_text())
        version = meta.get("schema_version")
        if version != LOG_SCHEMA_VERSION:
            raise ValueError(f"event log {path} has schema_version "
                             f"{version!r}, this build reads "
                             f"{LOG_SCHEMA_VERSION}")
        log.meta = meta
        ext = path / "external.jsonl"
        if ext.exists():
            with open(ext) as f:
                log.external = [deserialize_event(json.loads(line))
                                for line in f if line.strip()]
        proc = path / "processed.jsonl"
        if proc.exists():
            with open(proc) as f:
                log.processed = [tuple(json.loads(line))
                                 for line in f if line.strip()]
        al = path / "alerts.jsonl"
        if al.exists():
            with open(al) as f:
                log.alerts = [json.loads(line) for line in f
                              if line.strip()]
        return log


def first_divergence(a: list[tuple], b: list[tuple],
                     start: int = 0) -> dict | None:
    """First index where two processed streams disagree (record-by-record,
    starting at list offset ``start``), or None.  The returned dict is the
    replay-divergence artifact tests write and CI uploads on failure."""
    n = min(len(a), len(b))
    for i in range(start, n):
        ra, rb = list(a[i]), list(b[i])
        if ra != rb:
            return {"offset": i, "a": ra, "b": rb}
    if len(a) != len(b):
        i = n
        return {"offset": i,
                "a": list(a[i]) if i < len(a) else None,
                "b": list(b[i]) if i < len(b) else None,
                "len_a": len(a), "len_b": len(b)}
    return None


# ---- fault injection --------------------------------------------------------

class SimulatedCrash(RuntimeError):
    """Raised by :class:`FaultInjector` at the injected crash point.  The
    engine's in-memory state is abandoned exactly as a process kill would
    abandon it; only the durable log + snapshots survive."""


@dataclass
class FaultInjector:
    """Crash once, at the first fault point named ``point`` reached at or
    after processed-event ``crash_index``.

    Points the engine exposes:
      * ``"before"``      — after popping event ``crash_index``, before any
                            handler ran;
      * ``"after"``       — after the event's handler, launch pass, and log
                            append, before the boundary snapshot;
      * ``"mid_compact"`` — inside ``_run_compaction``, after the control
                            plane relocated blocks but before the engine
                            remapped its queues (the classic torn write);
      * ``"mid_launch"``  — inside ``_launch_on``, after ``record_start``
                            but before the trial/completion event exists.
    """
    crash_index: int
    point: str = "before"
    fired: bool = False

    def check(self, point: str, event_index: int) -> None:
        if (not self.fired and point == self.point
                and event_index >= self.crash_index):
            self.fired = True
            raise SimulatedCrash(
                f"injected crash at event {event_index} ({point})")


# ---- recovery ---------------------------------------------------------------

def recover(factory, snapshot_root: str | Path | None, log: EventLog):
    """Snapshot + replay: rebuild an engine after a crash.

    ``factory`` must build a fresh engine with the *same configuration*
    (fleet, policy, seed, scorer, compaction knobs, ...) as the crashed one
    — configuration is the caller's code, not logged state.  The newest
    readable snapshot under ``snapshot_root`` seeds the state; with none,
    the engine replays from genesis by re-ingesting the log's external
    events.  Returns ``(engine, resumed_from_event_index)`` — call
    ``engine.resume()`` to run the suffix.

    A snapshot and log written by the reference package (``repro.stream``)
    recover here too: the layouts are the same, and since configuration is
    the factory's, the reference's scorer and route names never meet a
    check.
    """
    eng = factory()
    events = log.external_events()
    step = latest_step(snapshot_root) if snapshot_root is not None else None
    while step is not None:
        try:
            arrays, meta = load_arrays(snapshot_root, step)
            break
        except CheckpointError:
            # torn/corrupt snapshot: fall back toward genesis
            older = [s for s in _all_steps(snapshot_root) if s < step]
            step = max(older) if older else None
    if step is None:
        eng.begin(events, trace_name=log.meta.get("trace_name", "trace"))
        return eng, 0
    arrive_by_key = {ev.tenant_key: ev for ev in events
                     if isinstance(ev, TenantArrive)}
    eng._restore_state(arrays, meta, arrive_by_key)
    return eng, step


def _all_steps(root) -> list[int]:
    root = Path(root)
    if not root.exists():
        return []
    return [int(p.name.split("_")[1]) for p in root.glob("step_*")
            if not p.name.endswith(".tmp")]


__all__ = [
    "EventLog", "FaultInjector", "SimulatedCrash", "recover",
    "serialize_event", "deserialize_event", "first_divergence",
    "LOG_SCHEMA_VERSION",
]
