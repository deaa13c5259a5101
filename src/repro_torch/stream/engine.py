"""Event-driven streaming engine: online GP-EI over a Fleet under churn.

The loop generalizes ``scheduler.simulate`` from a closed episode to an open
service.  External events come from a :class:`~repro_torch.stream.workload.ChurnTrace`
(tenant arrivals/departures, slice failures); internal events are trial
completions and slice repairs.  All of them drive one shared
:class:`~repro_torch.core.control_plane.ControlPlane`:

  TenantArrive  -> admission control; if admitted, ``add_tenant`` appends the
                   tenant's GP block and its warm-start trials join the queue
  TenantDepart  -> ``retire_tenant`` frees the GP block; in-flight trials run
                   to completion but their observations are discarded
  TrialDone     -> ``record_observation`` (GP fold) + fairness accounting,
                   then the freed slice launches the next EIrate argmax
  SliceFail     -> the in-flight trial dies; its model returns to the
                   unselected pool (``record_failure``); the slice rejoins
                   after ``downtime``

Admission control caps the number of *live models* (sum of candidate-set
sizes over admitted, non-departed tenants): a tenant whose block would
exceed the cap waits in a FIFO queue and is admitted as departures free
capacity — queue depth is a telemetry series.

Index space under churn (DESIGN.md §10): the ControlPlane recycles model
and tenant slots, so a reused global model id can refer to a *new* tenant's
model while an old tenant's trial is still in flight — every completion /
failure therefore resolves its owner through the trial's ``tenant_key``
(stable forever), never through the model id.  With ``compact_every`` set,
the engine periodically asks the control plane to rebalance idle tenant
blocks across shard spans and remaps its own launch queue and ownership
maps from the returned old->new id mapping (in-flight models are pinned, so
pending completion events never go stale).

Equivalence contract (tested): replaying
:func:`~repro_torch.stream.workload.trace_from_problem` (all tenants at t=0, no
departures, no failures, no cap) reproduces ``scheduler.simulate``'s trial
sequence exactly for the deterministic policies, because both engines share
the ControlPlane decision core, the warm-start order, and the
free-device-stack pop order.  Simultaneous arrivals are therefore admitted
*before* any launch decision (matching the pre-built warm-start queue);
otherwise the engine launches greedily after every event, exactly like the
offline loop.

The port's counterpart of ``repro.stream.engine``: the same events, state,
snapshots and trial sequences.  ``device`` (None = the card, or
``device="cpu"``) holds the control plane.  The scorers are the port's:
``"ops"`` (the default; it decides as the reference's ``"fused"`` does) and
``"sharded"``.  The observability planes (``repro_torch.obs``: tracer,
metrics, exporter, health, forensics, accounting) attach where the
reference's do, with the same records; none of them changes a decision.
"""

from __future__ import annotations

import heapq
import time as _time
from dataclasses import dataclass, field

import numpy as np

from ..checkpoint.store import save_checkpoint
from ..core.control_plane import ControlPlane, tenant_warm_models
from ..core.fleet import DeviceSlice, Fleet
from ..core.scheduler import POLICIES
from ..obs import NULL_TRACER

from .eventlog import EventLog, FaultInjector
from .telemetry import TelemetrySink
from .workload import (ChurnTrace, MeshShrink, SliceFail, TenantArrive,
                       TenantDepart, TrialHang, TrialPoison)


@dataclass(frozen=True)
class StreamTrial:
    """One launched trial.  ``z is None`` means the trial died (slice
    failure) or was still in flight when the run ended."""
    model: int               # global model id in the ControlPlane's space
    tenant_key: int
    local_model: int         # index within the tenant's candidate set
    user_hint: int           # -2 warm start, -1 mdmt global, else tenant slot
    device: int
    start: float
    end: float
    z: float | None


@dataclass
class _TenantRuntime:
    key: int
    arrive: TenantArrive
    admitted_at: float | None = None
    departed: bool = False
    tenant_id: int | None = None      # ControlPlane slot once admitted
    model_start: int | None = None    # first global model id of the block


@dataclass
class StreamResult:
    trace_name: str
    policy: str
    num_devices: int
    trials: list[StreamTrial]
    end_time: float
    decisions: int
    decision_seconds: float
    telemetry: TelemetrySink
    tenants: dict[int, _TenantRuntime] = field(repr=False, default_factory=dict)
    compaction_moves: int = 0   # tenant blocks relocated by compact() passes
    policy_launches: int = 0    # launches decided by the policy (not warm
                                # start) — the decision-cost denominator

    @property
    def observations(self) -> list[tuple[float, int, float]]:
        """(finish_time, global model, z) for successful trials, time-ordered."""
        obs = [(t.end, t.model, t.z) for t in self.trials if t.z is not None]
        obs.sort()
        return obs


class StreamEngine:
    """Online multi-tenant GP-EI service over a Fleet (module docstring)."""

    LAUNCH_ORDERS = ("lifo", "fastest")

    def __init__(
        self,
        fleet: Fleet,
        policy: str = "mdmt",
        *,
        warm_start: int = 2,
        max_live_models: int | None = None,
        seed: int = 0,
        scorer: str = "ops",
        num_shards: int | None = None,
        score_kernel: str = "eirate_topk",
        compact_every: int | None = None,
        compact_imbalance: float | None = None,
        compact_max_moves: int | None = None,
        launch_order: str = "lifo",
        telemetry: TelemetrySink | None = None,
        log: EventLog | None = None,
        snapshot_root: str | None = None,
        snapshot_every: int | None = None,
        fault: FaultInjector | None = None,
        tracer=None,
        metrics=None,
        exporter=None,
        health=None,
        forensics=None,
        accounting=None,
        timeout_factor: float | None = None,
        max_retries: int = 2,
        retry_backoff: float = 1.0,
        device=None,
    ):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
        if launch_order not in self.LAUNCH_ORDERS:
            raise ValueError(f"launch_order must be one of "
                             f"{self.LAUNCH_ORDERS}, got {launch_order!r}")
        if timeout_factor is not None and timeout_factor <= 1.0:
            raise ValueError("timeout_factor must exceed 1.0 (the deadline "
                             f"is k x predicted seconds), got {timeout_factor}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if retry_backoff <= 0:
            raise ValueError(f"retry_backoff must be > 0, got {retry_backoff}")
        self.fleet = fleet
        self.policy = policy
        self.launch_order = launch_order
        self.warm_start = warm_start
        # trial supervision (DESIGN.md §16): with timeout_factor set, every
        # launch schedules a deadline at t + timeout_factor * predicted
        # duration; a trial that misses it is killed, its model re-queued
        # with exponential backoff up to max_retries attempts.  None keeps
        # the unsupervised engine byte-identical (no timeout events at all).
        self.timeout_factor = timeout_factor
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self.max_live_models = max_live_models
        self.compact_every = compact_every
        self.compact_imbalance = compact_imbalance
        self.compact_max_moves = compact_max_moves
        self.telemetry = telemetry or TelemetrySink()
        # event sourcing (DESIGN.md §12): every run appends its external
        # events and one processed record per handled event to the log; with
        # snapshot_root set, full-state snapshots land every snapshot_every
        # processed events through checkpoint/store.py
        self.log = log if log is not None else EventLog()
        self.snapshot_root = snapshot_root
        self.snapshot_every = snapshot_every
        self.fault = fault
        self.event_index = 0
        self.cp = ControlPlane(np.random.default_rng(seed), scorer=scorer,
                               num_shards=num_shards,
                               score_kernel=score_kernel, device=device)
        self._chooser = self.cp.chooser(policy)
        # observability (DESIGN.md §13): both planes are observation-only —
        # spans/metrics never enter snapshots or the replay oracle's
        # comparisons, and a traced run's trial sequence is byte-identical
        # to an untraced one (tested).  trace_id == event_index, so a
        # recovered run re-emits the replayed suffix's span tree exactly.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.cp.set_tracer(self.tracer)
        self.metrics = metrics
        if metrics is not None:
            self._m_events = metrics.counter("engine.events")
            self._m_launches = metrics.counter("engine.launches")
            self._m_decision_s = metrics.histogram("engine.decision_seconds")
            self._m_compact_s = metrics.histogram(
                "engine.compaction_pause_seconds")
            self._m_snapshot_s = metrics.histogram("engine.snapshot_seconds")
            self._m_queue = metrics.gauge("engine.queue_depth")
        # live health plane (DESIGN.md §14): exporter/health/forensics are
        # observation-only like the tracer — none of their outputs feed the
        # decision path — but the exporter's window cursor and the health
        # monitor's detector state ride in snapshot meta so a recovered
        # run re-emits the identical export/alert suffix.  Alerts stream
        # write-through to the log's durable alerts.jsonl per event.
        self.exporter = exporter
        self.health = health
        self.forensics = forensics
        self.cp.set_forensics(forensics)
        # capacity plane (DESIGN.md §15): same discipline — gauges never
        # feed a decision; the sample cursor + projection history ride in
        # snapshot meta.  When both planes run, the exporter also renders
        # the health monitor's alert counts on its scrape surface.
        self.accounting = accounting
        if exporter is not None and health is not None \
                and exporter.health is None:
            exporter.health = health
        # mirrors scheduler.simulate's free-device stack: initial pop order is
        # slice M-1, M-2, ...; freed slices are re-pushed on top
        self._free: list[int] = [s.slice_id for s in fleet.slices if s.healthy]
        self._heap: list[tuple[float, int, str, tuple]] = []
        self._seq = 0
        # warm-start launch queue: (tenant_key, global model id) — keyed so a
        # stale entry whose slot was recycled is detected and skipped
        self._pending: list[tuple[int, int]] = []
        self._admission_queue: list[_TenantRuntime] = []
        self._live_models = 0
        self._departures = 0
        self._tenants: dict[int, _TenantRuntime] = {}
        self._owner_of_model: dict[int, _TenantRuntime] = {}
        self._trials: list[StreamTrial] = []
        self._cancelled: set[int] = set()
        # failure-domain state (DESIGN.md §16): trial indices doomed to hang
        # (never finish) or return a poisoned loss, and per-model retry
        # budgets keyed (tenant_key, local_model) — stable across slot
        # recycling and mesh re-sharding, unlike global model ids
        self._hung: set[int] = set()
        self._poisoned: set[int] = set()
        self._retry_attempts: dict[tuple[int, int], int] = {}
        self._t = 0.0
        self._decisions = 0
        self._decision_seconds = 0.0
        self._policy_launches = 0
        self._compaction_moves = 0
        self.compaction_move_counts: list[int] = []  # blocks moved per call
        self._trace_name = "trace"

    # ---- event plumbing ----------------------------------------------------

    def _fault(self, point: str) -> None:
        if self.fault is not None:
            self.fault.check(point, self.event_index)

    def _push(self, t: float, kind: str, payload: tuple) -> None:
        heapq.heappush(self._heap, (t, self._seq, kind, payload))
        self._seq += 1

    # ---- admission ---------------------------------------------------------

    def _fits(self, tr: _TenantRuntime) -> bool:
        return (self.max_live_models is None
                or self._live_models + tr.arrive.num_models <= self.max_live_models)

    def _admit(self, tr: _TenantRuntime) -> None:
        ev = tr.arrive
        handle = self.cp.add_tenant(ev.K_block, ev.mu0, ev.cost)
        tr.tenant_id = handle.tenant_id
        tr.model_start = int(handle.models[0])
        tr.admitted_at = self._t
        self._live_models += ev.num_models
        for g in handle.models:
            self._owner_of_model[int(g)] = tr
        self._pending.extend(
            (tr.key, tr.model_start + li)
            for li in tenant_warm_models(ev.cost, ev.mu0, self.warm_start))
        self.telemetry.on_admit(self._t, tr.key)

    def _drain_admission_queue(self) -> None:
        admitted = False
        while self._admission_queue and self._fits(self._admission_queue[0]):
            self._admit(self._admission_queue.pop(0))
            admitted = True
        if admitted or self._admission_queue:
            self.telemetry.on_queue_depth(self._t, len(self._admission_queue))

    # ---- event handlers ----------------------------------------------------

    def _handle_arrive(self, tr: _TenantRuntime) -> None:
        best_possible = float(np.max(tr.arrive.z_true))
        self.telemetry.on_arrive(self._t, tr.key, best_possible)
        if not self._admission_queue and self._fits(tr):
            self._admit(tr)
        else:
            self._admission_queue.append(tr)
            self.telemetry.on_queue_depth(self._t, len(self._admission_queue))

    def _handle_depart(self, key: int) -> None:
        tr = self._tenants[key]
        if tr.departed:
            return
        tr.departed = True
        self.telemetry.on_depart(self._t, key)
        if tr.tenant_id is None:
            # never admitted: drop it from the waiting line — whoever was
            # stuck behind it may fit now (FIFO head-of-line blocking).  No
            # runtime exists: nothing to retire, no live-model capacity to
            # return, no pending/ownership entries to clean.
            self._admission_queue = [q for q in self._admission_queue
                                     if q.key != key]
            self.telemetry.on_queue_depth(self._t, len(self._admission_queue))
            self._drain_admission_queue()
            return
        self.cp.retire_tenant(tr.tenant_id)
        self._live_models -= tr.arrive.num_models
        self._departures += 1
        for g in range(tr.model_start, tr.model_start + tr.arrive.num_models):
            if self._owner_of_model.get(g) is tr:
                del self._owner_of_model[g]
        self._drain_admission_queue()
        # incremental mode (compact_max_moves set) defaults to a bounded
        # pass on EVERY departure — small pauses, amortized convergence —
        # while compact_every alone keeps the periodic stop-the-world pass
        every = self.compact_every or (1 if self.compact_max_moves else None)
        if every and self._departures % every == 0:
            self._run_compaction()

    def _run_compaction(self) -> None:
        """Rebalance idle tenant blocks across shard spans and remap every
        engine-side structure that holds global model ids."""
        t0 = _time.perf_counter()
        with self.tracer.span("compaction"):
            remap = self.cp.compact(self.compact_imbalance,
                                    max_moves=self.compact_max_moves)
        if self.metrics is not None:
            self._m_compact_s.observe(_time.perf_counter() - t0)
        self.compaction_move_counts.append(len(remap))
        self._fault("mid_compact")
        if not remap:
            return
        by_tid = {tr.tenant_id: tr for tr in self._tenants.values()
                  if tr.tenant_id is not None and not tr.departed}
        gid_map: dict[int, int] = {}
        for tid, (old_ids, new_ids) in remap.items():
            tr = by_tid[tid]
            tr.model_start = int(new_ids[0])
            for og, ng in zip(old_ids.tolist(), new_ids.tolist()):
                gid_map[og] = ng
            for og in old_ids.tolist():
                if self._owner_of_model.get(og) is tr:
                    del self._owner_of_model[og]
            for ng in new_ids.tolist():
                self._owner_of_model[ng] = tr
            self._compaction_moves += 1
        self._pending = [(key, gid_map.get(g, g)) for key, g in self._pending]

    def _handle_finish(self, device: int, model: int, ti: int) -> None:
        if ti in self._cancelled:
            return
        if ti in self._hung:
            # the trial hung: its completion never materializes and the
            # device stays busy — without supervision, stranded forever
            # (the failure mode the chaos benchmark's baseline demonstrates)
            return
        t = self._trials[ti]
        # resolve the owner by tenant key, NOT by model id: with slot reuse
        # the id may already belong to a newly admitted tenant while this
        # departed tenant's trial was still in flight
        tr = self._tenants[t.tenant_key]
        if tr.departed:
            self.telemetry.on_rejected_observation(
                self._t, tr.key, t.end - t.start, device=device)
        else:
            z = float(tr.arrive.z_true[t.local_model])
            if ti in self._poisoned:
                self._poisoned.discard(ti)
                z = float("nan")
            if not np.isfinite(z):
                # poisoned-observation guard: a non-finite loss never
                # reaches the GP (it would corrupt the Cholesky).  The
                # model returns to the unselected pool like a failure.
                self.cp.record_failure(model)
                self.telemetry.on_poisoned_observation(
                    self._t, tr.key, model, t.end - t.start, device=device)
                if self.health is not None:
                    self.health.on_poisoned(self._t, self.event_index,
                                            tr.key, model)
                if self.metrics is not None:
                    self.metrics.counter("engine.observations_rejected").inc()
                if self.forensics is not None:
                    self.forensics.on_incident(
                        kind="poisoned_observation", tenant=tr.key,
                        model=model, device=device)
            else:
                self._trials[ti] = StreamTrial(
                    t.model, t.tenant_key, t.local_model, t.user_hint,
                    t.device, t.start, t.end, z)
                improved = self.cp.record_observation(model, z)
                if self.health is not None:
                    # d2 stays on the device until a monitor asks for it:
                    # the sync is paid only on the health-enabled path
                    d2 = self.cp.gp.last_d2
                    self.health.on_observation(
                        self._t, self.event_index, tr.key, improved,
                        d2=None if d2 is None else float(d2),
                        jitter=self.cp._jitter, model=model)
                self.telemetry.on_observation(
                    self._t, tr.key, model, z, t.end - t.start, device=device)
        self.fleet.slices[device].current_trial = None
        self._device_ok(device)
        self._free.append(device)

    def _kill_trial(self, killed_ti: int, *, preempted: bool = False) -> None:
        """Shared bookkeeping for a trial dying before observation (slice
        failure, device leave, preemption): cancel its pending completion,
        rewrite the record as unobserved, and return the model to
        L \\ L(t) — it was never observed, the paper's failure rule."""
        self._hung.discard(killed_ti)
        self._poisoned.discard(killed_ti)
        self._cancelled.add(killed_ti)
        t = self._trials[killed_ti]
        self._trials[killed_ti] = StreamTrial(
            t.model, t.tenant_key, t.local_model, t.user_hint,
            t.device, t.start, self._t, None)
        owner = self._tenants[t.tenant_key]
        if not owner.departed:
            # never observed => the model returns to L \ L(t)
            self.cp.record_failure(t.model)
        if preempted:
            self.telemetry.on_preemption(
                self._t, t.tenant_key, t.model, self._t - t.start,
                device=t.device)
        else:
            self.telemetry.on_trial_failed(
                self._t, t.tenant_key, t.model, self._t - t.start,
                device=t.device)

    def _handle_slice_fail(self, slice_id: int, downtime: float) -> None:
        s = self.fleet.slices[slice_id]
        if not s.healthy:
            return                       # already down; one repair is pending
        killed_ti = self.fleet.fail(slice_id)
        if killed_ti is not None:
            self._kill_trial(killed_ti)
        elif slice_id in self._free:
            self._free.remove(slice_id)
        self._device_strike(slice_id, reason="slice_fail")
        self._push(self._t + downtime, "recover", (slice_id,))

    def _handle_recover(self, slice_id: int) -> None:
        s = self.fleet.slices[slice_id]
        if s.retired:
            return                       # left the fleet while down
        self.fleet.recover(slice_id)
        if (s.current_trial is None and slice_id not in self._free
                and not self._is_quarantined(slice_id)):
            self._free.append(slice_id)

    # ---- trial supervision + failure-domain handlers (DESIGN.md §16) -------

    def _handle_timeout(self, device: int, model: int, ti: int) -> None:
        """The deadline for trial ``ti`` fired.  A completed or cancelled
        trial makes this a logged no-op; a still-running one is a straggler:
        kill it, free the device (unless quarantine holds it), and re-queue
        the model with exponential backoff if retry budget remains.  The
        model stays SELECTED through the backoff window — the policy cannot
        re-pick it early, and the in-flight compaction pin keeps its block
        unmoved while the retry event holds its global id.  A model that
        exhausts its budget is abandoned (permanently selected, never
        observed) — deliberately NOT returned to the pool, which would
        re-pick and re-time-out it forever."""
        s = self.fleet.slices[device]
        if ti in self._cancelled or s.current_trial != ti:
            return                       # completed / killed before deadline
        self._hung.discard(ti)
        self._poisoned.discard(ti)
        self._cancelled.add(ti)
        t = self._trials[ti]
        self._trials[ti] = StreamTrial(
            t.model, t.tenant_key, t.local_model, t.user_hint,
            t.device, t.start, self._t, None)
        owner = self._tenants[t.tenant_key]
        retrying = False
        rk = (t.tenant_key, t.local_model)
        attempt = self._retry_attempts.get(rk, 0)
        if not owner.departed and attempt < self.max_retries:
            self._retry_attempts[rk] = attempt + 1
            self._push(self._t + self.retry_backoff * (2.0 ** attempt),
                       "retry", (t.tenant_key, t.model, attempt + 1))
            retrying = True
        s.current_trial = None
        s.busy_until = self._t
        quarantined = self._device_strike(device, reason="timeout")
        if not quarantined and device not in self._free:
            self._free.append(device)
        self.telemetry.on_trial_timeout(
            self._t, t.tenant_key, t.model, self._t - t.start,
            device=device, retrying=retrying or owner.departed)
        if self.health is not None:
            self.health.on_timeout(self._t, self.event_index, device,
                                   t.tenant_key,
                                   overrun=self._t - t.start)
        if self.metrics is not None:
            self.metrics.counter("engine.trials_timed_out",
                                 labels={"cls": s.cls}).inc()
        if self.forensics is not None:
            self.forensics.on_incident(
                kind="trial_timeout", tenant=t.tenant_key, model=t.model,
                device=device, attempt=attempt, retrying=retrying)

    def _handle_retry(self, key: int, model: int, attempt: int) -> None:
        """Backoff expired: deselect the model and re-queue it through the
        pending launch path (the same staleness-guarded queue warm starts
        use), so the next launch pass relaunches it deterministically."""
        owner = self._tenants.get(key)
        if (owner is None or owner.departed
                or self._owner_of_model.get(model) is not owner):
            return                       # tenant left / slot recycled meanwhile
        self.cp.record_failure(model)
        self._pending.append((key, model))
        self.telemetry.on_trial_retry(self._t, key, model, attempt)
        if self.health is not None:
            self.health.on_retry(self._t, self.event_index, key, model,
                                 attempt)
        if self.metrics is not None:
            self.metrics.counter("engine.trials_retried").inc()

    def _handle_hang(self, slice_id: int) -> None:
        """Chaos event: the trial currently on ``slice_id`` will never
        complete — mark it so its finish event becomes a no-op."""
        if slice_id >= len(self.fleet.slices):
            return
        s = self.fleet.slices[slice_id]
        ti = s.current_trial
        if (not s.healthy or s.retired or ti is None
                or ti in self._cancelled):
            return                       # nothing running to hang
        self._hung.add(ti)

    def _handle_poison(self, slice_id: int) -> None:
        """Chaos event: the trial currently on ``slice_id`` completes on
        schedule but returns NaN — mark it for the ingest guard."""
        if slice_id >= len(self.fleet.slices):
            return
        s = self.fleet.slices[slice_id]
        ti = s.current_trial
        if (not s.healthy or s.retired or ti is None
                or ti in self._cancelled):
            return
        self._poisoned.add(ti)

    def _handle_mesh_shrink(self, num_shards: int) -> None:
        """The scoring mesh lost devices: re-shard every resident posterior
        block onto a ``num_shards`` mesh through the control plane's
        checkpoint path, then remap every engine-side structure holding
        global model ids (the compaction discipline, applied to the whole
        resident set)."""
        with self.tracer.span("mesh_shrink", num_shards=num_shards):
            remap = self.cp.reshard(num_shards)
        if not remap:
            return
        for tr in self._tenants.values():
            if tr.tenant_id is not None and not tr.departed:
                tr.model_start = remap.get(tr.model_start, tr.model_start)
        self._owner_of_model = {remap.get(g, g): tr
                                for g, tr in self._owner_of_model.items()}
        self._pending = [(key, remap.get(g, g)) for key, g in self._pending]
        # in-flight trial records and their pending finish/timeout/retry
        # heap payloads carry global ids too.  Departed owners' ids are
        # absent from the remap (their blocks are already released) — their
        # handlers never dereference the model id, so passthrough is safe.
        for s in self.fleet.slices:
            ti = s.current_trial
            if ti is not None and ti not in self._cancelled:
                t = self._trials[ti]
                self._trials[ti] = StreamTrial(
                    remap.get(t.model, t.model), t.tenant_key, t.local_model,
                    t.user_hint, t.device, t.start, t.end, t.z)
        heap = []
        for t, seq, kind, payload in self._heap:
            if kind in ("finish", "timeout"):
                d, g, ti = payload
                payload = (d, remap.get(g, g), ti)
            elif kind == "retry":
                k, g, a = payload
                payload = (k, remap.get(g, g), a)
            heap.append((t, seq, kind, payload))
        # same (t, seq) arrangement => still a valid heap
        self._heap = heap
        if self.metrics is not None:
            self.metrics.counter("engine.mesh_shrinks").inc()
        if self.forensics is not None:
            self.forensics.on_incident(kind="mesh_shrink",
                                       num_shards=num_shards,
                                       slots_remapped=len(remap))

    # ---- device quarantine hooks (devplane overrides; DESIGN.md §16) -------

    def _device_strike(self, device: int, *, reason: str) -> bool:
        """Record a failure/timeout strike against ``device``.  Returns True
        when the device is (now) quarantined and must be kept out of the
        free list.  Base engine: no scoreboard, never quarantines."""
        return False

    def _device_ok(self, device: int) -> None:
        """Record a clean completion on ``device`` (probation credit)."""

    def _is_quarantined(self, device: int) -> bool:
        return False

    # ---- the launch loop (mirrors scheduler.simulate.try_launch) -----------

    def _pick_free_index(self) -> int:
        """Index into ``self._free`` of the next slice to launch on.

        ``launch_order="lifo"`` is the historical stack pop (top of stack);
        ``"fastest"`` picks the fastest free slice — ties resolve to the
        most recently freed (the stack top among the tied), so on a
        homogeneous fleet the two orders are byte-identical and the replay
        equivalence contract is untouched (tests/test_stream.py)."""
        if self.launch_order == "lifo" or len(self._free) == 1:
            return len(self._free) - 1
        speeds = [self.fleet.slices[d].speed for d in self._free]
        best = max(speeds)
        for i in range(len(self._free) - 1, -1, -1):
            if speeds[i] == best:
                return i
        raise AssertionError("unreachable: _free is non-empty")

    def _launch_on(self, i: int, model: int, hint: int) -> None:
        """Commit one launch on free-list index ``i`` (shared bookkeeping
        for the sequential and the devplane batched paths)."""
        d = self._free.pop(i)
        s = self.fleet.slices[d]
        owner = self._owner_of_model[model]
        # a disabled tracer costs one test here and opens no span
        if self.tracer.enabled:
            with self.tracer.span("launch", model=model, device=d):
                dur = self._commit_launch(d, s, owner, model, hint)
        else:
            dur = self._commit_launch(d, s, owner, model, hint)
        if self.metrics is not None:
            self._m_launches.inc()
            self.metrics.counter("engine.launches_by_class",
                                 labels={"cls": s.cls}).inc()
        if self.health is not None:
            self.health.on_launch(self._t, self.event_index, owner.key,
                                  model, s.cls)
        self.telemetry.on_launch(self._t, owner.key, model, d, dur)

    def _commit_launch(self, d: int, s, owner, model: int, hint: int) -> float:
        """The launch itself: the trial, its finish (and deadline) events;
        returns its duration."""
        dur = self._duration_on(model, s)
        end = self._t + dur
        self.cp.record_start(model)
        self._fault("mid_launch")
        ti = len(self._trials)
        s.current_trial = ti
        s.busy_until = end
        self._trials.append(StreamTrial(
            model, owner.key, model - owner.model_start, hint, d,
            self._t, end, None))
        self._push(end, "finish", (d, model, ti))
        if self.timeout_factor is not None:
            # deadline = k x predicted seconds; pushed after the finish
            # at the same heap discipline, so an on-time completion's
            # deadline pops later as a logged no-op
            self._push(self._t + self.timeout_factor * dur,
                       "timeout", (d, model, ti))
        return dur

    def _duration_on(self, model: int, s) -> float:
        """Trial duration of ``model`` on slice ``s`` — the rank-1
        ``c(x)/speed_d``; the devplane engine overrides this with the
        registry's 2-D per-class cost (DESIGN.md §11)."""
        return float(self.cp.cost[model]) / s.speed

    def _pop_pending_launch(self) -> bool:
        """Consume exactly one warm-start queue entry: launch it on the
        ``_pick_free_index`` slice, or drop it when stale.  Returns False
        when the queue is empty.  Shared by the base and devplane launch
        loops — the batched == sequential equivalence depends on the two
        engines applying identical staleness guards."""
        if not self._pending:
            return False
        i = self._pick_free_index()
        key, model = self._pending.pop(0)
        owner = self._tenants[key]
        if owner.departed or self._owner_of_model.get(model) is not owner:
            return True                  # tenant left / slot recycled meanwhile
        if self.cp.selected[model]:
            return True                  # observed or in flight meanwhile
        self._launch_on(i, model, -2)
        return True

    def _try_launch(self, horizon: float) -> None:
        while self._free:
            if self._t >= horizon:
                return
            if self._pop_pending_launch():
                continue
            i = self._pick_free_index()
            s = self.fleet.slices[self._free[i]]
            t0 = _time.perf_counter()
            if self.tracer.enabled:
                with self.tracer.span("decide", device=self._free[i]):
                    pick = self._chooser(device_speed=s.speed)
            else:
                pick = self._chooser(device_speed=s.speed)
            dt = _time.perf_counter() - t0
            self._decision_seconds += dt
            self._decisions += 1
            if self.metrics is not None:
                self._m_decision_s.observe(dt)
            if pick is None:
                return
            model, hint = pick
            self._policy_launches += 1
            self._launch_on(i, model, hint)

    # ---- the loop ----------------------------------------------------------

    def _ingest(self, ev) -> None:
        """Schedule one external trace event.  The devplane engine extends
        this with device lifecycle events (DeviceJoin/Leave/Preempt)."""
        if isinstance(ev, TenantArrive):
            tr = _TenantRuntime(key=ev.tenant_key, arrive=ev)
            self._tenants[ev.tenant_key] = tr
            self._push(ev.at, "arrive", (tr,))
        elif isinstance(ev, TenantDepart):
            self._push(ev.at, "depart", (ev.tenant_key,))
        elif isinstance(ev, SliceFail):
            self._push(ev.at, "slice_fail", (ev.slice_id, ev.downtime))
        elif isinstance(ev, TrialHang):
            self._push(ev.at, "hang", (ev.slice_id,))
        elif isinstance(ev, TrialPoison):
            self._push(ev.at, "poison", (ev.slice_id,))
        elif isinstance(ev, MeshShrink):
            self._push(ev.at, "mesh_shrink", (ev.num_shards,))
        else:
            raise TypeError(f"unknown trace event {ev!r}")

    def _dispatch_extra(self, kind: str, payload: tuple) -> None:
        """Handle an event kind the base engine does not know (devplane
        device lifecycle).  Base: nothing is expected to land here."""
        raise AssertionError(f"unknown event kind {kind!r}")

    def _post_event(self, kind: str) -> None:
        """Hook between event handling and the launch pass — the devplane
        engine evaluates its autoscale policy here.  Base: no-op."""

    def _capacity_extra(self) -> dict:
        """Extra scalar capacity gauges for the accounting plane — the
        devplane engine reports autoscale joins/leaves and scoring passes
        here.  Base: nothing."""
        return {}

    # ---- live health plane (DESIGN.md §14) ---------------------------------

    def _backlog(self) -> int:
        """Launchable pool size: live models neither observed nor in
        flight — the health plane's notion of pending work, and the
        autoscale signal."""
        return int(np.count_nonzero(~self.cp.selected & self.cp.model_live))

    def _health_tick(self) -> None:
        """Feed the watchdogs once per processed event (sim-time inputs
        only — alert content must replay deterministically) and forward
        new alerts to the durable event log."""
        free_classes = tuple(sorted(
            {self.fleet.slices[d].cls for d in self._free}))
        self.health.on_event(
            self._t, self.event_index,
            queue_depth=len(self._admission_queue),
            backlog=self._backlog(),
            free_classes=free_classes,
            summary_fn=lambda: self.telemetry.summary(now=self._t))
        for a in self.health.drain_new():
            self.log.append_alert(a.to_record())

    def begin(self, events, trace_name: str = "trace") -> None:
        """Ingest all external events (appending each to the log) and
        register the initial fleet — everything ``run`` does before the
        first heap pop.  ``recover`` uses this for genesis replay."""
        self._trace_name = trace_name
        self.log.set_meta(trace_name=trace_name)
        for ev in events:
            self.log.append_external(ev)
            self._ingest(ev)
        for s in self.fleet.slices:
            self.telemetry.on_device_join(0.0, s.slice_id, s.speed,
                                          initial=True)

    def run(self, trace: ChurnTrace, horizon: float = np.inf) -> StreamResult:
        """Replay one trace to completion (or ``horizon``) and return the
        trial log + telemetry.  A fresh engine per run."""
        self.begin(trace, trace_name=trace.name)
        return self._drain(horizon)

    def resume(self, horizon: float = np.inf) -> StreamResult:
        """Continue a begun or restored engine to completion — the second
        half of ``run``.  ``recover(...)`` + ``resume()`` must reproduce the
        uninterrupted ``run`` exactly (the replay oracle)."""
        return self._drain(horizon)

    def _drain(self, horizon: float) -> StreamResult:
        while self._heap:
            t, _, kind, payload = heapq.heappop(self._heap)
            if t >= horizon:
                break
            self._t = t
            self.event_index += 1
            # a disabled tracer costs one test an event and opens no span
            traced = self.tracer.enabled
            if traced:
                # one trace per processed event; the id IS the event index,
                # so the log's trace field and a replayed suffix's span tree
                # both correlate for free
                self.tracer.begin_trace(self.event_index)
            if self.forensics is not None:
                self.forensics.begin_event(t, self.event_index)
            self._fault("before")
            if traced:
                with self.tracer.span("event", kind=kind):
                    self._process(t, kind, payload, horizon)
            else:
                self._process(t, kind, payload, horizon)
            if self.metrics is not None:
                self._m_events.inc()
                self._m_queue.set(len(self._admission_queue))
            # accounting before the health tick: a capacity sample may fire
            # the memory watchdog, and draining in the same event keeps the
            # alert adjacent to the sample that caused it
            if self.accounting is not None:
                self.accounting.tick(self._t, self.event_index, self)
            if self.health is not None:
                self._health_tick()
            if self.exporter is not None:
                self.exporter.tick(self._t, self.event_index)
            self._fault("after")
            self._maybe_snapshot()

        self.telemetry.on_end(self._t, self.fleet.num_devices)
        if self.metrics is not None:
            if self._decision_seconds > 0:
                self.metrics.gauge("engine.decisions_per_s").set(
                    self._decisions / self._decision_seconds)
            for d, row in self.telemetry.per_device().items():
                self.metrics.gauge(f"device.{d}.busy_fraction").set(
                    row["utilization"])
        if self.accounting is not None:
            # one closing sample so short runs still publish gauges (and
            # the exporter's final record below carries them)
            self.accounting.sample(self._t, self.event_index, self)
        if self.health is not None:
            for a in self.health.drain_new():
                self.log.append_alert(a.to_record())
        if self.exporter is not None:
            # after the end-of-run gauges so the closing record carries them
            self.exporter.final(self._t, self.event_index)
        return StreamResult(
            trace_name=self._trace_name, policy=self.policy,
            num_devices=self.fleet.num_devices, trials=self._trials,
            end_time=self._t, decisions=self._decisions,
            decision_seconds=self._decision_seconds,
            telemetry=self.telemetry, tenants=self._tenants,
            compaction_moves=self._compaction_moves,
            policy_launches=self._policy_launches)

    def _process(self, t: float, kind: str, payload, horizon: float) -> None:
        """One popped event: its handler, its processed record, and the
        launches it frees up."""
        if kind == "arrive":
            self._handle_arrive(*payload)
        elif kind == "depart":
            self._handle_depart(*payload)
        elif kind == "finish":
            self._handle_finish(*payload)
        elif kind == "slice_fail":
            self._handle_slice_fail(*payload)
        elif kind == "recover":
            self._handle_recover(*payload)
        elif kind == "timeout":
            self._handle_timeout(*payload)
        elif kind == "retry":
            self._handle_retry(*payload)
        elif kind == "hang":
            self._handle_hang(*payload)
        elif kind == "poison":
            self._handle_poison(*payload)
        elif kind == "mesh_shrink":
            self._handle_mesh_shrink(*payload)
        else:
            self._dispatch_extra(kind, payload)
        self.log.append_processed(self.event_index, t, kind,
                                  self._encode_payload(kind, payload),
                                  trace=self.tracer.current_trace)
        self._post_event(kind)
        # simultaneous arrivals are admitted as one batch before any launch
        # — this is what makes the churn-free replay line up with
        # simulate()'s pre-built warm-start queue
        if not (kind == "arrive" and self._heap
                and self._heap[0][0] == t
                and self._heap[0][2] == "arrive"):
            self._try_launch(horizon)

    # ---- snapshot / restore (event sourcing, DESIGN.md §12) ----------------

    def _maybe_snapshot(self) -> None:
        if (self.snapshot_root is not None and self.snapshot_every
                and self.event_index % self.snapshot_every == 0):
            self.save_snapshot()

    def save_snapshot(self):
        """Write a full-state snapshot at the current event boundary via
        ``checkpoint.store.save_checkpoint`` (atomic publish).  Snapshot
        latency is metrics-only, deliberately NOT a span: the replay oracle
        compares span trees, and a durable run snapshots where its
        uninterrupted reference does not."""
        t0 = _time.perf_counter()
        arrays, meta = self._snapshot_state()
        out = save_checkpoint(self.snapshot_root, self.event_index,
                              arrays, meta)
        if self.metrics is not None:
            self._m_snapshot_s.observe(_time.perf_counter() - t0)
        return out

    def _encode_payload(self, kind: str, payload: tuple) -> list:
        """JSON-able encoding of one heap payload (snapshot + processed-log
        record).  Tenant runtimes are referenced by stable tenant_key; the
        devplane engine extends this for device lifecycle kinds."""
        if kind == "arrive":
            return [payload[0].key]
        if kind in ("depart", "finish", "slice_fail", "recover",
                    "timeout", "retry", "hang", "poison", "mesh_shrink"):
            return list(payload)
        raise AssertionError(f"unknown event kind {kind!r}")

    def _decode_payload(self, kind: str, data: list) -> tuple:
        """Inverse of :meth:`_encode_payload`; runs after ``_tenants`` is
        rebuilt so arrive entries resolve to the live runtime objects."""
        if kind == "arrive":
            return (self._tenants[data[0]],)
        if kind in ("depart", "finish", "slice_fail", "recover",
                    "timeout", "retry", "hang", "poison", "mesh_shrink"):
            return tuple(data)
        raise AssertionError(f"unknown event kind {kind!r}")

    def _snapshot_extra(self) -> dict:
        """Subclass state to include in snapshots (devplane overrides)."""
        return {}

    def _restore_extra(self, extra: dict) -> None:
        """Inverse of :meth:`_snapshot_extra`."""

    def _snapshot_state(self) -> tuple[dict, dict]:
        arrays, cp_meta = self.cp.state_snapshot()
        tr = self._trials
        arrays.update({
            "trials/model": np.asarray([t.model for t in tr], np.int64),
            "trials/tenant_key": np.asarray([t.tenant_key for t in tr],
                                            np.int64),
            "trials/local_model": np.asarray([t.local_model for t in tr],
                                             np.int64),
            "trials/user_hint": np.asarray([t.user_hint for t in tr],
                                           np.int64),
            "trials/device": np.asarray([t.device for t in tr], np.int64),
            "trials/start": np.asarray([t.start for t in tr], np.float64),
            "trials/end": np.asarray([t.end for t in tr], np.float64),
            "trials/z": np.asarray([t.z if t.z is not None else 0.0
                                    for t in tr], np.float64),
            "trials/has_z": np.asarray([t.z is not None for t in tr], bool),
        })
        meta = {
            "engine": {
                "t": self._t, "seq": self._seq,
                "event_index": self.event_index,
                "trace_name": self._trace_name,
                "decisions": self._decisions,
                "decision_seconds": self._decision_seconds,
                "policy_launches": self._policy_launches,
                "compaction_moves": self._compaction_moves,
                "compaction_move_counts": list(self.compaction_move_counts),
                "departures": self._departures,
                "live_models": self._live_models,
                "free": list(self._free),
                "pending": [[k, g] for k, g in self._pending],
                "admission_queue": [q.key for q in self._admission_queue],
                "cancelled": sorted(self._cancelled),
                "hung": sorted(self._hung),
                "poisoned": sorted(self._poisoned),
                "retry_attempts": [[k, li, n] for (k, li), n
                                   in self._retry_attempts.items()],
                "heap": [[t, seq, kind, self._encode_payload(kind, payload)]
                         for t, seq, kind, payload in self._heap],
            },
            "tenants": {str(tr_.key): [tr_.admitted_at, tr_.departed,
                                       tr_.tenant_id, tr_.model_start]
                        for tr_ in self._tenants.values()},
            "fleet": [[s.slice_id, s.chips, s.speed, s.healthy, s.busy_until,
                       s.current_trial, s.cls, s.retired]
                      for s in self.fleet.slices],
            "telemetry": self.telemetry.state_dict(),
            "cp": cp_meta,
            "extra": self._snapshot_extra(),
            # live-plane cursors (DESIGN.md §14): detector state and the
            # export window cursor are pure functions of the event stream,
            # so persisting them keeps a recovered run's alert/export
            # suffix identical to the uninterrupted run.  Alert/forensics
            # RECORDS never ride here — their durable prefix lives in the
            # log's alerts.jsonl / the forensics JSONL stream.
            "obs": {
                "health": (self.health.state_dict()
                           if self.health is not None else None),
                "export": (self.exporter.state_dict()
                           if self.exporter is not None else None),
                "capacity": (self.accounting.state_dict()
                             if self.accounting is not None else None),
            },
        }
        return arrays, meta

    def _restore_state(self, arrays: dict, meta: dict,
                       arrive_by_key: dict) -> None:
        """Load a :meth:`_snapshot_state` snapshot into this freshly
        constructed, identically configured engine.  ``arrive_by_key`` maps
        tenant_key -> TenantArrive from the event log — snapshots reference
        tenants by key instead of re-storing their (large) prior blocks."""
        me = meta["engine"]
        self._t = me["t"]
        self._seq = me["seq"]
        self.event_index = me["event_index"]
        self._trace_name = me["trace_name"]
        self._decisions = me["decisions"]
        self._decision_seconds = me["decision_seconds"]
        self._policy_launches = me["policy_launches"]
        self._compaction_moves = me["compaction_moves"]
        self.compaction_move_counts = list(me["compaction_move_counts"])
        self._departures = me["departures"]
        self._live_models = me["live_models"]
        self._free = list(me["free"])
        self._pending = [(k, g) for k, g in me["pending"]]
        self._cancelled = set(me["cancelled"])
        # tolerant restore: pre-supervision snapshots lack these keys
        self._hung = set(me.get("hung", []))
        self._poisoned = set(me.get("poisoned", []))
        self._retry_attempts = {(k, li): n for k, li, n
                                in me.get("retry_attempts", [])}

        self._tenants = {}
        for key_s, (admitted_at, departed, tid, mstart) in \
                meta["tenants"].items():
            key = int(key_s)
            self._tenants[key] = _TenantRuntime(
                key=key, arrive=arrive_by_key[key], admitted_at=admitted_at,
                departed=departed, tenant_id=tid, model_start=mstart)
        self._admission_queue = [self._tenants[k]
                                 for k in me["admission_queue"]]
        self._owner_of_model = {}
        for tr in self._tenants.values():
            if tr.tenant_id is not None and not tr.departed:
                for g in range(tr.model_start,
                               tr.model_start + tr.arrive.num_models):
                    self._owner_of_model[g] = tr
        # the stored list is a valid heap; re-decoding in place preserves
        # the exact arrangement (and (t, seq) is a total order, so payloads
        # are never compared)
        self._heap = [(t, seq, kind, self._decode_payload(kind, data))
                      for t, seq, kind, data in me["heap"]]

        z = arrays["trials/z"]
        has_z = arrays["trials/has_z"]
        self._trials = [
            StreamTrial(
                model=int(arrays["trials/model"][i]),
                tenant_key=int(arrays["trials/tenant_key"][i]),
                local_model=int(arrays["trials/local_model"][i]),
                user_hint=int(arrays["trials/user_hint"][i]),
                device=int(arrays["trials/device"][i]),
                start=float(arrays["trials/start"][i]),
                end=float(arrays["trials/end"][i]),
                z=float(z[i]) if has_z[i] else None)
            for i in range(len(z))]

        self.fleet.slices[:] = [
            DeviceSlice(slice_id=sid, chips=chips, speed=speed,
                        healthy=healthy, busy_until=busy_until,
                        current_trial=current_trial, cls=cls, retired=retired)
            for sid, chips, speed, healthy, busy_until, current_trial, cls,
            retired in meta["fleet"]]

        self.telemetry.load_state(meta["telemetry"])
        self.cp.load_state(arrays, meta["cp"])
        self._restore_extra(meta["extra"])
        # tolerant restore: snapshots from health-less runs lack the key
        obs = meta.get("obs") or {}
        if self.health is not None and obs.get("health") is not None:
            self.health.load_state(obs["health"])
        if self.exporter is not None and obs.get("export") is not None:
            self.exporter.load_state(obs["export"])
        if self.accounting is not None and obs.get("capacity") is not None:
            self.accounting.load_state(obs["capacity"])
