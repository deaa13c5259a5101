"""The elastic streaming engine: device churn + joint batched assignment.

:class:`DevPlaneEngine` extends :class:`repro_torch.stream.engine.StreamEngine`
with the device half of the service (DESIGN.md §11):

  DeviceJoin     -> ``Fleet.join`` appends a slice of the event's class; it
                    enters the free pool and the next launch pass uses it
  DeviceLeave    -> permanent decommission; the in-flight trial dies exactly
                    like a slice failure (model back to L \\ L(t)) but the
                    slice never recovers
  DevicePreempt  -> the in-flight trial is evicted and re-queued like a
                    slice failure; the slice is immediately schedulable
  autoscale      -> a queue-depth-driven policy (``autoscale.py``) joins /
                    retires devices at event times

Costs come from a :class:`~repro_torch.devplane.registry.DeviceClassRegistry`:
durations and EIrate denominators are the per-class affine
``overhead_c + c(x)/rate_c``, so the (free devices x live models) score
matrix is genuinely 2-D and the launch decision is an *assignment*, not an
argmax.

``assign="batched"`` solves that assignment for ALL simultaneously-free
devices in one scoring pass (``ControlPlane.choose_mdmt_batch`` — per-class
top-k, dense or sharded — feeding ``assign.greedy_assign``) instead of one
pass per device.  ``assign="sequential"`` keeps per-device decisions but
scores them with the same 2-D costs (a batch of one), so the two modes are
decision-equivalent on homogeneous fleets (tested) and differ only where
heterogeneity makes joint assignment genuinely better.

With a homogeneous zero-overhead registry, no device events, and
``assign="sequential"`` the engine IS the base ``StreamEngine`` — byte-
identical trial sequences (tests/test_devplane.py), the same discipline as
the churn-free == ``scheduler.simulate`` contract.

The port's counterpart of ``repro.devplane.engine``: the same events, costs,
assignment and snapshot extras, and the reference's trial sequences
(tests/test_torch_devplane.py).  Each scoring pass of the batched path is
one launch of the class-axis EIrate kernel on the card (``"ops"``), or one
per shard (``"sharded"``).
"""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np

from ..stream.engine import StreamEngine
from ..stream.workload import DeviceJoin, DeviceLeave, DevicePreempt

from .assign import greedy_assign
from .autoscale import AutoscalePolicy
from .quarantine import QuarantineBoard, QuarantinePolicy
from .registry import DeviceClassRegistry

ASSIGN_MODES = ("batched", "sequential")


class DevPlaneEngine(StreamEngine):
    """Streaming GP-EI over an elastic, heterogeneous fleet (module
    docstring).  Extra knobs on top of StreamEngine:

    * ``registry`` — device classes; defaults to a zero-overhead rank-1
      registry synthesized from the fleet (backward-compatible costs).
    * ``assign`` — ``"batched"`` (one scoring pass per free wave) or
      ``"sequential"`` (one per device).  Non-mdmt policies always take the
      base per-tenant path.
    * ``autoscale`` — an :class:`AutoscalePolicy`, or None.
    * ``speed_oblivious`` — score as if every device were the reference
      class (durations stay real); the regret baseline the device-aware
      plane is measured against.
    * ``quarantine`` — a :class:`QuarantinePolicy`, or None.  Activates
      the per-device strike scoreboard (DESIGN.md §16): devices that keep
      timing out or failing are pulled from the launchable pool, re-
      admitted on probation, and subtracted from the device count the
      autoscale controller sees (sick capacity triggers scale-up).
    """

    def __init__(self, fleet, policy: str = "mdmt", *,
                 registry: DeviceClassRegistry | None = None,
                 assign: str = "batched",
                 autoscale: AutoscalePolicy | None = None,
                 speed_oblivious: bool = False,
                 quarantine: QuarantinePolicy | None = None,
                 **kw):
        super().__init__(fleet, policy, **kw)
        if assign not in ASSIGN_MODES:
            raise ValueError(
                f"assign must be one of {ASSIGN_MODES}, got {assign!r}")
        self.registry = registry or DeviceClassRegistry.from_fleet(fleet)
        self.assign = assign
        # private copy with a fresh cooldown clock: sharing one policy
        # object across engines must not leak run state between replays
        self.autoscale = (None if autoscale is None
                          else dataclasses.replace(autoscale))
        self.speed_oblivious = speed_oblivious
        if autoscale is not None and autoscale.join_class not in self.registry:
            raise ValueError(
                f"autoscale join_class {autoscale.join_class!r} is not in "
                "the registry")
        for s in fleet.slices:
            if s.cls not in self.registry:
                raise ValueError(f"slice {s.slice_id} has unregistered "
                                 f"device class {s.cls!r}")
        self.quarantine = (QuarantineBoard(quarantine)
                           if quarantine is not None else None)
        self._autoscale_joins = 0
        self._autoscale_leaves = 0
        self._scoring_passes = 0

    # ---- costs -------------------------------------------------------------

    def _duration_on(self, model: int, s) -> float:
        """The registry's 2-D cost: overhead + base/rate for the slice's
        class (reduces to the base engine's c(x)/speed for zero-overhead
        synthesized registries)."""
        return float(self.registry[s.cls].cost_on(self.cp.cost[model]))

    # ---- device lifecycle --------------------------------------------------

    def _ingest(self, ev) -> None:
        if isinstance(ev, DeviceJoin):
            self._push(ev.at, "dev_join", (ev,))
        elif isinstance(ev, DeviceLeave):
            self._push(ev.at, "dev_leave", (ev.slice_id,))
        elif isinstance(ev, DevicePreempt):
            self._push(ev.at, "dev_preempt", (ev.slice_id,))
        else:
            super()._ingest(ev)

    def _dispatch_extra(self, kind: str, payload: tuple) -> None:
        if kind == "dev_join":
            self._handle_dev_join(*payload)
        elif kind == "dev_leave":
            self._handle_dev_leave(*payload)
        elif kind == "dev_preempt":
            self._handle_dev_preempt(*payload)
        elif kind == "probation":
            self._handle_probation(*payload)
        else:
            super()._dispatch_extra(kind, payload)

    def _join_device(self, cls_name: str, chips: int | None = None):
        c = self.registry[cls_name]
        s = self.fleet.join(chips or c.chips, c.rate, cls=cls_name)
        self._free.append(s.slice_id)
        self.telemetry.on_device_join(self._t, s.slice_id, s.speed)
        return s

    def _handle_dev_join(self, ev: DeviceJoin) -> None:
        # the registry is authoritative for cost semantics; a trace that
        # declares a different speed for the class is a config error, not
        # something to silently override
        c = self.registry[ev.cls]
        if ev.speed != c.rate:
            raise ValueError(
                f"DeviceJoin speed {ev.speed} disagrees with registered "
                f"class {ev.cls!r} rate {c.rate}")
        self._join_device(ev.cls, ev.chips)

    def _handle_dev_leave(self, slice_id: int) -> None:
        if slice_id >= len(self.fleet.slices):
            return                     # trace id math raced autoscale joins
        s = self.fleet.slices[slice_id]
        if s.retired:
            return                     # duplicate leave in the trace
        killed = self.fleet.leave(slice_id)
        if killed is not None:
            self._kill_trial(killed)
        elif slice_id in self._free:
            self._free.remove(slice_id)
        if self.quarantine is not None:
            self.quarantine.retire(slice_id)
        self.telemetry.on_device_leave(self._t, slice_id)

    def _handle_dev_preempt(self, slice_id: int) -> None:
        if slice_id >= len(self.fleet.slices):
            return                     # trace id math raced autoscale joins
        s = self.fleet.slices[slice_id]
        if s.retired or not s.healthy:
            return                     # raced a leave / is already down
        killed = self.fleet.preempt(slice_id)
        if killed is not None:
            self._kill_trial(killed, preempted=True)
            # the slice survives the eviction: immediately schedulable
            # (unless quarantined — the scoreboard outranks the eviction)
            if slice_id not in self._free and not self._is_quarantined(
                    slice_id):
                self._free.append(slice_id)

    # ---- device quarantine (DESIGN.md §16) ---------------------------------

    def _device_strike(self, device: int, *, reason: str) -> bool:
        """Feed the strike scoreboard; True = device newly quarantined
        (the supervision hooks then keep it out of the free pool)."""
        board = self.quarantine
        if board is None or device >= len(self.fleet.slices):
            return False
        s = self.fleet.slices[device]
        if s.retired:
            return False
        newly = board.strike(device, self._t)
        if newly:
            if device in self._free:
                self._free.remove(device)
            self._push(self._t + board.policy.duration,
                       "probation", (device,))
            count = board.quarantine_count(device)
            self.telemetry.on_quarantine(self._t, device)
            if self.health is not None:
                self.health.on_quarantine(self._t, self.event_index,
                                          device, count=count)
            if self.metrics is not None:
                self.metrics.counter("engine.devices_quarantined",
                                     labels={"cls": s.cls}).inc()
            if self.forensics is not None:
                self.forensics.on_incident(
                    kind="device_quarantine", device=int(device),
                    reason=reason, count=int(count))
        return board.is_quarantined(device)

    def _device_ok(self, device: int) -> None:
        if self.quarantine is not None:
            self.quarantine.on_success(device)

    def _is_quarantined(self, device: int) -> bool:
        return (self.quarantine is not None
                and self.quarantine.is_quarantined(device))

    def _handle_probation(self, device: int) -> None:
        board = self.quarantine
        if board is None or board.state(device) != "quarantined":
            return                     # retired / already re-quarantined
        board.begin_probation(device)
        if device >= len(self.fleet.slices):
            return
        s = self.fleet.slices[device]
        # dual-gate with recover: a device that failed *while* quarantined
        # re-enters only via whichever of (recover, probation) fires last
        if (s.healthy and not s.retired and s.current_trial is None
                and device not in self._free):
            self._free.append(device)

    # ---- snapshot / restore (event sourcing, DESIGN.md §12) ----------------

    def _encode_payload(self, kind: str, payload: tuple) -> list:
        if kind == "dev_join":
            ev = payload[0]
            return [ev.at, ev.chips, ev.speed, ev.cls]
        if kind in ("dev_leave", "dev_preempt", "probation"):
            return list(payload)
        return super()._encode_payload(kind, payload)

    def _decode_payload(self, kind: str, data: list) -> tuple:
        if kind == "dev_join":
            at, chips, speed, cls = data
            return (DeviceJoin(at=at, chips=chips, speed=speed, cls=cls),)
        if kind in ("dev_leave", "dev_preempt", "probation"):
            return tuple(data)
        return super()._decode_payload(kind, data)

    def _snapshot_extra(self) -> dict:
        return {
            "autoscale_last_action": (None if self.autoscale is None
                                      else self.autoscale._last_action),
            "autoscale_joins": self._autoscale_joins,
            "autoscale_leaves": self._autoscale_leaves,
            "scoring_passes": self._scoring_passes,
            "quarantine": (self.quarantine.state_dict()
                           if self.quarantine is not None else None),
        }

    def _restore_extra(self, extra: dict) -> None:
        if self.autoscale is not None:
            last = extra["autoscale_last_action"]
            self.autoscale._last_action = (float("-inf") if last is None
                                           else last)
        self._autoscale_joins = extra["autoscale_joins"]
        self._autoscale_leaves = extra["autoscale_leaves"]
        self._scoring_passes = extra["scoring_passes"]
        if self.quarantine is not None and extra.get("quarantine"):
            self.quarantine.load_state(extra["quarantine"])

    def _capacity_extra(self) -> dict:
        """Elastic-fleet counters for the capacity plane
        (``capacity.autoscale_joins`` ... gauges, obs/accounting.py)."""
        return {
            "autoscale_joins": self._autoscale_joins,
            "autoscale_leaves": self._autoscale_leaves,
            "scoring_passes": self._scoring_passes,
            "devices_quarantined": (self.quarantine.quarantined_now()
                                    if self.quarantine is not None else 0),
        }

    # ---- autoscale ---------------------------------------------------------

    def _post_event(self, kind: str) -> None:
        if self.autoscale is None or not self.autoscale.ready(self._t):
            return                     # skip the O(capacity) backlog scan
        backlog = self._backlog()
        # quarantined devices are not serving capacity: report only the
        # in-service count so a sick fleet looks small and scales up
        quarantined = (self.quarantine.quarantined_now()
                       if self.quarantine is not None else 0)
        in_service = max(self.fleet.num_devices - quarantined,
                         1 if self.fleet.num_devices else 0)
        action = self.autoscale.decide(
            self._t, backlog=backlog, num_devices=in_service,
            num_free=len(self._free))
        if action == "join":
            self._join_device(self.autoscale.join_class)
            self._autoscale_joins += 1
        elif action == "leave":
            # retire the slowest idle slice (ties: lowest id)
            sid = min(self._free,
                      key=lambda d: (self.fleet.slices[d].speed, d))
            self.fleet.leave(sid)
            self._free.remove(sid)
            self.telemetry.on_device_leave(self._t, sid)
            self._autoscale_leaves += 1

    # ---- the joint batched launch pass -------------------------------------

    def _free_priority_order(self) -> list[int]:
        """Free-list indices in launch-priority order: the exact sequence
        ``_pick_free_index`` would visit as devices are consumed — the
        solver's device tie-break order, which is what keeps batched ==
        sequential on homogeneous fleets."""
        idxs = list(range(len(self._free)))
        if self.launch_order == "fastest":
            idxs.sort(key=lambda i:
                      (-self.fleet.slices[self._free[i]].speed, -i))
        else:
            idxs.reverse()
        return idxs

    def _try_launch(self, horizon: float) -> None:
        if self.policy != "mdmt":
            return super()._try_launch(horizon)
        while self._free:
            if self._t >= horizon:
                return
            if self._pop_pending_launch():
                continue               # warm-start entries keep the base
                                       # one-at-a-time semantics
            order = self._free_priority_order()
            if self.assign == "sequential":
                order = order[:1]      # a batch of one = per-device decision
            devices = [self._free[i] for i in order]
            # class rows: unique class names in first-appearance order
            cls_names: list[str] = []
            rows: list[int] = []
            for d in devices:
                name = self.fleet.slices[d].cls
                if name not in cls_names:
                    cls_names.append(name)
                rows.append(cls_names.index(name))
            if self.speed_oblivious:
                rates = np.ones(len(cls_names), np.float32)
                overheads = np.zeros(len(cls_names), np.float32)
            else:
                rates, overheads = self.registry.rows(cls_names)

            t0 = _time.perf_counter()
            # a disabled tracer costs one test a site and opens no span
            traced = self.tracer.enabled
            if traced:
                with self.tracer.span("decide", batch=len(devices),
                                      classes=len(cls_names)):
                    vals, gids = self.cp.choose_mdmt_batch(
                        rates, overheads, k=len(devices),
                        class_names=cls_names)
            else:
                vals, gids = self.cp.choose_mdmt_batch(
                    rates, overheads, k=len(devices), class_names=cls_names)
            dt = _time.perf_counter() - t0
            self._decision_seconds += dt
            self._decisions += 1
            self._scoring_passes += 1
            if self.metrics is not None:
                self._m_decision_s.observe(dt)
                self.metrics.counter("engine.scoring_passes").inc()

            if traced:
                with self.tracer.span("assign", batch=len(devices)):
                    pairs = greedy_assign(vals, gids, rows)
            else:
                pairs = greedy_assign(vals, gids, rows)
            if not pairs:
                return                 # pool exhausted for every free device
            for pos, model in pairs:
                # indices shift as devices launch: resolve by slice id
                self._launch_on(self._free.index(devices[pos]), model, -1)
                self._policy_launches += 1
            if len(pairs) < len(devices):
                return                 # the leftovers found nothing either


__all__ = ["DevPlaneEngine", "ASSIGN_MODES"]
