"""Event-driven multi-device, multi-tenant schedulers (Algorithm 1 + baselines).

Implements the paper's policy loop: *as long as there is a device available,
select a model to run on this device*.  The simulator is a discrete-event
engine over virtual time; the per-event decision core (GP update + EIrate
pick) lives in ``control_plane.ControlPlane``.  The event bookkeeping is
host Python and the math runs on ``device`` (the card unless the caller
asks for the CPU) — the split a real service has: control decisions on the
coordinator, math on an accelerator.

``num_devices`` is the paper's M, the number of simulated trial devices;
``device`` is where the port's tensors live.  They are unrelated.

Policies
--------
* ``mdmt``        — MM-GP-EI (the paper): global argmax of EIrate (eq. 6).
* ``round_robin`` — each tenant runs their own GP-EI; tenants served cyclically.
* ``random``      — each tenant runs their own GP-EI; tenant chosen uniformly.

All policies share the experimental protocol of Section 6.1: a warm start
that trains the two fastest models of every tenant first, then the policy
takes over.  Device failures re-queue the failed model; heterogeneous
device speeds make EIrate device-aware, ``EI(x) / (c(x)/speed_d)``.
"""

from __future__ import annotations

import heapq
import time as _time
from dataclasses import dataclass

import numpy as np

from ..device import resolve
from .control_plane import ControlPlane, warm_start_queue
from .tenancy import Problem

POLICIES = ("mdmt", "round_robin", "random")


@dataclass(frozen=True)
class TrialRecord:
    model: int
    user_hint: int          # tenant that motivated the launch (-1 for mdmt global)
    device: int
    start: float
    end: float
    z: float | None         # None => trial failed (device died)


@dataclass(frozen=True)
class FailureEvent:
    device: int
    at: float
    downtime: float


@dataclass
class SimResult:
    problem: Problem
    policy: str
    num_devices: int
    trials: list[TrialRecord]
    end_time: float
    decisions: int
    decision_seconds: float  # host+accelerator time inside policy decisions

    @property
    def observations(self) -> list[tuple[float, int, float]]:
        """(finish_time, model, z) for successful trials, time-ordered."""
        obs = [(t.end, t.model, t.z) for t in self.trials if t.z is not None]
        obs.sort()
        return obs


def simulate(
    problem: Problem,
    policy: str,
    num_devices: int,
    seed: int = 0,
    horizon: float = np.inf,
    warm_start: int = 2,
    device_speeds: np.ndarray | None = None,
    failures: list[FailureEvent] | None = None,
    device=None,
) -> SimResult:
    """Run one TSHB episode and return the full trial log.

    The loop mirrors Algorithm 1: whenever a device frees (or at t=0), refresh
    the posterior with all observations, then launch the policy's pick.
    ``warm_start`` is the number of fastest models per tenant trained before
    the policy takes over (Section 6.1 protocol uses 2; pass 0 to start with
    the pure algorithm, whose line 1 initialization is the prior-mean argmax).
    ``device=None`` runs on the card and raises if there is none.
    """
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
    device = resolve(device)
    problem.validate()
    rng = np.random.default_rng(seed)
    state = ControlPlane.from_problem(problem, rng, device=device)
    speeds = np.ones(num_devices) if device_speeds is None else np.asarray(device_speeds, float)
    if speeds.shape != (num_devices,):
        raise ValueError(f"device_speeds must have shape ({num_devices},), "
                         f"got {speeds.shape}")

    fail_sched: dict[int, list[FailureEvent]] = {d: [] for d in range(num_devices)}
    for f in failures or []:
        fail_sched[f.device].append(f)
    for evs in fail_sched.values():
        evs.sort(key=lambda f: f.at)

    pending = warm_start_queue(problem, warm_start)

    heap: list[tuple[float, int, str, tuple]] = []  # (time, seq, kind, payload)
    seq = 0

    def push(t: float, kind: str, payload: tuple) -> None:
        nonlocal seq
        heapq.heappush(heap, (t, seq, kind, payload))
        seq += 1

    trials: list[TrialRecord] = []
    decisions = 0
    decision_seconds = 0.0
    free = list(range(num_devices))
    t_now = 0.0

    chooser = state.chooser(policy)

    def try_launch() -> None:
        nonlocal decisions, decision_seconds
        while free:
            if t_now >= horizon:
                return
            d = free[-1]
            if pending:
                model, user_hint = pending.pop(0), -2
                if state.selected[model]:
                    continue
            else:
                t0 = _time.perf_counter()
                pick = chooser(device_speed=speeds[d])
                decision_seconds += _time.perf_counter() - t0
                decisions += 1
                if pick is None:
                    return
                model, user_hint = pick
            free.pop()
            dur = float(problem.cost[model]) / speeds[d]
            end = t_now + dur
            state.record_start(model)
            # Device-failure check: does a scheduled failure interrupt this trial?
            fut = [f for f in fail_sched[d] if t_now <= f.at < end]
            if fut:
                f = fut[0]
                fail_sched[d].remove(f)
                trials.append(TrialRecord(model, user_hint, d, t_now, f.at, None))
                push(f.at, "fail", (d, model, f.downtime))
            else:
                trials.append(TrialRecord(model, user_hint, d, t_now, end, None))
                push(end, "finish", (d, model, len(trials) - 1))

    try_launch()
    while heap:
        t_now, _, kind, payload = heapq.heappop(heap)
        if kind == "finish":
            d, model, ti = payload
            z = float(problem.z_true[model])
            trials[ti] = TrialRecord(
                trials[ti].model, trials[ti].user_hint, d,
                trials[ti].start, trials[ti].end, z)
            state.record_observation(model, z)
            free.append(d)
        elif kind == "fail":
            d, model, downtime = payload
            state.record_failure(model)
            push(t_now + downtime, "recover", (d,))
        elif kind == "recover":
            (d,) = payload
            free.append(d)
        if t_now < horizon:
            try_launch()

    return SimResult(
        problem=problem, policy=policy, num_devices=num_devices,
        trials=trials, end_time=t_now, decisions=decisions,
        decision_seconds=decision_seconds)
