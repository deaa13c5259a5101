"""Elastic device plane benchmark: device churn + joint batched assignment.

The port of the JAX package's ``benchmarks/device_churn.py``, on the
port's ``DevPlaneEngine`` (batched assignment: one class-axis EIrate
launch, kernel 4, a scoring pass).  Three measurements on 2-speed-class
fleets under device churn (joins, leaves, preemptions overlaid on tenant
churn):

* ``device_churn_assign_{sequential,batched}`` — decision seconds per
  policy-launched trial.  Uniform base costs synchronize completions into
  waves, so the batched path solves each k-device wave in ONE scoring pass
  (per-class top-k + greedy auction) where sequential pays k.

* ``device_churn_regret_{devplane,oblivious}`` — regret at the horizon
  under scarcity (N >> M, short sessions, lognormal costs, per-trial
  overhead): the full device plane (joint batched assignment,
  fastest-free-first, queue-depth autoscale joining fast devices) vs the
  static speed-oblivious baseline (sequential per-device argmax of EI/c,
  stack-order placement, fixed fleet), averaged over seeded traces.  Each
  run is deterministic.

* ``device_churn_autoscale_{fixed,autoscale}`` — the queue-depth-driven
  autoscaler on the same scarce workload from a minimal fleet: how many
  devices it adds/retires and what that does to time to first observation.

The first runs of ``bench_assign`` are warm-ups: they take the lazy kernel
builds and the first library calls out of the timed runs.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve
from ..devplane import AutoscalePolicy, DevPlaneEngine, two_class_registry
from ..stream import device_churn_trace
from . import common
from .common import emit, timed


def _wave_trace(sessions: int, slices: int):
    """Uniform costs => completion waves (the batched path's best case is
    also the service's common case: synchronized trial lengths)."""
    return device_churn_trace(
        num_sessions=sessions, arrival_rate=4.0, seed=0,
        initial_slices=slices, join_classes=(("fast", 16, 2.0),),
        join_rate=0.05, leave_rate=0.02, preempt_rate=0.03,
        m_min=2, m_max=16, session_scale=25.0, cost="uniform")


def bench_assign(device=None) -> None:
    dev = resolve(device)
    sessions, half = (60, 4) if common.FAST else (150, 8)
    reg = two_class_registry(2.0, overhead=0.0)

    def run(assign: str):
        eng = DevPlaneEngine(
            reg.build_fleet([("slow", half), ("fast", half)]), "mdmt",
            seed=0, registry=reg, assign=assign,
            max_live_models=200, device=dev)
        res = eng.run(_wave_trace(sessions, 2 * half))
        return res, eng

    for assign in ("sequential", "batched"):
        run(assign)                       # warm-up (kernel builds, all k's)
    for assign in ("sequential", "batched"):
        wall, (res, eng) = timed(run, assign)
        s = res.telemetry.summary()
        emit(
            f"device_churn_assign_{assign}",
            1e6 * res.decision_seconds / max(res.policy_launches, 1),
            sessions=sessions,
            slices=2 * half,
            scoring_passes=eng._scoring_passes,
            policy_launches=res.policy_launches,
            trials=s["trials"],
            preempted=s["trials_preempted"],
            devices_joined=s["devices_joined"],
            devices_left=s["devices_left"],
            wall_s=f"{wall:.2f}",
        )


def _scarce_trace(sessions: int, slices: int, seed: int = 3):
    """N >> M with short heavy-tailed sessions and lognormal costs: tenants
    depart unexplored, so scheduling quality shows up as regret."""
    return device_churn_trace(
        num_sessions=sessions, arrival_rate=3.0, seed=seed,
        initial_slices=slices, join_classes=(("fast", 16, 2.0),),
        join_rate=0.1, leave_rate=0.05, preempt_rate=0.05,
        m_min=6, m_max=30, session_scale=8.0, cost="lognormal")


def bench_regret_at_horizon(device=None) -> None:
    dev = resolve(device)
    sessions, horizon, seeds = (40, 40.0, 2) if common.FAST else (80, 60.0, 10)
    reg = two_class_registry(2.0, overhead=0.5)

    def build(name: str) -> DevPlaneEngine:
        fleet = reg.build_fleet([("slow", 2), ("fast", 2)])
        if name == "devplane":
            return DevPlaneEngine(
                fleet, "mdmt", seed=0, registry=reg, assign="batched",
                launch_order="fastest", max_live_models=100,
                autoscale=AutoscalePolicy(
                    high_backlog=6.0, low_backlog=1.0, cooldown=2.0,
                    join_class="fast", min_devices=2, max_devices=12),
                device=dev)
        return DevPlaneEngine(
            fleet, "mdmt", seed=0, registry=reg, assign="sequential",
            launch_order="lifo", speed_oblivious=True, max_live_models=100,
            device=dev)

    for name in ("devplane", "oblivious"):
        regrets, served, trials, joined, dec_us = [], 0, 0, 0, []
        for seed in range(seeds):
            eng = build(name)
            res = eng.run(_scarce_trace(sessions, 4, seed=seed),
                          horizon=horizon)
            s = res.telemetry.summary()
            if s["tenant_regret_mean"] is not None:
                regrets.append(s["tenant_regret_mean"])
            served += s["sessions_served"]
            trials += s["trials"]
            joined += s["devices_joined"]
            dec_us.append(1e6 * res.decision_seconds
                          / max(res.policy_launches, 1))
        emit(
            f"device_churn_regret_{name}",
            float(np.mean(dec_us)),
            horizon=horizon,
            sessions=sessions,
            seeds=seeds,
            regret_mean=(f"{np.mean(regrets):.6f}" if regrets else "na"),
            regret_max=(f"{np.max(regrets):.6f}" if regrets else "na"),
            sessions_served=served,
            trials=trials,
            devices_joined=joined,
        )


def bench_autoscale(device=None) -> None:
    dev = resolve(device)
    sessions, horizon = (40, 40.0) if common.FAST else (80, 60.0)
    reg = two_class_registry(2.0, overhead=0.5)
    configs = {
        "fixed": None,
        "autoscale": AutoscalePolicy(high_backlog=6.0, low_backlog=1.0,
                                     cooldown=2.0, join_class="fast",
                                     min_devices=2, max_devices=12),
    }
    for name, policy in configs.items():
        eng = DevPlaneEngine(
            reg.build_fleet([("slow", 1), ("fast", 1)]), "mdmt", seed=0,
            registry=reg, assign="batched", launch_order="fastest",
            autoscale=policy, max_live_models=100, device=dev)
        res = eng.run(_scarce_trace(sessions, 2), horizon=horizon)
        s = res.telemetry.summary()
        emit(
            f"device_churn_autoscale_{name}",
            1e6 * res.decision_seconds / max(res.policy_launches, 1),
            devices_joined=s["devices_joined"],
            devices_left=s["devices_left"],
            trials=s["trials"],
            sessions_served=s["sessions_served"],
            ttfo_p99=(f"{s['ttfo_p99']:.2f}"
                      if s["ttfo_p99"] is not None else "na"),
            regret_mean=(f"{s['tenant_regret_mean']:.6f}"
                         if s["tenant_regret_mean"] is not None else "na"),
        )


def main(device=None) -> None:
    bench_assign(device)
    bench_regret_at_horizon(device)
    bench_autoscale(device)


if __name__ == "__main__":
    common.run_standalone("torch_device_churn", main, __doc__)
