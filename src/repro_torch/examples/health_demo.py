"""Adversarial health-plane demo: one seeded trace, every watchdog fires.

The port's counterpart of the reference's ``examples/health_demo.py``: the
same hand-built trace, engine and checks, on ``--device`` (default: the
card; ``--device cpu`` runs the plain versions on the CPU, and without a
card the default raises).  The trace trips each detector class of
``repro_torch.obs.HealthMonitor`` in a single run:

  regret_stall     tenant 0 has 14 models with IDENTICAL ground truth — the
                   first observation sets the incumbent and the next 13 never
                   improve it, crossing ``stall_k``
  gp_conditioning  tenant 1's two models are near-duplicates under the
                   kernel (correlation 0.99999): folding the second drives
                   the Cholesky pivot d² to the jitter floor
  class_starvation the fleet sits idle from ~t=5; at t=50 a simultaneous-
                   arrival burst creates backlog while launches are still
                   deferred to the end of the admission batch
  queue_runaway    the burst (12 tenants x 4 models) overflows the
                   ``max_live_models=20`` cap; admission-queue depth climbs
                   through ``queue_limit`` while rising
  slo_burn         the SLO demands device_utilization >= 0.9 from a mostly
                   idle fleet — every window burns (severity ``page``)
  memory_runaway   the memory budget (1 KiB) is smaller than tenant 0's
                   posterior block alone (severity ``page``)
  straggler        act 3 (t=100): tenant 20's trials hang on all four
                   devices; supervision kills each at ``timeout_factor x
                   predicted_seconds``
  retry_storm      the four killed models re-queue with backoff inside one
                   sliding window, crossing ``retry_storm_k`` (``page``)
  quarantine_flap  slice 0 hangs again and again: three strikes quarantine
                   it, probation re-admits it, the next hang re-quarantines
  poisoned_observation  a TrialPoison makes slice 1's trial return NaN; the
                   GP-ingest guard rejects it and alerts

The failure-domain detectors need the hardened device plane, so the engine
is a DevPlaneEngine with trial supervision and the quarantine scoreboard.
The run also exercises windowed export, forensics and the capacity
accountant, and re-runs a bare twin (planes off, supervision identical)
whose trials must be byte-identical.

  PYTHONPATH=src python -m repro_torch.examples.health_demo --device cpu --report-dir demo_report
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.core.fleet import Fleet
from repro_torch.devplane import DevPlaneEngine, QuarantinePolicy
from repro_torch.obs import (ALERT_KINDS, CapacityAccountant, ForensicsRecorder,
                             HealthMonitor, MetricsExporter, MetricsRegistry,
                             Tracer, write_report)
from repro_torch.stream import (ChurnTrace, TenantArrive, TenantDepart,
                                TrialHang, TrialPoison)

SLO = {"device_utilization": 0.9}


def adversarial_trace() -> ChurnTrace:
    """The module-docstring scenario, seeded and fully deterministic."""
    rng = np.random.default_rng(7)
    ev: list = []

    # tenant 0: the staller — flat ground truth, nothing ever improves
    m = 14
    ev.append(TenantArrive(at=0.0, tenant_key=0, K_block=0.04 * np.eye(m),
                           mu0=np.zeros(m), cost=np.ones(m),
                           z_true=np.full(m, 0.5)))
    # tenant 1: near-duplicate pair — the conditioning pathology
    rho = 0.99999
    ev.append(TenantArrive(at=0.0, tenant_key=1,
                           K_block=0.04 * np.array([[1.0, rho], [rho, 1.0]]),
                           mu0=np.zeros(2), cost=np.ones(2),
                           z_true=np.array([0.3, 0.3])))
    ev.append(TenantDepart(at=30.0, tenant_key=0))
    ev.append(TenantDepart(at=30.0, tenant_key=1))

    # t=50: simultaneous-arrival burst — backlog appears while the fleet
    # has been idle, and the admission cap turns the tail into a queue
    for i in range(12):
        k = 4
        ev.append(TenantArrive(
            at=50.0, tenant_key=2 + i, K_block=0.04 * np.eye(k),
            mu0=np.zeros(k), cost=np.ones(k),
            z_true=rng.uniform(0.2, 0.9, size=k)))
    for i in range(12):
        ev.append(TenantDepart(at=90.0, tenant_key=2 + i))

    # act 3 (t=100): the failure-domain scenario.  tenant 20's uniform
    # cost 10 makes every deadline land at launch + 15 (timeout_factor
    # 1.5): hanging all four devices at t=101 produces four stragglers
    # whose re-queues form a retry storm at t=115; slice 0 then hangs
    # after every re-launch — three strikes quarantine it, probation
    # re-admits it, the next hang re-quarantines: the flap.  slice 1's
    # t=115 launch is poisoned and returns NaN at t=125.
    m = 18
    ev.append(TenantArrive(at=100.0, tenant_key=20, K_block=0.04 * np.eye(m),
                           mu0=np.zeros(m), cost=np.full(m, 10.0),
                           z_true=rng.uniform(0.2, 0.9, size=m)))
    for sid in range(4):
        ev.append(TrialHang(at=101.0, slice_id=sid))
    ev.append(TrialPoison(at=116.0, slice_id=1))
    for at in (116.0, 131.0, 156.0):
        ev.append(TrialHang(at=at, slice_id=0))
    ev.append(TenantDepart(at=250.0, tenant_key=20))
    return ChurnTrace(tuple(ev), name="health-demo-adversarial")


def planes() -> dict:
    """A fresh set of every plane, as the demo configures them."""
    metrics = MetricsRegistry()
    return dict(
        tracer=Tracer(enabled=True), metrics=metrics,
        health=HealthMonitor(
            slo=SLO, window=10.0, burn_windows=2, burn_threshold=0.75,
            stall_k=8, queue_limit=6, starvation_window=10.0,
            memory_budget_bytes=1024),
        forensics=ForensicsRecorder(),
        exporter=MetricsExporter(metrics, window=10.0),
        accounting=CapacityAccountant(metrics, window=10.0))


def make_engine(device=None, **kw) -> DevPlaneEngine:
    """The hardened device plane on four slices.  Supervision and the
    quarantine scoreboard change decisions, so the bare twin keeps them;
    only the planes (passed in ``kw``) must be observation-only."""
    fleet = Fleet.partition_pod(total_chips=128, num_slices=4)
    return DevPlaneEngine(
        fleet, "mdmt", seed=0, max_live_models=20,
        timeout_factor=1.5, max_retries=3, retry_backoff=1.0,
        quarantine=QuarantinePolicy(threshold=3, window=100.0,
                                    duration=10.0, probation_trials=2),
        device=device, **kw)


def run(device=None):
    """The planes-on run and its bare twin; raises unless every detector
    class fired and the twin's trials are byte-identical.  Returns the
    planes-on engine, its result and the twin's result."""
    trace = adversarial_trace()
    eng = make_engine(device, **planes())
    res = eng.run(trace)
    fired = {a.kind for a in eng.health.alerts}
    missing = [k for k in ALERT_KINDS if k not in fired]
    if missing:
        raise RuntimeError(f"detector classes that never fired: {missing}")
    twin = make_engine(device).run(trace)
    if ([dataclasses.astuple(t) for t in res.trials]
            != [dataclasses.astuple(t) for t in twin.trials]):
        raise RuntimeError("an observability plane changed the decision "
                           "sequence")
    return eng, res, twin


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the CPU)")
    p.add_argument("--report-dir", default=None, metavar="PATH",
                   help="write the experiment directory (PATH/<run_id>/ "
                        "with the alert table in report.html)")
    args = p.parse_args(argv)
    eng, res, _ = run(args.device)

    by_kind: dict[str, int] = {}
    for a in eng.health.alerts:
        by_kind[a.kind] = by_kind.get(a.kind, 0) + 1
    print(f"{len(eng.health.alerts)} alerts on {eng.cp.device}: "
          f"{json.dumps(by_kind, sort_keys=True)}")
    for a in eng.health.alerts:
        print(f"  [{a.severity}] t={a.t:5.1f} ev={a.event_index:3d} "
              f"{a.kind:17s} subject={a.subject} {json.dumps(a.detail)}")
    print(f"\nbare twin identical=True; "
          f"{len(eng.forensics.records)} forensics records, "
          f"{len(eng.exporter.records)} export windows, "
          f"{len(eng.accounting.samples)} capacity samples")

    if args.report_dir:
        trace_name = res.trace_name
        run_dir = write_report(
            args.report_dir, trace_name,
            telemetry=res.telemetry, tracer=eng.tracer,
            metrics=eng.metrics, result=res,
            alerts=eng.health.alerts, forensics=eng.forensics.records,
            accounting=eng.accounting,
            meta={"policy": "mdmt", "slices": 4, "seed": 0,
                  "events": adversarial_trace().num_events, "slo": SLO,
                  "adversarial": True})
        print(f"report -> {run_dir}")
    print("ok")
    return eng, res


if __name__ == "__main__":
    main()
