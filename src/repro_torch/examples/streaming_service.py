"""Streaming multi-tenant GP-EI service demo: tenants churn, the fleet serves.

The port's counterpart of the reference's ``examples/streaming_service.py``,
with its trace, settings, flags and checks, on ``--device`` (default: the
card; ``--device cpu`` runs the plain versions on the CPU, and without a
card the default raises).  It generates a seeded churn trace (Poisson
arrivals, heavy-tailed session lengths, Zipf-skewed candidate-set sizes),
replays it through the streaming engine over an 8-slice fleet with
admission control, and prints the service-level telemetry, per-device and
speed-weighted utilization included.

  --device-churn  the elastic device plane: a 2-speed-class fleet with device
                  joins, leaves and preemptions, joint batched assignment and
                  an autoscaler
  --crash-at N    kill the run at processed event N, rebuild it from its
                  durable log and newest snapshot, resume, and compare with
                  an uninterrupted run
  --trace         decision-path spans, the metrics registry and windowed
                  export; --health the SLO burn-rate and watchdog monitor;
                  --forensics per-decision attribution; --capacity the
                  resource accountant.  Any of them adds a bare twin run,
                  whose trial sequence must be byte-identical
  --chaos         a seeded chaos overlay (trial hangs, poisoned losses, slice
                  flakes, device losses) served by the hardened engine (trial
                  supervision, device quarantine); then, on the trace's
                  failure-free twin, supervision on must equal supervision off
  --report-dir P  write the run's experiment directory (P/<run_id>/)

  PYTHONPATH=src python -m repro_torch.examples.streaming_service --device cpu --events 50
  PYTHONPATH=src python -m repro_torch.examples.streaming_service --events 60 \\
      --trace --health --forensics --capacity --report-dir obs_report
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

from repro_torch.core.fleet import Fleet
from repro_torch.devplane import (AutoscalePolicy, DevPlaneEngine,
                                  QuarantinePolicy, two_class_registry)
from repro_torch.obs import (CapacityAccountant, ForensicsRecorder,
                             HealthMonitor, MetricsExporter, MetricsRegistry,
                             Tracer, write_report)
from repro_torch.stream import (EventLog, FaultInjector, SimulatedCrash,
                                StreamEngine, chaos_trace, device_churn_trace,
                                poisson_churn_trace, recover)

SLO = {"device_utilization": 0.25, "ttfo_p99": 100.0}
#: the planes-off keyword arguments of a bare twin
BARE = dict(tracer=None, metrics=None, exporter=None, health=None,
            forensics=None, accounting=None)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--events", type=int, default=400,
                   help="approximate external events in the trace "
                        "(one session = arrive + depart)")
    p.add_argument("--slices", type=int, default=8)
    p.add_argument("--policy", choices=("mdmt", "round_robin", "random"),
                   default="mdmt")
    p.add_argument("--max-live-models", type=int, default=120,
                   help="admission-control cap (0 disables)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the CPU)")
    p.add_argument("--device-churn", action="store_true",
                   help="elastic 2-speed-class fleet with device churn + "
                        "autoscale (repro_torch.devplane)")
    p.add_argument("--chaos", action="store_true",
                   help="seeded chaos overlay served by the hardened engine; "
                        "verifies supervision-off byte-identity on the "
                        "failure-free twin")
    p.add_argument("--crash-at", type=int, default=None, metavar="N",
                   help="kill the engine at processed event N, recover, "
                        "resume, and verify the replay matches an "
                        "uninterrupted run")
    p.add_argument("--telemetry-json", default=None,
                   help="optional path for the full telemetry dump")
    p.add_argument("--trace", action="store_true",
                   help="decision-path tracing + metrics + windowed export, "
                        "checked against an untraced twin run")
    p.add_argument("--health", action="store_true",
                   help="attach the SLO burn-rate / watchdog monitor")
    p.add_argument("--forensics", action="store_true",
                   help="record per-decision attribution")
    p.add_argument("--capacity", action="store_true",
                   help="attach the capacity accountant")
    p.add_argument("--report-dir", default=None, metavar="PATH",
                   help="write the per-run experiment directory "
                        "(PATH/<run_id>/ with summary.json, timeline.csv, "
                        "report.html)")
    return p


def make_trace(args):
    """The reference's trace for these flags."""
    sessions = max(1, args.events // 2)
    if args.chaos:
        return chaos_trace(
            num_sessions=sessions, arrival_rate=1.0, seed=args.seed,
            initial_slices=args.slices, hang_rate=0.15, poison_rate=0.10,
            flake_rate=0.05, loss_rate=0.02,
            m_min=2, m_max=16, session_scale=25.0)
    if args.device_churn:
        return device_churn_trace(
            num_sessions=sessions, arrival_rate=1.0, seed=args.seed,
            initial_slices=args.slices,
            join_classes=(("fast", 32, 2.0), ("slow", 32, 1.0)),
            join_rate=0.05, leave_rate=0.02, preempt_rate=0.03,
            m_min=2, m_max=16, session_scale=25.0)
    return poisson_churn_trace(
        num_sessions=sessions, arrival_rate=1.0, seed=args.seed,
        m_min=2, m_max=16, session_scale=25.0,
        num_failure_slices=min(2, args.slices))


def engine_factory(args):
    """``make_engine(**kw)``: a fresh engine (and a fresh, mutable Fleet)
    per run, with fresh planes as the flags ask; keyword arguments override
    them (``**BARE`` gives the bare twin)."""
    def make_engine(**kw):
        if args.trace and "tracer" not in kw:
            kw["tracer"] = Tracer(enabled=True)
            kw["metrics"] = MetricsRegistry()
            kw["exporter"] = MetricsExporter(kw["metrics"], window=20.0)
        if args.health and "health" not in kw:
            kw["health"] = HealthMonitor(slo=SLO, window=20.0)
        if args.forensics and "forensics" not in kw:
            kw["forensics"] = ForensicsRecorder()
        if args.capacity and "accounting" not in kw:
            if kw.get("metrics") is None:
                kw["metrics"] = MetricsRegistry()
            kw["accounting"] = CapacityAccountant(kw["metrics"], window=20.0)
        kw.setdefault("device", args.device)
        cap = args.max_live_models or None
        if args.chaos:
            kw.setdefault("timeout_factor", 2.5)
            kw.setdefault("max_retries", 2)
            kw.setdefault("retry_backoff", 1.0)
            kw.setdefault("quarantine",
                          QuarantinePolicy(threshold=3, window=60.0,
                                           duration=30.0))
            fleet = Fleet.partition_pod(total_chips=32 * args.slices,
                                        num_slices=args.slices)
            return DevPlaneEngine(fleet, args.policy, seed=args.seed,
                                  max_live_models=cap, **kw)
        if args.device_churn:
            reg = two_class_registry(2.0, overhead=0.5, chips=32)
            half = max(1, args.slices // 2)
            fleet = reg.build_fleet([("slow", args.slices - half),
                                     ("fast", half)])
            return DevPlaneEngine(
                fleet, args.policy, seed=args.seed, registry=reg,
                assign="batched", launch_order="fastest",
                autoscale=AutoscalePolicy(join_class="fast", cooldown=5.0,
                                          max_devices=2 * args.slices),
                max_live_models=cap, **kw)
        fleet = Fleet.partition_pod(total_chips=32 * args.slices,
                                    num_slices=args.slices)
        return StreamEngine(fleet, args.policy, seed=args.seed,
                            max_live_models=cap, **kw)
    return make_engine


def trials(res) -> list[tuple]:
    return [dataclasses.astuple(t) for t in res.trials]


def demo_crash_recovery(make_engine, trace, crash_at, ref_res) -> None:
    """Kill a durable run at processed event ``crash_at``, recover from the
    log and newest snapshot, resume, and require the uninterrupted run's
    trials and telemetry."""
    with tempfile.TemporaryDirectory() as d:
        logdir, snapdir = f"{d}/log", f"{d}/snapshots"
        eng = make_engine(log=EventLog(logdir), snapshot_root=snapdir,
                          snapshot_every=16,
                          fault=FaultInjector(crash_at, "before"))
        try:
            eng.run(trace)
            print(f"\n--crash-at {crash_at}: the run only processed "
                  f"{eng.event_index} events — nothing to crash")
            return
        except SimulatedCrash as e:
            print(f"\ncrash injected: {e}")
        finally:
            eng.log.close()
        eng2, resumed_from = recover(make_engine, snapdir,
                                     EventLog.load(logdir))
        print(f"recovered from snapshot at event {resumed_from} "
              f"(+ log replay); resuming...")
        res2 = eng2.resume()
        same_trials = trials(res2) == trials(ref_res)
        same_summary = res2.telemetry.summary() == ref_res.telemetry.summary()
        print(f"replayed {eng2.event_index - resumed_from} events: "
              f"trials identical={same_trials}, "
              f"telemetry identical={same_summary}")
        if not (same_trials and same_summary):
            raise RuntimeError("crash recovery diverged from the "
                               "uninterrupted run")


def main(argv=None):
    """Runs the demo; returns the planes-on engine and its result."""
    p = parser()
    args = p.parse_args(argv)
    if args.chaos and args.device_churn:
        p.error("--chaos and --device-churn are separate demos")
    trace = make_trace(args)
    print(f"trace: {trace.name} ({trace.num_events} events, "
          f"{trace.num_sessions} sessions)")
    make_engine = engine_factory(args)

    t0 = time.perf_counter()
    eng = make_engine()
    res = eng.run(trace)
    wall = time.perf_counter() - t0

    if args.crash_at is not None:
        demo_crash_recovery(make_engine, trace, args.crash_at, res)

    s = res.telemetry.summary()
    print(f"\nreplayed in {wall:.2f}s wall on {eng.cp.device} "
          f"({res.decisions} decisions, "
          f"{1e6 * res.decision_seconds / max(res.decisions, 1):.0f} µs each)")
    print(json.dumps(s, indent=2, sort_keys=True))
    per_dev = res.telemetry.per_device()
    print("\nper-device utilization (busy / in-service window):")
    for d in sorted(per_dev):
        pd = per_dev[d]
        left = "-" if pd["left"] is None else f"{pd['left']:.1f}"
        print(f"  slice {d:3d}  speed {pd['speed']:.1f}  "
              f"window [{pd['joined']:.1f}, {left}]  "
              f"trials {pd['trials']:3d}  util {pd['utilization']:.3f}")
    if args.telemetry_json:
        path = res.telemetry.to_json(
            args.telemetry_json, metrics=eng.metrics,
            alerts=eng.health.alerts if args.health else None)
        print(f"telemetry -> {path}")

    if args.health:
        by_kind: dict[str, int] = {}
        for a in eng.health.alerts:
            by_kind[a.kind] = by_kind.get(a.kind, 0) + 1
        print(f"\nhealth: {len(eng.health.alerts)} alerts "
              f"{json.dumps(by_kind, sort_keys=True)}")
        for a in eng.health.alerts[:5]:
            print(f"  [{a.severity}] t={a.t:.1f} {a.kind} "
                  f"subject={a.subject} {json.dumps(a.detail)}")

    if args.forensics:
        recs = eng.forensics.records
        flips = sum(1 for r in recs
                    if (r.get("uniform_cost") or {}).get("changes_pick"))
        print(f"\nforensics: {len(recs)} decisions recorded, "
              f"{flips} flip under uniform cost")
        if recs:
            print("  sample:", json.dumps(recs[0]))

    if args.capacity:
        last = eng.accounting.latest() or {}
        print(f"\ncapacity: {len(eng.accounting.samples)} samples; final "
              f"gp_bytes={last.get('gp_bytes')} "
              f"projected={last.get('gp_bytes_projected')} "
              f"imbalance={last.get('load_imbalance')}")

    if args.chaos:
        print(f"\nchaos: trials_timed_out={s['trials_timed_out']} "
              f"trials_retried={s['trials_retried']} "
              f"devices_quarantined={s['devices_quarantined']} "
              f"observations_rejected={s['observations_rejected']}")
        # supervision is decision-neutral when nothing fails: every
        # deadline loses the race against its real completion
        twin_trace = trace.twin()
        hardened = make_engine().run(twin_trace)
        bare = make_engine(timeout_factor=None, quarantine=None).run(
            twin_trace)
        same = trials(hardened) == trials(bare)
        print(f"failure-free twin ({twin_trace.num_events} events): "
              f"supervision-on == supervision-off byte-identical={same}")
        if not same:
            raise RuntimeError("supervision changed a decision on a "
                               "chaos-free trace")

    if args.trace or args.health or args.forensics or args.capacity:
        # the observation-only guarantee: a bare twin of the same run makes
        # byte-identical decisions
        twin = make_engine(**BARE).run(trace)
        same = trials(res) == trials(twin)
        n_spans = len(eng.tracer.records()) if args.trace else 0
        print(f"\nobs-enabled run: {n_spans} spans over {eng.event_index} "
              f"events; bare twin identical={same}")
        if not same:
            raise RuntimeError("an observability plane changed the "
                               "decision sequence")

    if args.report_dir:
        run_dir = write_report(
            args.report_dir, trace.name,
            telemetry=res.telemetry,
            tracer=eng.tracer if args.trace else None,
            metrics=eng.metrics,
            result=res,
            alerts=eng.health.alerts if args.health else None,
            forensics=eng.forensics.records if args.forensics else None,
            accounting=eng.accounting if args.capacity else None,
            meta={"policy": args.policy, "slices": args.slices,
                  "seed": args.seed, "events": trace.num_events,
                  "traced": args.trace, "wall_s": round(wall, 3),
                  "slo": SLO})
        print(f"report -> {run_dir}")

    # the run must have served tenants, each tenant model observed once
    # (global model ids are recycled across sessions)
    seen = [(t.tenant_key, t.local_model) for t in res.trials
            if t.z is not None]
    if not (s["sessions"] == trace.num_sessions and s["trials"] > 0
            and s["sessions_served"] > 0 and len(seen) == len(set(seen))):
        raise RuntimeError(f"the run served no tenant as it should: {s}")
    print("ok")
    return eng, res


if __name__ == "__main__":
    main()
