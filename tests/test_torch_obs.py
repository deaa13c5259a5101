"""The port's observability planes against the JAX package's, on the CPU.

Metrics, export, health, forensics and report are the reference's pure
Python, copied: driven by the same inputs, the two packages must give equal
registry snapshots, Prometheus text, export records, alert records,
forensics records and report files, byte for byte (the port's span rows
add the thread's CPU time, ``cpu_us``).  Wired into the engines,
the planes must see the same run as the reference's: equal alerts, export
windows (their sim-time fields) and forensics winners, the forensics values
within FORENSICS_RTOL.  Left out of every comparison: the wall-clock fields
(span durations, the ``engine.decision_seconds`` / ``snapshot_seconds`` /
``compaction_pause_seconds`` histograms, ``engine.decisions_per_s``, hence
the ``metrics`` payload of export records) and the forensics record's
``scorer`` (the reference's ``"fused"`` is the port's ``"ops"``).

With every plane on, each engine's trials equal its bare twin's; a crash
at several points replays the span tree, alerts, forensics and export
windows of the uninterrupted run; the sharded scorer's phased decision
picks what its fused decision picks.
"""

import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.obs as JO  # noqa: E402
import repro.stream as JS  # noqa: E402
from repro.core.control_plane import ControlPlane as JCP  # noqa: E402
from repro.core.fleet import Fleet as JFleet  # noqa: E402
from repro.devplane import DevPlaneEngine as JDev  # noqa: E402
from repro.devplane import QuarantinePolicy as JQuarantine  # noqa: E402
from repro.devplane import two_class_registry as j_registry  # noqa: E402
import repro_torch.obs as TO  # noqa: E402
import repro_torch.stream as TS  # noqa: E402
from repro_torch.core.control_plane import ControlPlane as TCP  # noqa: E402
from repro_torch.core.fleet import Fleet as TFleet  # noqa: E402
from repro_torch.devplane import DevPlaneEngine as TDev  # noqa: E402
from repro_torch.devplane import two_class_registry as t_registry  # noqa: E402
from repro_torch.examples import health_demo, streaming_service  # noqa: E402
from repro_torch.kernels import ei_score, gp_readout  # noqa: E402
from repro_torch.shardgp import ShardedScorer  # noqa: E402

OBS = {"ref": JO, "port": TO}
#: forensics values of the port's run against the reference's.  The
#: posterior (mu, sd) at test_torch_core's float32 tolerance, |got - want|
#: <= 1e-5 (1 + |want|).  EIrate and EI are functions of it, held by
#: ``_ei_allowance``: 1e-4 relative (ROADMAP §3: each package's float32
#: EIrate errs by about 1e-4 against float64) times the EI's conditioning
#: in z, plus what the record's own posterior difference gives it to first
#: order -- in the tail tau(z) ~ phi(z) / z^2, so a difference in z grows
#: by |z| in ln EI.  The margin to the sum of its two scores' allowed
#: differences; costs exactly.
POSTERIOR_TOL = 1e-5
SCORE_RTOL = 1e-4


def _tau(z: float) -> float:
    return (z * 0.5 * math.erfc(-z / math.sqrt(2.0))
            + math.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi))


def _ei_allowance(got: dict, want: dict) -> float:
    """The relative EI difference allowed between two records of one
    candidate, with one member tenant (EI = sd tau(z), z = (mu - best) /
    sd): SCORE_RTOL c, c = max(1, d ln tau / dz) = max(1, Phi(z) / tau(z)),
    plus the first-order effect of the records' posterior difference,
    |d sd| / sd + c |dz|, dz = (|d mu| + |z| |d sd|) / sd; z found by
    bisection from tau(z) = ei / sd."""
    ei, sd = want["ei"], want["sd"]
    if not ei or not sd or ei / sd <= 0.0:
        return SCORE_RTOL
    lo, hi = -40.0, 40.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if _tau(mid) < ei / sd else (lo, mid)
    z = 0.5 * (lo + hi)
    d_mu, d_sd = abs(got["mu"] - want["mu"]), abs(got["sd"] - want["sd"])
    dz = (d_mu + abs(z) * d_sd) / sd
    c = max(1.0, 0.5 * math.erfc(-z / math.sqrt(2.0)) / _tau(z))
    return SCORE_RTOL * c + d_sd / sd + c * dz


ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def cpu_path_never_launches():
    """Every plane here lives on the CPU: no kernel launch is counted."""
    before = (ei_score.launches, ei_score.topk_launches,
              ei_score.classes_launches, gp_readout.launches)
    yield
    assert (ei_score.launches, ei_score.topk_launches,
            ei_score.classes_launches, gp_readout.launches) == before


def _trials(res):
    return [dataclasses.astuple(t) for t in res.trials]


def _alerts(hm):
    return [a.to_record() for a in hm.alerts]


def _export_keys(records, alerts=True):
    """An export record's sim-time fields (its metrics carry wall-clock
    histograms); its alert counts with ``alerts`` (a resumed run's monitor
    counts only the alerts it re-emits)."""
    return [(r["window"], r["t"], r["event_index"], bool(r.get("final")))
            + ((r.get("alerts"),) if alerts else ()) for r in records]


def _reference_example(name):
    """The reference's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"ref_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_forensics_close(got: list[dict], want: list[dict]) -> None:
    """Equal keys, winners, candidate ids, costs and counterfactuals; the
    posterior within POSTERIOR_TOL, the scores and the margin within
    ``_ei_allowance``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        g.pop("scorer", None), w.pop("scorer", None)
        if g.get("record") == "incident":
            assert g == w
            continue
        assert [c["model"] for c in g["topk"]] == \
            [c["model"] for c in w["topk"]]
        assert g["uniform_cost"] == w["uniform_cost"]
        for key in ("t", "event_index", "seq", "speed", "device_class"):
            assert g[key] == w[key]
        for cg, cw in zip(g["topk"], w["topk"]):
            assert cg["cost"] == cw["cost"]
            for f in ("mu", "sd"):
                assert abs(cg[f] - cw[f]) <= POSTERIOR_TOL * (1 + abs(cw[f])), \
                    (f, cg, cw)
            allowed = _ei_allowance(cg, cw)
            for f in ("eirate", "ei"):
                err = abs(cg[f] - cw[f]) / abs(cw[f]) if cw[f] else 0.0
                assert err <= allowed, (f, allowed, cg, cw)
        if w["margin"] is None:
            assert g["margin"] is None
        else:
            # the winner's and the runner-up's allowed differences
            assert abs(g["margin"] - w["margin"]) <= sum(
                _ei_allowance(g[r], w[r]) * abs(w[r]["eirate"])
                for r in ("winner", "runner_up"))


# --- metrics and export ------------------------------------------------------------

def _registry(O):
    reg = O.MetricsRegistry()
    reg.counter("engine.events").inc(3)
    reg.counter("launches", {"cls": "fast"}).inc()
    reg.counter("launches", {"cls": "slow", "a": "1"}).inc(2)
    reg.gauge("depth").set(2.0)
    reg.gauge("depth").set(1.0)
    reg.gauge("capacity.shard_slots", {"shard": "0"}).set(7)
    reg.gauge("unset")
    h = reg.histogram("lat")
    for v in (1e-6, 3e-4, 0.5, 0.5, 7.0, 1e3, float("nan"), float("inf")):
        h.observe(v)
    reg.histogram("empty")
    reg.histogram("custom", bounds=(1.0, 2.0, 4.0)).observe(3.0)
    with pytest.raises(ValueError, match="different kind"):
        reg.gauge("engine.events")
    with pytest.raises(ValueError, match="ascending"):
        O.Histogram((2.0, 1.0))
    return reg


def test_registry_snapshot_and_prometheus_text_equal():
    got, want = _registry(TO), _registry(JO)
    snap = got.snapshot()
    assert snap == want.snapshot()
    assert json.dumps(snap, allow_nan=False) == \
        json.dumps(want.snapshot(), allow_nan=False)
    assert snap["histograms"]["lat"]["saturated"]
    assert snap["histograms"]["lat"]["dropped_non_finite"] == 2
    text = TO.prometheus_text(snap)
    assert text == JO.prometheus_text(want.snapshot())
    assert 'launches_total{a="1",cls="slow"} 2' in text
    assert 'empty{quantile="0.5"} NaN' in text
    assert [(lab, c.value) for lab, c in got.series("launches")] == \
        [(lab, c.value) for lab, c in want.series("launches")]


def _export(O, path):
    reg = O.MetricsRegistry()
    c = reg.counter("events")
    exp = O.MetricsExporter(reg, path=str(path), window=5.0)
    for i, t in enumerate((0.0, 1.0, 4.9, 5.0, 7.0, 12.5, 30.0)):
        c.inc()
        exp.tick(t, i)
    state = json.loads(json.dumps(exp.state_dict()))    # snapshot-safe
    resumed = O.MetricsExporter(reg, window=5.0)
    resumed.load_state(state)
    resumed.tick(31.0, 7)            # window 6: already emitted
    resumed.tick(35.0, 8)
    exp.final(35.0, 8)
    exp.close()
    with pytest.raises(ValueError, match="positive"):
        O.MetricsExporter(reg, window=0.0)
    return path.read_text(), exp.records, resumed.records, exp.prometheus()


def test_exporter_windows_and_cursor_round_trip_equal(tmp_path):
    got = _export(TO, tmp_path / "port.jsonl")
    want = _export(JO, tmp_path / "ref.jsonl")
    assert got == want
    text, records, resumed, _ = got
    assert [r["window"] for r in records] == [0, 1, 2, 6, 7]
    assert records[-1]["final"] and [r["window"] for r in resumed] == [7]
    assert [json.loads(line) for line in text.splitlines()] == records


# --- health ------------------------------------------------------------------------

def _queue_runaway(O):
    hm = O.HealthMonitor(queue_limit=4)
    for depth in (1, 2, 3, 4, 6, 2, 5):
        hm.on_event(float(depth), depth, queue_depth=depth, backlog=0)
    return hm


def _regret_stall(O):
    hm = O.HealthMonitor(stall_k=3)
    hm.on_observation(0.0, 0, 7, True)
    for i in range(1, 5):
        hm.on_observation(float(i), i, 7, False)
    hm.on_observation(5.0, 5, 7, True)
    for i in range(6, 9):
        hm.on_observation(float(i), i, 7, False)
    hm.on_observation(9.0, 9, 8, False)
    return hm


def _gp_conditioning(O):
    hm = O.HealthMonitor(window=10.0, conditioning_scale=10.0)
    for t, ev, d2 in ((1.0, 0, 5e-6), (2.0, 1, 5e-6), (12.0, 2, 5e-6),
                      (13.0, 3, 1e-3)):
        hm.on_observation(t, ev, "t", True, d2=d2, jitter=1e-6, model=3)
    hm.on_observation(14.0, 4, "t", True)
    return hm


def _class_starvation(O):
    hm = O.HealthMonitor(starvation_window=10.0)
    for t in range(0, 30, 5):
        hm.on_event(float(t), t, queue_depth=0, backlog=0,
                    free_classes=("base",))
    hm.on_event(30.0, 30, queue_depth=0, backlog=2, free_classes=("base",))
    hm.on_event(35.0, 31, queue_depth=0, backlog=2, free_classes=("base",))
    hm.on_launch(36.0, 32, 0, 1, "base")
    hm.on_event(40.0, 33, queue_depth=0, backlog=2, free_classes=("base",))
    hm.on_event(47.0, 34, queue_depth=0, backlog=2, free_classes=("base",))
    return hm


def _slo_burn(O):
    vals = iter([0.1, 0.1, 0.9, 0.1, 0.1])
    hm = O.HealthMonitor(slo={"device_utilization": 0.5}, window=10.0,
                         burn_windows=2, burn_threshold=0.75)
    for i in range(1, 7):
        hm.on_event(10.0 * i if i < 6 else 51.0, i, queue_depth=0,
                    backlog=0,
                    summary_fn=lambda: {"device_utilization": next(vals)})
    return hm


def _slo_ceiling(O):
    hm = O.HealthMonitor(slo={"ttfo_p99": 100.0, "regret": None},
                         window=10.0, burn_windows=1, burn_threshold=0.5)
    hm.on_event(10.0, 1, queue_depth=0, backlog=0,
                summary_fn=lambda: {"ttfo_p99": 250.0})
    hm.on_event(20.0, 2, queue_depth=0, backlog=0,
                summary_fn=lambda: {"ttfo_p99": 50.0})
    return hm


def _straggler(O):
    hm = O.HealthMonitor(window=20.0)
    for t, dev in ((1.0, 0), (2.0, 0), (3.0, 1), (25.0, 0)):
        hm.on_timeout(t, int(t), dev, "t9", overrun=t / 2)
    return hm


def _retry_storm(O):
    hm = O.HealthMonitor(window=10.0, retry_storm_k=4)
    for t in (0.0, 1.0, 2.0, 3.0, 4.0, 20.0, 21.0, 22.0, 23.0):
        hm.on_retry(t, int(t), "t1", 5, attempt=1)
    return hm


def _quarantine_flap(O):
    hm = O.HealthMonitor(window=20.0, flap_window=100.0)
    for t, dev in ((0.0, 0), (10.0, 0), (12.0, 0), (50.0, 0), (60.0, 1)):
        hm.on_quarantine(t, int(t), dev, count=int(t) // 10 + 1)
    return hm


def _poisoned(O):
    hm = O.HealthMonitor()
    hm.on_poisoned(1.0, 1, "t3", 4)
    hm.on_poisoned(1.0, 2, "t3", 5)
    return hm


def _state_round_trip(O):
    def drive(hm, start):
        for i in range(start, start + 6):
            hm.on_observation(float(i), i, "t0", False)
            hm.on_event(float(i), i, queue_depth=i, backlog=0)
            hm.on_retry(float(i), i, "t0", i, attempt=1)
            hm.on_quarantine(float(i), i, i % 2)

    cfg = dict(stall_k=9, queue_limit=8, retry_storm_k=4, window=5.0)
    prefix = O.HealthMonitor(**cfg)
    drive(prefix, 0)
    state = json.loads(json.dumps(prefix.state_dict()))
    full = O.HealthMonitor(**cfg)
    drive(full, 0)
    drive(full, 6)
    resumed = O.HealthMonitor(**cfg)
    resumed.load_state(state)
    assert resumed.alerts == [] and resumed.drain_new() == []
    drive(resumed, 6)
    assert full.alerts[len(prefix.alerts):] == resumed.alerts
    return resumed


WATCHDOGS = {
    "queue_runaway": (_queue_runaway, ["queue_runaway"] * 2),
    "regret_stall": (_regret_stall, ["regret_stall"] * 2),
    "gp_conditioning": (_gp_conditioning, ["gp_conditioning"] * 2),
    "class_starvation": (_class_starvation, ["class_starvation"] * 2),
    "slo_burn": (_slo_burn, ["slo_burn"] * 2),
    "slo_ceiling": (_slo_ceiling, ["slo_burn"]),
    "straggler": (_straggler, ["straggler"] * 3),
    "retry_storm": (_retry_storm, ["retry_storm"] * 2),
    "quarantine_flap": (_quarantine_flap, ["quarantine_flap"] * 2),
    "poisoned_observation": (_poisoned, ["poisoned_observation"] * 2),
    # the retry storm fired in the prefix: its restored state keeps it
    # disarmed in the suffix
    "state_round_trip": (_state_round_trip,
                         ["regret_stall", "queue_runaway"]
                         + ["quarantine_flap"] * 3),
}


@pytest.mark.parametrize("name", sorted(WATCHDOGS))
def test_watchdog_fires_and_rearms_as_the_reference(name):
    scenario, kinds = WATCHDOGS[name]
    got, want = scenario(TO), scenario(JO)
    assert sorted(a.kind for a in got.alerts) == sorted(kinds)
    assert _alerts(got) == _alerts(want)
    assert got.state_dict() == want.state_dict()
    # drained once, each record round-trips through JSON and Alert
    drained = got.drain_new()
    assert drained == got.alerts and got.drain_new() == []
    for a in drained:
        rec = json.loads(json.dumps(a.to_record(), allow_nan=False))
        assert TO.Alert.from_record(rec) == a and a.kind in TO.ALERT_KINDS
    assert TO.ALERT_KINDS == JO.ALERT_KINDS


# --- forensics ---------------------------------------------------------------------

def _forensics(O, path):
    fr = O.ForensicsRecorder(path=str(path))
    fr.begin_event(3.0, 17)
    # model 11 wins on EIrate but model 4 has the larger EI: the uniform-cost
    # counterfactual flips the pick
    flip = fr.on_decision(scorer="ops", values=[0.5, 0.1], gids=[11, 4],
                          eff_costs=[1.0, 10.0], mu=[0.2, 0.4],
                          sd=[0.1, 0.3])
    lone = fr.on_decision(scorer="ops", values=[0.5], gids=[11],
                          eff_costs=[1.0])
    fr.begin_event(4.0, 18)
    # -1e30 is a masked slot: the tail after it is padding
    padded = fr.on_decision(scorer="sharded", values=[1.0, -1e30, 0.5],
                            gids=[1, 2, 3], eff_costs=[1.0, 1.0, 1.0])
    inf = fr.on_decision(scorer="sharded", values=[2.0, float("-inf")],
                         gids=[7, 0], eff_costs=[2.0, 1.0],
                         device_class="fast", speed=2.0)
    inc = fr.on_incident(kind="trial_timeout", tenant=3, overrun=float("inf"))
    fr.close()
    return path.read_text(), [flip, lone, padded, inf, inc]


def test_forensics_records_equal_flip_and_padded_tail(tmp_path):
    got = _forensics(TO, tmp_path / "port.jsonl")
    assert got == _forensics(JO, tmp_path / "ref.jsonl")
    flip, lone, padded, inf, inc = got[1]
    assert flip["uniform_cost"] == {"model": 4, "changes_pick": True}
    assert flip["margin"] == pytest.approx(0.4)
    assert (lone["seq"], lone["runner_up"], lone["margin"]) == (1, None, None)
    assert [c["model"] for c in padded["topk"]] == [1] and padded["seq"] == 0
    assert [c["model"] for c in inf["topk"]] == [7]
    assert inc["record"] == "incident" and inc["detail"]["overrun"] is None


def _one_tenant_planes(CP, tie: bool):
    cp = CP(np.random.default_rng(0), **({"device": "cpu"} if CP is TCP
                                         else {}))
    m = 6
    K = 0.04 * np.eye(m)
    mu0 = np.zeros(m) if tie else np.linspace(0.0, 0.1, m)
    cost = np.ones(m) if tie else np.linspace(1.0, 2.0, m)
    cp.add_tenant(K, mu0, cost)
    cp.add_tenant(K, mu0, cost)
    return cp


@pytest.mark.parametrize("tie", [True, False])
def test_forensics_topk_head_is_the_decision_on_the_ops_path(tie):
    """The port takes the top-4 from the scores its decision computed (a
    stable sort): its head is the decision's first argmax, at exact ties
    too, and the candidates are the reference's extra top-k program's."""
    recs = {}
    for name, CP, O in (("port", TCP, TO), ("ref", JCP, JO)):
        cp = _one_tenant_planes(CP, tie)
        fr = O.ForensicsRecorder()
        cp.set_forensics(fr)
        picks = []
        for ev in range(5):
            fr.begin_event(float(ev), ev)
            pick = cp.choose_mdmt(device_speed=1.0 if ev % 2 else 2.0)
            picks.append(pick)
            cp.record_start(pick[0])
        assert [r["winner"]["model"] for r in fr.records] == \
            [p[0] for p in picks]
        recs[name] = fr.records
    assert_forensics_close(recs["port"], recs["ref"])
    if tie:        # identical tenants: the lowest global id wins
        assert recs["port"][0]["winner"]["model"] == 0
        assert recs["port"][0]["margin"] == 0.0


def test_batched_decision_records_one_forensics_row_per_class():
    recs = {}
    for name, CP, O in (("port", TCP, TO), ("ref", JCP, JO)):
        cp = _one_tenant_planes(CP, False)
        fr = O.ForensicsRecorder()
        cp.set_forensics(fr)
        fr.begin_event(1.0, 5)
        v, g = cp.choose_mdmt_batch([4.0, 1.0], [0.25, 0.0], k=2,
                                    class_names=["fast", "slow"])
        assert [(r["seq"], r["device_class"]) for r in fr.records] == \
            [(0, "fast"), (1, "slow")]
        assert fr.records[0]["winner"]["cost"] == pytest.approx(1 / 4 + 0.25)
        assert fr.records[0]["winner"]["eirate"] == float(v[0][0])
        assert fr.records[1]["winner"]["model"] == int(g[1][0])
        recs[name] = fr.records
    assert_forensics_close(recs["port"], recs["ref"])


# --- report ------------------------------------------------------------------------

def test_write_report_byte_equal_on_fixed_payloads(tmp_path):
    """Both packages render the same payloads (the port's run of the
    adversarial trace, its spans included) into the same files."""
    eng, res, _ = health_demo.run("cpu")
    meta = {"policy": "mdmt", "slices": 4, "slo": health_demo.SLO,
            "note": 'quote " & <tag>', "ratio": 1 / 3}
    dirs = {}
    for name, O in OBS.items():
        dirs[name] = O.write_report(
            tmp_path / name, "run", telemetry=res.telemetry,
            tracer=eng.tracer, metrics=eng.metrics, result=res,
            alerts=eng.health.alerts, forensics=eng.forensics.records,
            accounting=eng.accounting, meta=meta)
    files = sorted(p.name for p in dirs["port"].iterdir())
    assert files == ["alerts.jsonl", "forensics.jsonl", "report.html",
                     "summary.json", "timeline.csv", "trace.json"]
    assert files == sorted(p.name for p in dirs["ref"].iterdir())
    for f in files:
        port = (dirs["port"] / f).read_bytes()
        if f == "summary.json":
            # the port's span rows add the thread's CPU time, cpu_us; without
            # it the file is the reference's, byte for byte
            payload = json.loads(port)
            for row in payload["spans"].values():
                assert row.pop("cpu_us") >= 0.0
            port = json.dumps(payload, indent=2, sort_keys=True,
                              allow_nan=False).encode()
        assert port == (dirs["ref"] / f).read_bytes(), f
    records = eng.tracer.records()
    agg = TO.aggregate_spans(records)
    cpu = {path: row.pop("cpu_us") for path, row in agg.items()}
    assert agg == JO.aggregate_spans(records)
    roots = [r for r in records if r["parent"] is None]
    for name in {r["name"] for r in roots}:
        assert cpu[name] == pytest.approx(
            sum(r["cpu_us"] for r in roots if r["name"] == name))
    minimal = [O.write_report(tmp_path / f"min_{n}", "bare")
               for n, O in OBS.items()]
    assert sorted(p.name for p in minimal[0].iterdir()) == \
        ["report.html", "summary.json", "timeline.csv"]
    for f in ("report.html", "summary.json", "timeline.csv"):
        assert (minimal[0] / f).read_bytes() == (minimal[1] / f).read_bytes()


# --- the planes in the engines -----------------------------------------------------

def test_streaming_example_planes_equal_the_reference(tmp_path, capsys):
    """The example's default trace with every plane on, against the
    reference's engine in the reference example's settings: equal trials,
    telemetry, alerts, capacity samples, export windows and forensics
    winners; the port's example also checks its bare twin."""
    eng, res = streaming_service.main(
        ["--device", "cpu", "--trace", "--health", "--forensics",
         "--capacity", "--telemetry-json", str(tmp_path / "tel.json")])
    ref = _reference_example("streaming_service")
    assert ref.__doc__ and streaming_service.SLO == \
        {"device_utilization": 0.25, "ttfo_p99": 100.0}
    trace = JS.poisson_churn_trace(num_sessions=200, arrival_rate=1.0,
                                   seed=0, m_min=2, m_max=16,
                                   session_scale=25.0, num_failure_slices=2)
    reg = JO.MetricsRegistry()
    jeng = JS.StreamEngine(
        JFleet.partition_pod(total_chips=256, num_slices=8), "mdmt", seed=0,
        max_live_models=120, tracer=JO.Tracer(enabled=True), metrics=reg,
        exporter=JO.MetricsExporter(reg, window=20.0),
        health=JO.HealthMonitor(slo=streaming_service.SLO, window=20.0),
        forensics=JO.ForensicsRecorder(),
        accounting=JO.CapacityAccountant(reg, window=20.0))
    jres = jeng.run(trace)
    assert _trials(res) == _trials(jres)
    assert res.telemetry.summary() == jres.telemetry.summary()
    assert _alerts(eng.health) == _alerts(jeng.health)
    assert eng.log.alerts == _alerts(eng.health) and eng.health.alerts
    assert eng.accounting.samples == jeng.accounting.samples
    assert _export_keys(eng.exporter.records) == \
        _export_keys(jeng.exporter.records)
    assert_forensics_close(eng.forensics.records, jeng.forensics.records)
    # the span trees, the reference's scorer attribute named as the port's
    assert eng.tracer.signature() == [
        row[:4] + (tuple((k, "ops" if (k, v) == ("scorer", "fused") else v)
                         for k, v in row[4]),)
        for row in jeng.tracer.signature()]
    counters = eng.metrics.snapshot()["counters"]
    assert counters == jeng.metrics.snapshot()["counters"]
    assert counters["engine.launches"] == len(res.trials)
    payload = json.loads((tmp_path / "tel.json").read_text())
    assert payload["alerts"] == _alerts(eng.health)
    assert payload["metrics"]["counters"] == counters
    assert "bare twin identical=True" in capsys.readouterr().out


def test_health_demo_alerts_equal_the_reference():
    ref = _reference_example("health_demo")
    trace = health_demo.adversarial_trace()
    assert [json.dumps(TS.eventlog.serialize_event(e)) for e in trace.events] \
        == [json.dumps(JS.eventlog.serialize_event(e))
            for e in ref.adversarial_trace().events]
    eng, res, twin = health_demo.run("cpu")
    reg = JO.MetricsRegistry()
    jeng = JDev(
        JFleet.partition_pod(total_chips=128, num_slices=4), "mdmt", seed=0,
        max_live_models=20, timeout_factor=1.5, max_retries=3,
        retry_backoff=1.0,
        quarantine=JQuarantine(threshold=3, window=100.0, duration=10.0,
                               probation_trials=2),
        tracer=JO.Tracer(enabled=True), metrics=reg,
        health=JO.HealthMonitor(
            slo=ref.SLO, window=10.0, burn_windows=2, burn_threshold=0.75,
            stall_k=8, queue_limit=6, starvation_window=10.0,
            memory_budget_bytes=1024),
        forensics=JO.ForensicsRecorder(),
        exporter=JO.MetricsExporter(reg, window=10.0),
        accounting=JO.CapacityAccountant(reg, window=10.0))
    jres = jeng.run(ref.adversarial_trace())
    assert _trials(res) == _trials(jres) == _trials(twin)
    assert {a.kind for a in eng.health.alerts} == set(TO.ALERT_KINDS)
    assert _alerts(eng.health) == _alerts(jeng.health)
    assert eng.accounting.samples == jeng.accounting.samples
    assert _export_keys(eng.exporter.records) == \
        _export_keys(jeng.exporter.records)
    assert_forensics_close(eng.forensics.records, jeng.forensics.records)
    assert eng.exporter.prometheus().split("# TYPE health_alerts_total")[1] \
        == jeng.exporter.prometheus().split("# TYPE health_alerts_total")[1]


def _device_churn_trace(S):
    return S.device_churn_trace(
        num_sessions=10, arrival_rate=1.5, seed=2, initial_slices=4,
        join_classes=(("fast", 16, 2.0), ("slow", 16, 1.0)),
        join_rate=0.05, leave_rate=0.02, preempt_rate=0.03,
        m_min=2, m_max=6, session_scale=10.0)


def _churn_trace(S):
    return S.poisson_churn_trace(num_sessions=10, arrival_rate=1.2, seed=6,
                                 m_min=2, m_max=8, session_scale=12.0,
                                 num_failure_slices=1)


def _planes(O, **health):
    reg = O.MetricsRegistry()
    return dict(
        tracer=O.Tracer(enabled=True), metrics=reg,
        exporter=O.MetricsExporter(reg, window=5.0),
        health=O.HealthMonitor(**{**dict(slo={"device_utilization": 1.5},
                                         window=5.0, burn_windows=2,
                                         stall_k=4, queue_limit=2,
                                         memory_budget_bytes=4096.0),
                                  **health}),
        forensics=O.ForensicsRecorder(),
        accounting=O.CapacityAccountant(reg, window=5.0))


def _stream_engine(pkg, scorer="ops", **kw):
    if pkg == "port":
        return TS.StreamEngine(TFleet.partition_pod(16 * 3, 3), "mdmt",
                               seed=0, max_live_models=30, num_shards=2,
                               scorer=scorer, device="cpu", **kw)
    return JS.StreamEngine(JFleet.partition_pod(16 * 3, 3), "mdmt", seed=0,
                           max_live_models=30, num_shards=2, **kw)


def _devplane_engine(pkg, scorer="ops", **kw):
    reg = (t_registry if pkg == "port" else j_registry)(
        2.0, overhead=0.5, chips=16)
    fleet = reg.build_fleet([("slow", 2), ("fast", 2)])
    if pkg == "port":
        return TDev(fleet, "mdmt", seed=0, registry=reg, assign="batched",
                    launch_order="fastest", max_live_models=30, num_shards=2,
                    scorer=scorer, device="cpu", **kw)
    return JDev(fleet, "mdmt", seed=0, registry=reg, assign="batched",
                launch_order="fastest", max_live_models=30, num_shards=2,
                **kw)


ENGINES = {
    "stream_ops": (_stream_engine, "ops", _churn_trace),
    "stream_sharded": (_stream_engine, "sharded", _churn_trace),
    "devplane_ops": (_devplane_engine, "ops", _device_churn_trace),
    "devplane_sharded": (_devplane_engine, "sharded", _device_churn_trace),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_every_plane_on_equals_the_bare_twin_and_the_reference(name):
    make, scorer, trace_fn = ENGINES[name]
    planes = _planes(TO)
    eng = make("port", scorer, **planes)
    res = eng.run(trace_fn(TS))
    bare = make("port", scorer).run(trace_fn(TS))
    assert _trials(res) == _trials(bare)
    assert res.telemetry.summary() == bare.telemetry.summary()
    assert eng.exporter.health is eng.health and eng.exporter.records[-1][
        "final"]
    assert eng.log.alerts == _alerts(eng.health) and eng.health.alerts
    fam = eng.metrics.series("engine.launches_by_class")
    assert sum(c.value for _, c in fam) == len(res.trials)
    recs = eng.forensics.records
    assert recs and all(r["scorer"] == scorer for r in recs
                        if r.get("record") != "incident")
    if name.startswith("devplane"):
        assert {"slow", "fast"} <= {r["device_class"] for r in recs}
        assert all({"autoscale_joins", "scoring_passes"}
                   <= set(s) for s in eng.accounting.samples)
        assert eng.metrics.snapshot()["counters"]["engine.scoring_passes"] \
            == eng._scoring_passes

    # the reference's run ("fused", the same shard spans): the same alerts,
    # samples and export schedule; forensics winners and values
    jplanes = _planes(JO)
    jeng = make("ref", **jplanes)
    jres = jeng.run(trace_fn(JS))
    assert _trials(res) == _trials(jres)
    assert _alerts(eng.health) == _alerts(jeng.health)
    assert eng.accounting.samples == jeng.accounting.samples
    assert _export_keys(eng.exporter.records) == \
        _export_keys(jeng.exporter.records)
    assert_forensics_close(recs, jeng.forensics.records)


@pytest.mark.parametrize("crash_at", [2, "mid_alert", "last"])
def test_crash_replays_spans_alerts_forensics_and_export(tmp_path, crash_at):
    """The replay contract on the port: durable alert prefix + re-emitted
    suffix == the uninterrupted run's alerts; the resumed run's forensics
    records, export schedule and span tree equal the uninterrupted run's
    suffix."""
    trace = _churn_trace(TS)
    ref_planes = _planes(TO)
    ref_eng = _stream_engine("port", **ref_planes)
    ref_res = ref_eng.run(trace)
    ref_alerts = _alerts(ref_eng.health)
    assert len(ref_alerts) >= 2
    n = ref_eng.event_index
    crash_at = {"mid_alert": ref_alerts[len(ref_alerts) // 2]["event_index"]
                + 1, "last": n - 1}.get(crash_at, crash_at)

    bag = []

    def make(**kw):
        planes = _planes(TO)
        bag.append(planes)
        return _stream_engine("port", **planes, **kw)

    eng = make(log=TS.EventLog(tmp_path / "log"),
               snapshot_root=str(tmp_path / "snap"), snapshot_every=5,
               fault=TS.FaultInjector(crash_at, "before"))
    with pytest.raises(TS.SimulatedCrash):
        eng.run(trace)
    eng.log.close()
    durable = TS.EventLog.load(tmp_path / "log")
    eng2, resumed_from = TS.recover(make, str(tmp_path / "snap"), durable)
    res2 = eng2.resume()
    assert _trials(res2) == _trials(ref_res)
    assert res2.telemetry.summary() == ref_res.telemetry.summary()
    suffix = [a.to_record() for a in bag[-1]["health"].alerts]
    assert [a for a in durable.alerts if a["event_index"] <= resumed_from] \
        + suffix == ref_alerts
    assert eng2.log.alerts == suffix
    assert bag[-1]["forensics"].records == \
        [r for r in ref_planes["forensics"].records
         if r["event_index"] > resumed_from]
    assert _export_keys(bag[-1]["exporter"].records, alerts=False) == \
        [k for k in _export_keys(ref_planes["exporter"].records, alerts=False)
         if k[2] > resumed_from]
    assert bag[-1]["accounting"].samples == \
        [s for s in ref_planes["accounting"].samples
         if s["event_index"] > resumed_from]
    sig = ref_planes["tracer"].signature(min_trace=resumed_from + 1)
    assert sig and bag[-1]["tracer"].signature(min_trace=resumed_from + 1) \
        == sig


# --- the phased sharded decision ---------------------------------------------------

def test_phased_pick_equals_fused_pick_with_four_shards():
    rng = np.random.default_rng(3)
    k_obs, n, N = 24, 64, 8
    W = torch.from_numpy((rng.standard_normal((k_obs, n)) * 0.1)
                         .astype(np.float32))
    alpha = torch.from_numpy(rng.standard_normal(k_obs).astype(np.float32))
    mu0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    kd = (W * W).sum(0) + torch.rand(n, generator=torch.Generator()
                                     .manual_seed(0))
    member = np.zeros((N, n), bool)
    member[np.arange(n) * N // n, np.arange(n)] = True
    cost = rng.uniform(0.3, 3.0, n).astype(np.float32)
    best = rng.normal(0.5, 0.5, N).astype(np.float32)
    sel = rng.random(n) < 0.25
    for kernel in ("eirate_topk", "eirate"):
        sc = ShardedScorer(4, topk=4, kernel=kernel, device="cpu")
        sc.refresh(member, cost)
        tr = TO.Tracer(enabled=True)
        sc.tracer = tr
        v, g = sc.readout_decide_topk(W, alpha, mu0, kd, best, sel, 1.5)
        pv, pg = sc.readout_decide_topk_phased(W, alpha, mu0, kd, best, sel,
                                               1.5)
        assert torch.equal(v, pv) and torch.equal(g, pg)
        assert [r["name"] for r in tr.records()] == \
            ["readout", "score_topk", "gather_pick"]
        times = sc.phase_times(W, alpha, mu0, kd, best, sel, 1.5, iters=2,
                               warmup=1)
        assert set(times) == {"readout_us", "score_us", "gather_us"}
        assert all(t > 0 for t in times.values())
    # the pick is the unsharded readout -> EIrate -> first argmax
    from repro_torch.kernels import ops
    mu, sd = ops.gp_readout(W, alpha, mu0, kd, emit_sd=True)
    scores = ops.eirate(mu, sd, torch.from_numpy(best), torch.from_numpy(
        member), torch.from_numpy(cost) / torch.full((n,), 1.5),
        torch.from_numpy(sel))
    assert int(pg[0]) == int(torch.argmax(scores))
