"""The port's capacity plane and profile probes, on the CPU.

The accountant (``repro_torch.obs.accounting``) is the reference's pure
Python, fed by the port's ``ControlPlane.capacity_stats`` and the engines'
``_capacity_extra``: driven by the same inputs it must give the reference's
samples, gauges, projection and memory alerts; in an engine run it must
see the run the reference's sees, replay its sample suffix after a crash,
and change no decision.  ``repro_torch.obs.profile`` is new code on
PyTorch: on the CPU its capture window is a no-op and its timers only
count (no wall-clock ratio is asserted here).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.obs as JO  # noqa: E402
import repro.stream as JS  # noqa: E402
from repro.core.control_plane import ControlPlane as JCP  # noqa: E402
from repro.core.fleet import Fleet as JFleet  # noqa: E402
from repro.devplane import DevPlaneEngine as JDev  # noqa: E402
from repro.devplane import two_class_registry as j_registry  # noqa: E402
import repro_torch.obs as TO  # noqa: E402
import repro_torch.stream as TS  # noqa: E402
from repro_torch.core.control_plane import ControlPlane as TCP  # noqa: E402
from repro_torch.core.fleet import Fleet as TFleet  # noqa: E402
from repro_torch.devplane import DevPlaneEngine as TDev  # noqa: E402
from repro_torch.devplane import two_class_registry as t_registry  # noqa: E402
from repro_torch.obs import profile  # noqa: E402
from repro_torch.shardgp import ShardedScorer  # noqa: E402

OBS = {"ref": JO, "port": TO}


def _trials(res):
    return [dataclasses.astuple(t) for t in res.trials]


class _Shim:
    """An engine as the accountant sees it, with a settable byte count."""

    def __init__(self):
        self.bytes = 100.0
        self.fleet = type("F", (), {"slices": []})()
        self.health = None
        self.cp = self

    def capacity_stats(self):
        return {"gp": {"num_blocks": 1, "capacity": 8, "obs_total": 0,
                       "alloc_bytes": self.bytes, "active_bytes": 0,
                       "readout_bytes": 0, "tenants": {3: {
                           "alloc_bytes": 64, "obs": 2}}},
                "layout": {"slots_total": 8, "slots_live": 5,
                           "slots_free": 3, "per_shard": [3, 2],
                           "imbalance": 1.2}}

    def _capacity_extra(self):
        return {"scoring_passes": 5}


def _accountant(O):
    shim = _Shim()
    reg = O.MetricsRegistry()
    acc = O.CapacityAccountant(reg, window=10.0, horizon=60.0)
    out = [acc.sample(0.0, 0, shim)]
    shim.bytes = 200.0
    acc.tick(10.0, 1, shim)
    acc.tick(12.0, 2, shim)                  # same window: no sample
    resumed = O.CapacityAccountant(O.MetricsRegistry(), window=10.0,
                                   horizon=60.0)
    resumed.load_state(json.loads(json.dumps(acc.state_dict())))
    resumed.tick(15.0, 3, shim)              # window 1 already sampled
    shim.bytes = 300.0
    resumed.tick(20.0, 4, shim)
    with pytest.raises(ValueError, match="history"):
        O.CapacityAccountant(reg, history=1)
    return out, acc.samples, resumed.samples, reg.snapshot()


def test_accountant_projection_is_the_reference_least_squares_slope():
    got, want = _accountant(TO), _accountant(JO)
    assert got == want
    first, samples, resumed, snap = got
    assert first[0]["gp_bytes_slope"] == 0.0
    assert samples[-1]["gp_bytes_slope"] == pytest.approx(10.0)
    assert samples[-1]["gp_bytes_projected"] == 800     # 200 + 10 * 60
    assert len(samples) == 2 and len(resumed) == 1
    assert resumed[0]["gp_bytes_slope"] == pytest.approx(10.0)
    gauges = snap["gauges"]
    assert gauges["capacity.gp_bytes_projected"]["value"] == 800
    assert gauges["capacity.scoring_passes"]["value"] == 5
    assert gauges['capacity.shard_slots{shard="1"}']["value"] == 2
    assert gauges['capacity.tenant_bytes{tenant="3"}']["value"] == 64


def _memory_runaway(O):
    h = O.HealthMonitor(memory_budget_bytes=1000.0)
    for t, now, projected in ((0.0, 500.0, 1200.0), (1.0, 600.0, 1300.0),
                              (2.0, 600.0, 700.0), (3.0, 1500.0, 1500.0)):
        h.on_capacity(t, int(t) + 1, bytes_now=now, projected_bytes=projected)
    bare = O.HealthMonitor()
    bare.on_capacity(0.0, 1, bytes_now=1e9, projected_bytes=1e9)
    assert bare.alerts == []
    return [a.to_record() for a in h.alerts], h.state_dict()


def test_memory_runaway_arms_and_rearms_as_the_reference():
    got = _memory_runaway(TO)
    assert got == _memory_runaway(JO)
    assert [(a["kind"], a["severity"]) for a in got[0]] == \
        [("memory_runaway", "warn"), ("memory_runaway", "page")]


def _lifecycle(CP, kw):
    """capacity_stats through add_tenant / record_observation /
    retire_tenant / compact."""
    rng = np.random.default_rng(4)
    cp = CP(np.random.default_rng(0), model_capacity=64, tenant_capacity=8,
            num_shards=2, **kw)
    out = []
    for tid, (m, obs) in enumerate(((3, 2), (5, 0), (4, 3))):
        A = rng.standard_normal((m, m))
        h = cp.add_tenant(0.04 * (A @ A.T / m + 0.25 * np.eye(m)),
                          np.zeros(m), np.ones(m))
        for j in range(obs):
            g = int(h.models[j])
            cp.record_start(g)
            cp.record_observation(g, float(rng.uniform(0.2, 0.8)))
    out.append(cp.capacity_stats())
    cp.retire_tenant(1)
    out.append(cp.capacity_stats())
    cp.compact()
    out.append(cp.capacity_stats())
    return out


def test_capacity_stats_equal_through_the_tenant_lifecycle():
    got = _lifecycle(TCP, {"device": "cpu"})
    assert got == _lifecycle(JCP, {})
    live = got[-1]
    assert set(live["gp"]["tenants"]) == {0, 2}
    assert live["layout"]["slots_live"] == 7
    assert live["gp"]["readout_bytes"] == 2 * live["gp"]["capacity"] * 4


def _churn_trace(S):
    return S.poisson_churn_trace(num_sessions=10, arrival_rate=1.2, seed=6,
                                 m_min=2, m_max=8, session_scale=12.0,
                                 num_failure_slices=1)


def _factory(O, S, Fleet, bag, **cfg):
    def make(**kw):
        reg = O.MetricsRegistry()
        planes = dict(
            metrics=reg, exporter=O.MetricsExporter(reg, window=5.0),
            health=O.HealthMonitor(slo={"device_utilization": 1.5},
                                   window=5.0, burn_windows=2, stall_k=4,
                                   queue_limit=2,
                                   memory_budget_bytes=4096.0),
            accounting=O.CapacityAccountant(reg, window=5.0))
        bag.append(planes)
        return S.StreamEngine(Fleet.partition_pod(16 * 3, 3), "mdmt",
                              seed=0, max_live_models=30, num_shards=2,
                              **planes, **cfg, **kw)
    return make


def test_accounting_is_observation_only_and_equals_the_reference():
    trace = _churn_trace(TS)
    bag, jbag = [], []
    eng = _factory(TO, TS, TFleet, bag, device="cpu")()
    res = eng.run(trace)
    twin = TS.StreamEngine(TFleet.partition_pod(16 * 3, 3), "mdmt", seed=0,
                           max_live_models=30, num_shards=2,
                           device="cpu").run(trace)
    assert _trials(res) == _trials(twin)
    jeng = _factory(JO, JS, JFleet, jbag)()
    jeng.run(_churn_trace(JS))
    acc = bag[0]["accounting"]
    assert acc.samples == jbag[0]["accounting"].samples
    assert len(acc.samples) >= 3
    # the end-of-run sample is the final plane's own introspection
    final, stats = acc.samples[-1], eng.cp.capacity_stats()
    assert final["gp_alloc_bytes"] == stats["gp"]["alloc_bytes"]
    assert final["shard_slots"] == list(stats["layout"]["per_shard"])
    assert sum(final["devices"].values()) == \
        sum(1 for s in eng.fleet.slices if not s.retired)
    assert [a.to_record() for a in eng.health.alerts] == \
        [a.to_record() for a in jeng.health.alerts]
    assert any(a.kind == "memory_runaway" for a in eng.health.alerts)
    # the scrape surface: equal text but for the wall-clock series
    keep = ("capacity_", "health_alerts_total", "engine_events",
            "engine_launches", "engine_queue_depth", "# TYPE")
    lines = [[ln for ln in e.exporter.prometheus().splitlines()
              if ln.startswith(keep)] for e in (eng, jeng)]
    assert lines[0] == lines[1]
    assert any(ln.startswith("health_alerts_total") for ln in lines[0])


@pytest.mark.parametrize("where", ["early", "middle", "late"])
def test_capacity_samples_replay_stable_across_crash(tmp_path, where):
    trace = _churn_trace(TS)
    ref_bag = []
    ref_eng = _factory(TO, TS, TFleet, ref_bag, device="cpu")()
    ref_res = ref_eng.run(trace)
    ref_samples = ref_bag[0]["accounting"].samples
    n = ref_eng.event_index
    crash_at = {"early": 2, "middle": n // 2, "late": n - 1}[where]
    bag = []
    make = _factory(TO, TS, TFleet, bag, device="cpu")
    eng = make(log=TS.EventLog(tmp_path / "log"),
               snapshot_root=str(tmp_path / "snap"), snapshot_every=5,
               fault=TS.FaultInjector(crash_at, "before"))
    with pytest.raises(TS.SimulatedCrash):
        eng.run(trace)
    eng.log.close()
    eng2, resumed_from = TS.recover(make, str(tmp_path / "snap"),
                                    TS.EventLog.load(tmp_path / "log"))
    res2 = eng2.resume()
    assert _trials(res2) == _trials(ref_res)
    assert bag[-1]["accounting"].samples == \
        [r for r in ref_samples if r["event_index"] > resumed_from]


def _device_churn(pkg):
    S, O, Fleet, registry, Dev = (
        (TS, TO, TFleet, t_registry, TDev) if pkg == "port"
        else (JS, JO, JFleet, j_registry, JDev))
    trace = S.device_churn_trace(
        num_sessions=40, arrival_rate=1.0, seed=1, initial_slices=4,
        join_classes=(("fast", 16, 2.0), ("slow", 16, 1.0)),
        join_rate=0.05, leave_rate=0.03, preempt_rate=0.05,
        m_min=2, m_max=10, session_scale=25.0)
    reg = O.MetricsRegistry()
    dreg = registry(2.0, overhead=0.5)
    planes = dict(metrics=reg, exporter=O.MetricsExporter(reg, window=5.0),
                  health=O.HealthMonitor(queue_limit=4),
                  accounting=O.CapacityAccountant(reg, window=5.0))
    kw = {"device": "cpu"} if pkg == "port" else {}
    eng = Dev(dreg.build_fleet([("slow", 2), ("fast", 2)]), "mdmt", seed=0,
              registry=dreg, launch_order="fastest", max_live_models=80,
              **planes, **kw)
    return eng, eng.run(trace), planes


def test_exporter_windows_and_capacity_under_device_churn():
    eng, res, planes = _device_churn("port")
    jeng, jres, jplanes = _device_churn("ref")
    assert _trials(res) == _trials(jres)
    recs = planes["exporter"].records
    keys = [(r["window"], r["t"], r["event_index"], bool(r.get("final")),
             r["alerts"]) for r in recs]
    assert keys == [(r["window"], r["t"], r["event_index"],
                     bool(r.get("final")), r["alerts"])
                    for r in jplanes["exporter"].records]
    body = recs[:-1]
    assert recs[-1]["final"] and len(body) >= 2
    assert all(r["window"] == int(r["t"] // 5.0) for r in body)
    samples = planes["accounting"].samples
    assert samples == jplanes["accounting"].samples
    assert len({tuple(sorted(s["devices"].items())) for s in samples}) >= 2
    assert all({"autoscale_joins", "autoscale_leaves", "scoring_passes",
                "devices_quarantined"} <= set(s) for s in samples)


def test_prometheus_renders_alert_counts_and_capacity_gauges():
    texts = []
    for O in (TO, JO):
        reg = O.MetricsRegistry()
        reg.gauge("capacity.gp_bytes").set(1234)
        reg.gauge("capacity.shard_slots", {"shard": "0"}).set(7)
        h = O.HealthMonitor(memory_budget_bytes=100.0)
        h.on_capacity(0.0, 1, bytes_now=200.0, projected_bytes=200.0)
        exp = O.MetricsExporter(reg, window=5.0, health=h)
        exp.tick(0.1, 1)
        bare = O.MetricsExporter(reg, window=5.0)
        bare.tick(0.1, 1)
        texts.append((exp.prometheus(), exp.records, bare.prometheus(),
                      bare.records))
    assert texts[0] == texts[1]
    text, records, bare_text, bare_records = texts[0]
    assert 'health_alerts_total{kind="memory_runaway"} 1' in text
    assert 'capacity_shard_slots{shard="0"} 7' in text
    assert records[0]["alerts"] == {"memory_runaway": 1}
    assert "health_alerts_total" not in bare_text
    assert "alerts" not in bare_records[0]


# --- profile -----------------------------------------------------------------------

def test_capture_is_a_no_op_without_a_logdir_or_a_card(tmp_path):
    with profile.capture(None) as win:
        pass
    assert not win and win.path is None and win.device_events == 0
    if not profile.profiler_available():
        with profile.capture(tmp_path) as win:
            pass
        assert not win and not list(tmp_path.iterdir())
        with pytest.raises(RuntimeError, match="cannot trace a card"):
            profile.capture_call(lambda: None, tmp_path)


def test_profile_probes_run_over_a_cpu_mesh():
    sc = ShardedScorer(4, device="cpu")
    calls = []

    def make_thunk(s, dev):
        x = torch.ones(8, device=dev)
        return lambda: calls.append(s) or x * s

    skew = profile.per_shard_skew(make_thunk, sc.mesh, iters=3, warmup=1)
    assert calls == [s for s in range(4) for _ in range(4)]
    assert len(skew["per_shard_us"]) == 4
    assert skew["min_us"] <= skew["mean_us"] <= skew["max_us"]
    assert skew["skew"] == pytest.approx(skew["max_us"] / skew["mean_us"])
    assert profile.dispatch_overhead_us(sc.mesh, iters=3, warmup=1) > 0.0
    assert profile.time_us_blocked(lambda: torch.zeros(2), iters=2) > 0.0
