"""The port's streaming engine, event log and snapshot store against the JAX
package, on the CPU.

Workloads, telemetry and the store are numpy code: equal seeds and inputs
must give equal events, summaries and bytes.  The port's ``StreamEngine``
(``device="cpu"``, scorer ``"ops"``, the counterpart of the reference's
``"fused"``) must give the reference's trial sequences, telemetry and
processed-event log exactly, through admission control, departures, slice
failures, compaction, supervision, poison and mesh shrink.  The replay
oracle -- snapshot + replay(suffix) == uninterrupted run -- must hold on the
port, and the port must resume from a snapshot and log the reference wrote.
Only wall-clock fields (``decision_seconds``) are left out of comparisons.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.checkpoint.store as jstore  # noqa: E402
import repro.stream as JS  # noqa: E402
from repro.core import synthetic_matern_problem as j_problem  # noqa: E402
from repro.core.fleet import Fleet as JFleet  # noqa: E402
import repro_torch.checkpoint.store as tstore  # noqa: E402
import repro_torch.stream as TS  # noqa: E402
from repro_torch.core import simulate as t_simulate  # noqa: E402
from repro_torch.core import synthetic_matern_problem as t_problem  # noqa: E402
from repro_torch.core.fleet import Fleet as TFleet  # noqa: E402
from repro_torch.kernels import ei_score, gp_readout  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402

PKG = {"ref": (JS, JFleet), "port": (TS, TFleet)}


@pytest.fixture(autouse=True)
def cpu_path_never_launches():
    """Every plane here lives on the CPU: no kernel launch is counted."""
    before = (ei_score.launches, ei_score.topk_launches,
              ei_score.classes_launches, gp_readout.launches)
    yield
    assert (ei_score.launches, ei_score.topk_launches,
            ei_score.classes_launches, gp_readout.launches) == before


def _seq(res):
    return [dataclasses.astuple(t) for t in res.trials]


def _events(trace, S=TS):
    """The trace's events as JSON lines, by package ``S``'s serializer."""
    return [json.dumps(S.eventlog.serialize_event(e)) for e in trace.events]


# --- workloads ---------------------------------------------------------------------

TRACES = {
    "poisson": ("poisson_churn_trace",
                dict(num_sessions=30, arrival_rate=1.5, seed=3, m_min=2,
                     m_max=12, cost="lognormal", num_failure_slices=3)),
    "device_churn": ("device_churn_trace",
                     dict(num_sessions=30, seed=1, initial_slices=4,
                          join_classes=(("fast", 16, 2.0), ("slow", 8, 1.0)),
                          join_rate=0.2, leave_rate=0.1, preempt_rate=0.2)),
    "chaos": ("chaos_trace",
              dict(num_sessions=30, seed=2, hang_rate=0.3, poison_rate=0.1,
                   flake_rate=0.1, loss_rate=0.1, shrink_at=5.0,
                   shrink_shards=2)),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_workloads_equal_at_equal_seeds(name):
    maker, kw = TRACES[name]
    got, want = getattr(TS, maker)(**kw), getattr(JS, maker)(**kw)
    assert got.name == want.name and got.num_sessions == want.num_sessions
    assert _events(got) == _events(want, JS)
    if name == "chaos":
        assert _events(got.twin()) == _events(want.twin(), JS)
        kinds = {type(e).__name__ for e in got.events}
        assert {"TrialHang", "TrialPoison", "SliceFail", "DeviceLeave",
                "MeshShrink"} <= kinds


def test_trace_from_problem_equal_and_validated():
    got = TS.trace_from_problem(t_problem(3, 5, seed=2))
    want = JS.trace_from_problem(j_problem(3, 5, seed=2))
    assert _events(got) == _events(want, JS) and got.name == want.name
    with pytest.raises(ValueError, match="time-sorted"):
        TS.ChurnTrace((TS.TenantDepart(2.0, 0), TS.TenantDepart(1.0, 1)))
    with pytest.raises(ValueError, match="shrink_shards"):
        TS.chaos_trace(5, seed=0, shrink_at=3.0)


# --- engines against the reference --------------------------------------------------

def _engine(pkg, slices=4, policy="mdmt", **kw):
    S, Fleet = PKG[pkg]
    if pkg == "port":
        kw.setdefault("device", "cpu")
    elif kw.get("scorer") is not None:
        kw["scorer"] = "fused"     # decides as the port's ops and sharded
    speeds = kw.pop("speeds", None)
    fleet = Fleet.partition_pod(16 * slices, slices, speeds=speeds)
    return S.StreamEngine(fleet, policy, seed=kw.pop("seed", 0), **kw)


def both(trace_fn, **kw):
    out = {}
    for pkg in PKG:
        eng = _engine(pkg, **kw)
        out[pkg] = (eng, eng.run(trace_fn(PKG[pkg][0])))
    return out


def assert_same_run(out):
    (je, jr), (te, tr) = out["ref"], out["port"]
    assert _seq(tr) == _seq(jr)
    assert (tr.end_time, tr.decisions, tr.policy_launches,
            tr.compaction_moves) == (jr.end_time, jr.decisions,
                                     jr.policy_launches, jr.compaction_moves)
    assert te.compaction_move_counts == je.compaction_move_counts
    assert tr.telemetry.summary() == jr.telemetry.summary()
    assert tr.telemetry.per_tenant() == jr.telemetry.per_tenant()
    assert tr.telemetry.per_device() == jr.telemetry.per_device()
    assert tr.telemetry.state_dict() == jr.telemetry.state_dict()
    assert te.log.processed == je.log.processed


def _problem_trace(S):
    mod = t_problem if S is TS else j_problem
    return S.trace_from_problem(mod(3, 8, seed=5))


@pytest.mark.parametrize("policy", ["mdmt", "round_robin", "random"])
@pytest.mark.parametrize("slices", [1, 3])
def test_churn_free_replay_equals_reference_and_simulate(policy, slices):
    out = both(_problem_trace, slices=slices, policy=policy)
    assert_same_run(out)
    sim = t_simulate(t_problem(3, 8, seed=5), policy, num_devices=slices,
                     seed=0, device="cpu")
    assert [(t.model, t.device, t.start, t.end, t.z)
            for t in out["port"][1].trials] == \
           [(t.model, t.device, t.start, t.end, t.z) for t in sim.trials]


def test_engines_default_to_the_card():
    """``device=None`` means the card: without one the engines raise rather
    than move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    import repro_torch.devplane as TD
    for make in (TS.StreamEngine, TD.DevPlaneEngine):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(TFleet.partition_pod(32, 2), "mdmt")


def test_launch_order_fastest_on_heterogeneous_speeds():
    out = both(_problem_trace, speeds=[1.0, 3.0, 2.0], slices=3,
               launch_order="fastest")
    assert_same_run(out)
    with pytest.raises(ValueError, match="launch_order"):
        _engine("port", launch_order="nope")


CHURN = dict(num_sessions=20, arrival_rate=1.0, seed=5, m_min=2, m_max=10,
             session_scale=15.0, num_failure_slices=4)


@pytest.mark.parametrize("cfg", [
    dict(max_live_models=30),
    dict(max_live_models=30, compact_every=2, num_shards=2),
    dict(max_live_models=40, compact_max_moves=1, num_shards=3),
    dict(max_live_models=40, scorer="sharded", num_shards=2,
         compact_every=1),
], ids=["admission", "compact", "incremental", "sharded"])
def test_tenant_churn_equals_reference(cfg):
    """Admission queue, departures, slice failures and compaction."""
    out = both(lambda S: S.poisson_churn_trace(**CHURN), **cfg)
    assert_same_run(out)
    eng, res = out["port"]
    s = res.telemetry.summary()
    assert s["queue_depth_max"] > 0 and s["trials_failed"] > 0
    assert s["sessions_departed_while_queued"] >= 0
    seen = [(t.tenant_key, t.local_model) for t in res.trials
            if t.z is not None]
    assert len(seen) == len(set(seen))
    if "compact_every" in cfg:
        assert sum(eng.compaction_move_counts) > 0


def _tiny(S, key, at, m=3, seed=0, cost=1.0):
    rng = np.random.default_rng(seed)
    return S.TenantArrive(at=at, tenant_key=key,
                          K_block=0.04 * np.eye(m) + 0.01,
                          mu0=np.full(m, 0.5), cost=np.full(m, float(cost)),
                          z_true=rng.uniform(0.2, 0.9, m))


def _fixed(events_fn):
    return lambda S: S.ChurnTrace(events=tuple(sorted(events_fn(S),
                                                      key=lambda e: e.at)))


SCENARIOS = {
    # departed tenant stops being served; its late completion is discarded
    "depart": (dict(slices=2), lambda S: [
        _tiny(S, 0, 0.0, m=2, seed=1, cost=10.0), _tiny(S, 1, 0.0, m=4),
        S.TenantDepart(at=1.0, tenant_key=0)]),
    # admission on departure; a queued tenant's departure unblocks the line
    "queue": (dict(slices=2, max_live_models=4), lambda S: [
        _tiny(S, 0, 0.0, m=4, seed=1), _tiny(S, 1, 1.0, m=4, seed=2),
        _tiny(S, 2, 1.5, m=2, seed=3), S.TenantDepart(at=2.0, tenant_key=1),
        S.TenantDepart(at=6.0, tenant_key=0)]),
    # a slice dies mid-trial, the model returns to the pool, it recovers
    "slice_fail": (dict(slices=1), lambda S: [
        _tiny(S, 0, 0.0, m=3, seed=1, cost=4.0),
        S.SliceFail(at=1.0, slice_id=0, downtime=2.0)]),
    # supervision: hang, timeout, retry; exhausting the budget abandons
    "hang_retry": (dict(slices=1, timeout_factor=1.5, max_retries=1), lambda S: [
        _tiny(S, 0, 0.0, m=1, cost=10.0), S.TrialHang(at=1.0, slice_id=0),
        S.TrialHang(at=17.0, slice_id=0),
        S.TenantDepart(at=200.0, tenant_key=0)]),
    # a poisoned loss never reaches the GP; the model is rerun clean
    "poison": (dict(slices=1), lambda S: [
        _tiny(S, 0, 0.0, m=3), S.TrialPoison(at=0.5, slice_id=0),
        S.TenantDepart(at=200.0, tenant_key=0)]),
    # hang without supervision strands the device
    "stranded": (dict(slices=1), lambda S: [
        _tiny(S, 0, 0.0, m=3, cost=10.0), S.TrialHang(at=1.0, slice_id=0)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_reference(name):
    kw, events = SCENARIOS[name]
    out = both(_fixed(events), **kw)
    assert_same_run(out)
    s = out["port"][1].telemetry.summary(now=out["port"][0]._t)
    expect = {"depart": ("observations_rejected_after_depart", 2),
              "queue": ("sessions_departed_while_queued", 1),
              "slice_fail": ("trials_failed", 1),
              "hang_retry": ("trials_abandoned", 1),
              "poison": ("observations_rejected", 1),
              "stranded": ("trials", 1)}[name]
    assert s[expect[0]] == expect[1]


def test_supervision_and_mesh_shrink_under_chaos():
    """A seeded chaos overlay with supervision on, and a mesh shrink from
    four shards to two; the chaos-free twin is untouched by supervision."""
    kw = dict(num_sessions=20, seed=3, initial_slices=4, hang_rate=0.3,
              poison_rate=0.3, flake_rate=0.05, loss_rate=0.03,
              shrink_at=8.0, shrink_shards=2, m_min=2, m_max=8,
              session_scale=15.0)
    cfg = dict(max_live_models=40, num_shards=4, timeout_factor=2.0,
               max_retries=2, retry_backoff=0.5, compact_every=2)
    out = both(lambda S: S.chaos_trace(**kw), **cfg)
    assert_same_run(out)
    s = out["port"][1].telemetry.summary()
    assert s["trials_timed_out"] > 0 and s["observations_rejected"] > 0
    assert out["port"][0].cp._layout.num_shards == 2
    bare = _engine("port", max_live_models=40).run(TS.chaos_trace(**kw).twin())
    sup = _engine("port", max_live_models=40, timeout_factor=2.0).run(
        TS.chaos_trace(**kw).twin())
    assert _seq(bare) == _seq(sup)
    with pytest.raises(ValueError, match="timeout_factor"):
        _engine("port", timeout_factor=1.0)


def test_tracing_is_observation_only():
    tracer = Tracer()
    trace = TS.poisson_churn_trace(**CHURN)
    traced = _engine("port", max_live_models=30, scorer="sharded",
                     num_shards=2, tracer=tracer).run(trace)
    bare = _engine("port", max_live_models=30, scorer="sharded",
                   num_shards=2).run(trace)
    assert _seq(traced) == _seq(bare)
    names = {s[3] for s in tracer.signature()}
    assert {"event", "decide", "launch", "posterior", "score", "gp_fold",
            "pad_upload", "shard_decide"} <= names
    assert tracer.signature(min_trace=5)[0][0] >= 5


# --- telemetry, store, event log ------------------------------------------------------

def test_telemetry_summary_and_json_round_trip(tmp_path):
    out = both(lambda S: S.poisson_churn_trace(**CHURN), max_live_models=30)
    tel = out["port"][1].telemetry
    path = tel.to_json(tmp_path / "t.json")
    payload = json.loads(path.read_text())
    assert payload["summary"] == json.loads(json.dumps(tel.summary()))
    assert payload["summary"] == json.loads(json.dumps(
        out["ref"][1].telemetry.summary()))
    again = TS.TelemetrySink()
    again.load_state(json.loads(json.dumps(tel.state_dict())))
    assert again.summary() == tel.summary()
    assert again.per_device() == tel.per_device()


def _tree(rng):
    return {"cp/selected": rng.random(7) < 0.5,
            "gp/3/K": rng.standard_normal((4, 4)),
            "trials/model": rng.integers(0, 9, 5),
            "a": np.float32(2.5) * np.ones((2, 3), np.float32)}


def test_store_round_trip_and_byte_compatible(tmp_path, rng):
    tree = _tree(rng)
    for name, mod in (("t", tstore), ("j", jstore)):
        mod.save_checkpoint(tmp_path / name, 7, tree, {"k": [1, 2]})
    for f in ("manifest.json", "arrays.npz"):
        assert (tmp_path / "t/step_00000007" / f).read_bytes() == \
               (tmp_path / "j/step_00000007" / f).read_bytes()
    # each package reads the other's snapshot
    for reader, root in ((tstore, "j"), (jstore, "t")):
        arrays, meta = reader.load_arrays(tmp_path / root, 7)
        assert meta == {"k": [1, 2]} and sorted(arrays) == sorted(tree)
        for k, v in tree.items():
            np.testing.assert_array_equal(arrays[k], v)
            assert arrays[k].dtype == np.asarray(v).dtype
    assert tstore.latest_step(tmp_path / "t") == 7
    got, _ = tstore.load_checkpoint(tmp_path / "j", 7, tree)
    assert sorted(got) == sorted(tree)
    with pytest.raises(KeyError):
        tstore.load_checkpoint(tmp_path / "j", 7, {"nope": 0})
    with pytest.raises(FileNotFoundError):
        tstore.load_arrays(tmp_path / "t", 8)


def test_store_refuses_corrupt_snapshots(tmp_path, rng):
    root = tmp_path / "s"
    step = tstore.save_checkpoint(root, 1, _tree(rng))
    (step / "arrays.npz").write_bytes(b"torn")
    with pytest.raises(tstore.CheckpointError, match="corrupt"):
        tstore.load_arrays(root, 1)
    step = tstore.save_checkpoint(root, 2, _tree(rng))
    m = json.loads((step / "manifest.json").read_text())
    m["schema_version"] = 99
    (step / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(tstore.CheckpointError, match="schema_version"):
        tstore.load_arrays(root, 2)


def test_checkpoint_manager_async_and_retention(tmp_path, rng):
    mgr = tstore.CheckpointManager(tmp_path / "m", keep=2)
    trees = [_tree(rng) for _ in range(4)]
    for i, tree in enumerate(trees):
        mgr.save(i, tree, {"i": i}, blocking=(i % 2 == 0))
    mgr.save(3, trees[0])                       # a step saves once
    mgr.wait()
    step, got, meta = mgr.restore_latest(trees[3])
    assert step == 3 and meta == {"i": 3}
    np.testing.assert_array_equal(got["gp/3/K"], trees[3]["gp/3/K"])
    assert len(list((tmp_path / "m").glob("step_*"))) == 2


def test_event_serialization_round_trip():
    trace = TS.chaos_trace(**TRACES["chaos"][1])
    extra = (TS.DeviceJoin(1.0, chips=8, speed=2.0, cls="fast"),
             TS.DevicePreempt(2.0, 3), TS.DeviceLeave(3.0, 1))
    for ev in trace.events + extra:
        back = TS.eventlog.deserialize_event(json.loads(json.dumps(
            TS.eventlog.serialize_event(ev))))
        assert json.dumps(TS.eventlog.serialize_event(back)) == \
               json.dumps(TS.eventlog.serialize_event(ev))
        assert type(back) is type(ev) and back.at == ev.at
    with pytest.raises(TypeError):
        TS.eventlog.serialize_event(object())
    with pytest.raises(TypeError):
        TS.eventlog.deserialize_event({"type": "Nope", "at": 0.0})


def test_durable_log_equals_reference_bytes(tmp_path):
    """The same trace through both engines writes the same JSONL streams
    (processed records carry no wall clock)."""
    for pkg in PKG:
        S = PKG[pkg][0]
        eng = _engine(pkg, max_live_models=30, compact_every=2,
                      num_shards=2, log=S.EventLog(tmp_path / pkg))
        eng.run(S.poisson_churn_trace(**CHURN))
        eng.log.close()
    for f in ("external.jsonl", "processed.jsonl", "meta.json"):
        assert (tmp_path / "port" / f).read_bytes() == \
               (tmp_path / "ref" / f).read_bytes()
    log = TS.EventLog.load(tmp_path / "ref")
    assert len(log.processed) > 40
    meta = tmp_path / "port" / "meta.json"
    meta.write_text(json.dumps({"schema_version": 99}))
    with pytest.raises(ValueError, match="schema_version"):
        TS.EventLog.load(tmp_path / "port")


def test_first_divergence_and_fault_injector():
    a = [(1, 0.0, "x", []), (2, 1.0, "y", [1])]
    assert TS.first_divergence(a, list(a)) is None
    assert TS.first_divergence(a, a[:1] + [(2, 1.0, "y", [2])])["offset"] == 1
    assert TS.first_divergence(a, a[:1])["len_b"] == 1
    f = TS.FaultInjector(3, "after")
    f.check("before", 5)
    f.check("after", 2)
    with pytest.raises(TS.SimulatedCrash):
        f.check("after", 4)
    f.check("after", 9)                        # fires once


# --- the replay oracle on the port -------------------------------------------------------

def _make(**cfg):
    def make(**kw):
        return _engine("port", max_live_models=40, num_shards=2, **cfg, **kw)
    return make


def crash_and_recover(make, trace, crash, tmp_path, snapshot_every=6,
                      writer=TS):
    tag = f"{crash[1]}_{crash[0]}"
    eng = make(log=writer.EventLog(tmp_path / f"log_{tag}"),
               snapshot_root=str(tmp_path / f"snap_{tag}"),
               snapshot_every=snapshot_every,
               fault=writer.FaultInjector(*crash))
    with pytest.raises(writer.SimulatedCrash):
        eng.run(trace)
    eng.log.close()
    log = TS.EventLog.load(tmp_path / f"log_{tag}")
    rec, step = TS.recover(make, str(tmp_path / f"snap_{tag}"), log)
    res = rec.resume()
    prefix = [tuple(r) for r in log.processed if r[0] <= step]
    return rec, res, prefix + rec.log.processed, step


def assert_replay_matches(full_eng, full, rec, res, processed):
    assert _seq(res) == _seq(full)
    assert res.telemetry.summary() == full.telemetry.summary()
    assert res.telemetry.per_device() == full.telemetry.per_device()
    assert (res.policy_launches, res.compaction_moves, rec.event_index) == \
           (full.policy_launches, full.compaction_moves, full_eng.event_index)
    assert TS.first_divergence(full_eng.log.processed, processed) is None


@pytest.mark.parametrize("crash", [(1, "before"), (17, "before"),
                                   (44, "after"), (9, "mid_compact"),
                                   (30, "mid_launch")])
def test_crash_anywhere_stream_engine(tmp_path, crash):
    trace = TS.poisson_churn_trace(**CHURN)
    make = _make(compact_every=1)
    full_eng = make()
    full = full_eng.run(trace)
    assert full_eng.event_index > 44 and sum(full_eng.compaction_move_counts)
    assert_replay_matches(full_eng, full,
                          *crash_and_recover(make, trace, crash, tmp_path)[:3])


@pytest.mark.parametrize("policy", ["random", "round_robin"])
def test_crash_anywhere_policies_with_rng(tmp_path, policy):
    trace = TS.poisson_churn_trace(num_sessions=8, seed=5, m_min=2, m_max=8,
                                   session_scale=12.0)
    make = _make(policy=policy, seed=11)
    full_eng = make()
    full = full_eng.run(trace)
    for idx in (2, full_eng.event_index // 2):
        assert_replay_matches(full_eng, full, *crash_and_recover(
            make, trace, (idx, "before"), tmp_path / str(idx))[:3])


def test_recover_from_genesis_and_past_a_corrupt_snapshot(tmp_path):
    trace = TS.poisson_churn_trace(**CHURN)
    make = _make(compact_every=2)
    full_eng = make()
    full = full_eng.run(trace)
    rec, res, processed, step = crash_and_recover(
        make, trace, (20, "before"), tmp_path / "g", snapshot_every=None)
    assert step == 0
    assert_replay_matches(full_eng, full, rec, res, processed)
    # a torn newest snapshot: recovery falls back to the older step
    eng = make(log=TS.EventLog(tmp_path / "log"),
               snapshot_root=str(tmp_path / "snap"), snapshot_every=5,
               fault=TS.FaultInjector(33))
    with pytest.raises(TS.SimulatedCrash):
        eng.run(trace)
    eng.log.close()
    newest = tstore.latest_step(tmp_path / "snap")
    (tmp_path / "snap" / f"step_{newest:08d}" / "arrays.npz").write_bytes(b"")
    log = TS.EventLog.load(tmp_path / "log")
    rec, step = TS.recover(make, str(tmp_path / "snap"), log)
    assert 0 < step < newest
    res = rec.resume()
    assert_replay_matches(full_eng, full, rec, res,
                          [tuple(r) for r in log.processed if r[0] <= step]
                          + rec.log.processed)


@pytest.mark.parametrize("crash", [(12, "before"), (40, "after")])
def test_port_resumes_a_reference_run(tmp_path, crash):
    """The reference writes the log and snapshots and crashes; the port
    recovers from them and finishes the reference's uninterrupted run."""
    kw = dict(num_sessions=14, seed=3, initial_slices=4, hang_rate=0.08,
              poison_rate=0.08, flake_rate=0.05, m_min=2, m_max=8,
              session_scale=15.0)
    cfg = dict(max_live_models=40, num_shards=2, compact_every=2,
               timeout_factor=2.0, max_retries=2)
    full_eng = _engine("ref", **cfg)
    full = full_eng.run(JS.chaos_trace(**kw))
    ref_make = lambda **k: _engine("ref", **cfg, **k)    # noqa: E731
    tag = f"{crash[1]}_{crash[0]}"
    eng = ref_make(log=JS.EventLog(tmp_path / tag),
                   snapshot_root=str(tmp_path / f"s{tag}"), snapshot_every=6,
                   fault=JS.FaultInjector(*crash))
    with pytest.raises(JS.SimulatedCrash):
        eng.run(JS.chaos_trace(**kw))
    eng.log.close()
    log = TS.EventLog.load(tmp_path / tag)
    rec, step = TS.recover(lambda: _engine("port", **cfg),
                           str(tmp_path / f"s{tag}"), log)
    assert step > 0
    res = rec.resume()
    assert _seq(res) == _seq(full)
    assert res.telemetry.summary() == full.telemetry.summary()
    prefix = [tuple(r) for r in log.processed if r[0] <= step]
    assert TS.first_divergence(full_eng.log.processed,
                               prefix + rec.log.processed) is None
