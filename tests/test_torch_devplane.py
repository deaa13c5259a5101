"""The port's elastic device plane against the JAX package, on the CPU.

Class scores: the port's plain class-axis EIrate (``ref.eirate_classes_ref``,
the CUDA kernel's plain version) and ``core.ei.choose_topk_classes`` against
the reference's ``ref.eirate_classes_ref`` and ``choose_topk_classes`` on the
sweep of ``test_kernels.py``: values to 1e-6 (absolute and relative) above
-1e29, ids exact.  Against ``eirate_classes_pallas`` (interpret mode) the
values agree to 1e-4, the tolerance ``test_kernels.py`` holds that kernel
to its own reference with: it takes Phi from erf (zero in the far tail)
and sums tenants in blocks, which moves a 33-tenant sum by up to about ten
float32 ulps (4.8e-6 at a score of 4.7).  The kernel path masks with -1e30
and the reference's jnp path with -inf, and both are unlaunchable
(``assign.NEG_FLOOR``), so entries at or below -1e29 are compared as
masked.

Engines: the port's ``DevPlaneEngine`` (``device="cpu"``, scorers ``"ops"``
and ``"sharded"``) must give the reference's trial sequences exactly,
under tenant and device churn, autoscale and quarantine, and resume from
snapshots either package wrote.  Everything but wall-clock fields
(``decision_seconds``) is compared.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import repro.devplane as JD  # noqa: E402
import repro.stream as JS  # noqa: E402
from repro.core import ControlPlane as JPlane  # noqa: E402
from repro.core import ei as jei  # noqa: E402
from repro.core.fleet import Fleet as JFleet  # noqa: E402
from repro.core.tenancy import _matern_block_chol  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
import repro_torch.devplane as TD  # noqa: E402
import repro_torch.stream as TS  # noqa: E402
from repro_torch.core import ControlPlane as TPlane  # noqa: E402
from repro_torch.core import ei as tei  # noqa: E402
from repro_torch.core.fleet import Fleet as TFleet  # noqa: E402
from repro_torch.kernels import ei_score, gp_readout, ops, ref  # noqa: E402
from repro_torch.shardgp import SCORE_KERNELS, ShardedScorer  # noqa: E402

VAL = dict(atol=1e-6, rtol=1e-6)
PALLAS = dict(atol=1e-4, rtol=1e-4)
FLOOR = -1e29

PKG = {"ref": (JS, JD, JFleet), "port": (TS, TD, TFleet)}


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


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_scores_match(got, want, tol=VAL):
    """Values to ``tol`` above the floor; at or below it both are masked."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    live = want > FLOOR
    assert ((got > FLOOR) == live).all()
    np.testing.assert_allclose(got[live], want[live], **tol)


def assert_topk_match(got, want):
    (gv, gi), (wv, wi) = [(_np(v), _np(i)) for v, i in (got, want)]
    assert_scores_match(gv, wv)
    live = wv > FLOOR
    np.testing.assert_array_equal(gi[live], wi[live])


def _class_inputs(rng, n, N, C):
    mu = rng.standard_normal(n).astype(np.float32)
    sg = np.abs(rng.standard_normal(n)).astype(np.float32)
    sg[: n // 4] = 0.0
    best = rng.standard_normal(N).astype(np.float32)
    mem = rng.random((N, n)) < 0.4
    cm = rng.uniform(0.3, 3.0, (C, n)).astype(np.float32)
    sel = rng.random(n) < 0.25
    return mu, sg, best, mem, cm, sel


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --- class-axis scores ---------------------------------------------------------

@pytest.mark.parametrize("n,N,C,bm,bu", [
    (64, 8, 2, 64, 8), (200, 33, 3, 64, 16), (17, 3, 5, 256, 256),
])
def test_eirate_classes_plain_matches_pallas_and_ref(rng, n, N, C, bm, bu):
    arrays = _class_inputs(rng, n, N, C)
    got = ops.eirate_classes(*_t(*arrays))
    assert got.shape == (C, n)
    j = [jnp.asarray(a) for a in arrays]
    assert_scores_match(got, jops.eirate_classes(
        *j, block_models=bm, block_users=bu, interpret=True), PALLAS)
    assert_scores_match(got, jref.eirate_classes_ref(*j))
    # row c is the single-class plain version with cost row c, bit for bit
    mu, sg, best, mem, cm, sel = _t(*arrays)
    for c in range(C):
        assert torch.equal(got[c], ops.eirate(mu, sg, best, mem, cm[c], sel))


@pytest.mark.parametrize("n,N,C,k", [(64, 8, 2, 4), (200, 33, 3, 7),
                                     (17, 3, 5, 20)])
def test_choose_topk_classes_matches_jax(rng, n, N, C, k):
    mu, sg, best, mem, cm, sel = _class_inputs(rng, n, N, C)
    got = tei.choose_topk_classes(*_t(mu, sg, best, mem, cm, sel), k=k)
    want = jei.choose_topk_classes(*[jnp.asarray(a) for a in
                                     (mu, sg, best, mem, cm, sel)], k=k)
    assert got[0].shape == (C, k) and got[1].shape == (C, k)
    assert_topk_match(got, want)
    # the kernel path's scores rank the same candidates
    scores = ops.eirate_classes(*_t(mu, sg, best, mem, cm, sel))
    assert_topk_match(tei.topk_rows_padded(scores, k), want)


def test_memory_gate_is_a_hard_exclusion():
    """+inf cost (a model that does not fit a class) scores -1e30 on the
    kernel path and -inf on the jnp path, never the 0 of a division."""
    n = 6
    mu = np.zeros(n, np.float32)
    sg = np.ones(n, np.float32)
    best = np.full(1, 5.0, np.float32)        # every EI underflows to 0
    mem = np.ones((1, n), bool)
    cm = np.ones((2, n), np.float32)
    cm[1, :3] = np.inf
    sel = np.zeros(n, bool)
    got = ops.eirate_classes(*_t(mu, sg, best, mem, cm, sel))
    assert (got[1, :3] == ref.NEG_LARGE).all() and (got[1, 3:] > FLOOR).all()
    dense = tei.eirate_class_scores(*_t(mu, sg, best, mem, cm, sel))
    assert torch.isneginf(dense[1, :3]).all()
    want = jei.eirate_class_scores(*[jnp.asarray(a) for a in
                                     (mu, sg, best, mem, cm, sel)])
    assert_scores_match(dense, want)
    # the registry's gate reaches the scorer as +inf (not NaN)
    reg = TD.DeviceClassRegistry([TD.DeviceClass("small", mem_gb=8.0),
                                  TD.DeviceClass("big", mem_gb=None)])
    cmat = reg.cost_matrix(np.ones(n), names=["small", "big"],
                           model_mem_gb=np.array([4, 16, 4, 16, 4, 16.0]))
    assert np.isposinf(cmat[0, 1::2]).all() and np.isfinite(cmat[1]).all()
    gated = ops.eirate_classes(*_t(mu, sg, best, mem,
                                   cmat.astype(np.float32), sel))
    assert (gated[0, 1::2] == ref.NEG_LARGE).all()


def test_class_scores_pad_short_rows_and_tie_lowest_id():
    z = torch.zeros(3)
    v, i = tei.topk_rows_padded(torch.stack([z, z + 1.0]), 5)
    assert v.shape == (2, 5) and torch.isneginf(v[:, 3:]).all()
    assert i.tolist() == [[0, 1, 2, 0, 0], [0, 1, 2, 0, 0]]


def _plane(cls, scorer, S=None, tenants=6, m=8, seed=0):
    kw = dict(device="cpu") if cls is TPlane else {}
    cp = cls(np.random.default_rng(seed), scorer=scorer, num_shards=S, **kw)
    rng = np.random.default_rng(seed + 1)
    ids = []
    for t in range(tenants):
        K, _ = _matern_block_chol(m, 0.2, 0.04)
        ids += cp.add_tenant(K, rng.normal(0, 0.1, m),
                             rng.uniform(0.5, 2.0, m)).models.tolist()
    for g in ids[::5]:
        cp.record_start(g)
        cp.record_observation(g, float(rng.normal()))
    return cp


@pytest.mark.parametrize("scorer,S", [("ops", None), ("ops", 4),
                                      ("sharded", 1), ("sharded", 4)])
def test_choose_mdmt_batch_matches_reference(scorer, S):
    ref_cp = _plane(JPlane, "fused", S)
    port = _plane(TPlane, scorer, S)
    rates = np.array([1.0, 2.0, 0.5], np.float32)
    overs = np.array([0.0, 0.5, 0.25], np.float32)
    for k in (1, 4, 9):
        got = port.choose_mdmt_batch(rates, overs, k)
        want = ref_cp.choose_mdmt_batch(rates, overs, k)
        assert got[0].shape == (3, k)
        assert_topk_match(got, want)
    # one class at rate 1, overhead 0: row 0's head is choose_mdmt's pick,
    # bit for bit (the batched == sequential contract)
    v, g = port.choose_mdmt_batch([1.0], [0.0], 3)
    pick = port.choose_mdmt()
    assert int(g[0, 0]) == pick[0]
    assert port.choose_mdmt_batch([1.0], [0.0], 3)[0][0, 0] == v[0, 0]
    # the empty-pool early-out pays no scoring pass
    port.selected[:] = True
    v, g = port.choose_mdmt_batch(rates, overs, 2)
    assert np.isneginf(v).all() and (g == 0).all()


@pytest.mark.parametrize("kernel", SCORE_KERNELS)
@pytest.mark.parametrize("S", [1, 4])
def test_sharded_decide_topk_classes_matches_dense(rng, kernel, S):
    sc = ShardedScorer(S, topk=4, kernel=kernel, device="cpu")
    for _ in range(4):
        n = int(rng.integers(4, 41)) * 4
        N = int(rng.integers(2, 7))
        C = int(rng.integers(1, 4))
        mu = rng.normal(size=n).astype(np.float32)
        sd = np.abs(rng.normal(size=n)).astype(np.float32)
        best = rng.normal(size=N).astype(np.float32)
        mem = rng.random((N, n)) < (1.0 / N)
        cost = rng.uniform(0.5, 2.0, n).astype(np.float32)
        sel = rng.random(n) < 0.3
        rates = rng.uniform(0.5, 4.0, C).astype(np.float32)
        overs = rng.uniform(0.0, 1.0, C).astype(np.float32)
        sc.refresh(mem, cost)
        got = sc.decide_topk_classes(mu, sd, torch.from_numpy(best), sel,
                                     rates, overs, k=4)
        cm = (torch.from_numpy(cost)[None, :] / torch.from_numpy(rates)[:, None]
              + torch.from_numpy(overs)[:, None])
        dense = tei.topk_rows_padded(ops.eirate_classes(
            *_t(mu, sd, best, mem), cm, torch.from_numpy(sel)), 4)
        # the same floats, the same ids: sharding changes nothing
        assert torch.equal(got[0], dense[0]) and torch.equal(got[1], dense[1])
        jcm = (jnp.asarray(cost)[None, :] / jnp.asarray(rates)[:, None]
               + jnp.asarray(overs)[:, None])
        want = jei.choose_topk_classes(
            jnp.asarray(mu), jnp.asarray(sd), jnp.asarray(best),
            jnp.asarray(mem), jcm, jnp.asarray(sel), k=4)
        assert_topk_match(got, want)


# --- registry, assignment, autoscale, quarantine ------------------------------

def test_registry_matches_reference():
    treg = TD.two_class_registry(3.0, overhead=0.7)
    jreg = JD.two_class_registry(3.0, overhead=0.7)
    base = np.array([1.0, 2.0, 4.0])
    mem = np.array([1.0, 50.0, 10.0])
    np.testing.assert_array_equal(treg.cost_matrix(base),
                                  jreg.cost_matrix(base))
    for a, b in zip(treg.rows(["fast", "slow"]), jreg.rows(["fast", "slow"])):
        np.testing.assert_array_equal(a, b)
    big = [TD.DeviceClass("a", mem_gb=16.0), TD.DeviceClass("b", chips=32)]
    jbig = [JD.DeviceClass("a", mem_gb=16.0), JD.DeviceClass("b", chips=32)]
    np.testing.assert_array_equal(
        TD.DeviceClassRegistry(big).cost_matrix(base, model_mem_gb=mem),
        JD.DeviceClassRegistry(jbig).cost_matrix(base, model_mem_gb=mem))
    tf = treg.build_fleet([("slow", 2), ("fast", 1)])
    jf = jreg.build_fleet([("slow", 2), ("fast", 1)])
    assert [dataclasses.astuple(s) for s in tf.slices] == \
           [dataclasses.astuple(s) for s in jf.slices]
    assert TD.DeviceClassRegistry.from_fleet(tf).names == ["fast", "slow"]
    with pytest.raises(ValueError):
        TD.DeviceClass("x", speed=0.0)
    with pytest.raises(KeyError, match="unknown device class"):
        treg["nope"]

    class Roofline:                   # any object with class_trial_seconds
        def class_trial_seconds(self, arch, shape, steps, *, chips, speed,
                                overhead, cfg=None):
            return steps * 64.0 / chips
    c = TD.DeviceClass.from_cost_model("x", Roofline(), "a", "s", 10,
                                       chips=32)
    assert c.rate == JD.DeviceClass.from_cost_model(
        "x", Roofline(), "a", "s", 10, chips=32).rate == 2.0


def test_greedy_assign_matches_reference(rng):
    for _ in range(20):
        C, k = int(rng.integers(1, 4)), int(rng.integers(1, 6))
        vals = -np.sort(-rng.integers(0, 4, (C, k)).astype(np.float32), axis=1)
        vals[rng.random((C, k)) < 0.15] = -1e30
        vals = -np.sort(-vals, axis=1)
        ids = rng.integers(0, 6, (C, k))
        rows = list(rng.integers(0, C, k))
        assert TD.greedy_assign(vals, ids, rows) == \
               JD.greedy_assign(vals, ids, rows)


def test_autoscale_and_quarantine_follow_reference(rng):
    pol = dict(high_backlog=3.0, low_backlog=1.0, cooldown=2.0,
               min_devices=1, max_devices=6)
    ta, ja = TD.AutoscalePolicy(**pol), JD.AutoscalePolicy(**pol)
    qp = dict(threshold=2, window=5.0, duration=3.0, probation_trials=2)
    tq = TD.QuarantineBoard(TD.QuarantinePolicy(**qp))
    jq = JD.QuarantineBoard(JD.QuarantinePolicy(**qp))
    t = 0.0
    for _ in range(200):
        t += float(rng.exponential(1.0))
        kw = dict(backlog=int(rng.integers(0, 30)),
                  num_devices=int(rng.integers(1, 7)),
                  num_free=int(rng.integers(0, 3)))
        assert ta.decide(t, **kw) == ja.decide(t, **kw)
        d = int(rng.integers(0, 4))
        op = int(rng.integers(0, 4))
        if op == 0:
            assert tq.strike(d, t) == jq.strike(d, t)
        elif op == 1:
            tq.on_success(d), jq.on_success(d)
        elif op == 2 and tq.is_quarantined(d):
            tq.begin_probation(d), jq.begin_probation(d)
        assert tq.state_dict() == jq.state_dict()
    fresh = TD.QuarantineBoard()
    fresh.load_state(tq.state_dict())
    assert fresh.state_dict() == tq.state_dict()
    with pytest.raises(ValueError):
        TD.AutoscalePolicy(high_backlog=1.0, low_backlog=2.0)
    with pytest.raises(ValueError):
        TD.QuarantinePolicy(threshold=0)


# --- engines against the reference ----------------------------------------------

def _engine(pkg, fleet_fn, **kw):
    """An engine of either package.  The reference runs ``"fused"`` at the
    same ``num_shards`` (its sharded programs need forced host devices; its
    fused plane decides as its sharded one at any shard count)."""
    S, D, _ = PKG[pkg]
    if pkg == "port":
        kw.setdefault("device", "cpu")
    elif "scorer" in kw:
        kw["scorer"] = "fused"
    for key in ("registry", "autoscale", "quarantine"):
        if key in kw and callable(kw[key]):
            kw[key] = kw[key](D)
    return D.DevPlaneEngine(fleet_fn(pkg), "mdmt", seed=0, **kw)


def _pod(n):
    return lambda pkg: PKG[pkg][2].partition_pod(total_chips=16 * n,
                                                 num_slices=n)


def _two_class(slow, fast, fast_speed=2.0, overhead=0.5):
    def fleet(pkg):
        reg = PKG[pkg][1].two_class_registry(fast_speed, overhead=overhead)
        return reg.build_fleet([("slow", slow), ("fast", fast)])
    return fleet


def _trace(pkg, maker, **kw):
    return getattr(PKG[pkg][0], maker)(**kw)


def both(fleet_fn, maker, trace_kw, **engine_kw):
    out = {}
    for pkg in PKG:
        eng = _engine(pkg, fleet_fn, **engine_kw)
        out[pkg] = (eng, eng.run(_trace(pkg, maker, **trace_kw)))
    return out


def assert_same_run(out):
    (je, jr), (te, tr) = out["ref"], out["port"]
    assert _seq(tr) == _seq(jr)
    assert tr.policy_launches == jr.policy_launches
    assert tr.decisions == jr.decisions
    assert tr.telemetry.summary() == jr.telemetry.summary()
    assert te.log.processed == je.log.processed


CHURN = dict(num_sessions=20, arrival_rate=1.0, seed=0, m_min=2, m_max=10,
             session_scale=25.0)
DEVCHURN = dict(num_sessions=25, arrival_rate=1.0, seed=2, initial_slices=4,
                join_classes=(("fast", 16, 2.0),), join_rate=0.05,
                leave_rate=0.1, preempt_rate=0.1, m_min=2, m_max=10,
                session_scale=20.0)


@pytest.mark.parametrize("assign", TD.ASSIGN_MODES)
@pytest.mark.parametrize("scorer,S", [("ops", None), ("sharded", 4)])
def test_device_churn_equals_reference(assign, scorer, S):
    reg = lambda D: D.two_class_registry(2.0, overhead=0.5)  # noqa: E731
    out = both(_two_class(2, 2), "device_churn_trace", DEVCHURN,
               registry=reg, assign=assign, scorer=scorer, num_shards=S,
               launch_order="fastest", max_live_models=60)
    assert_same_run(out)
    s = out["port"][1].telemetry.summary()
    assert s["devices_joined"] > 0 and s["devices_left"] > 0
    assert s["trials_preempted"] > 0


def test_sharded_equals_ops_at_four_shards():
    """The port's sharded class decision (S = 4 logical shards on the CPU)
    picks exactly what its ops plane picks at the same shard count."""
    reg = lambda D: D.two_class_registry(2.0, overhead=0.5)  # noqa: E731
    runs = {}
    for scorer in ("ops", "sharded"):
        eng = _engine("port", _two_class(2, 2), registry=reg, scorer=scorer,
                      num_shards=4, launch_order="fastest",
                      max_live_models=60)
        runs[scorer] = eng.run(_trace("port", "device_churn_trace",
                                      **DEVCHURN))
    assert _seq(runs["sharded"]) == _seq(runs["ops"])
    assert len(runs["ops"].trials) > 25


@pytest.mark.parametrize("num_devices", [1, 3])
def test_devplane_matches_stream_and_simulate(num_devices):
    from repro_torch.core import simulate, synthetic_matern_problem
    problem = synthetic_matern_problem(num_users=4, num_models_per_user=6,
                                       seed=3)
    sim = simulate(problem, "mdmt", num_devices=num_devices, seed=0,
                   device="cpu")
    fleet = _pod(num_devices)
    sres = TS.StreamEngine(fleet("port"), "mdmt", seed=0, device="cpu").run(
        TS.trace_from_problem(problem))
    dres = _engine("port", fleet, assign="batched").run(
        TS.trace_from_problem(problem))
    assert _seq(dres) == _seq(sres)
    assert [(t.model, t.device) for t in dres.trials] == \
           [(t.model, t.device) for t in sim.trials]


@pytest.mark.parametrize("scorer", ["ops", "sharded"])
def test_batched_equals_sequential_on_homogeneous(scorer):
    runs = {}
    for assign in TD.ASSIGN_MODES:
        eng = _engine("port", _pod(4), assign=assign, scorer=scorer,
                      num_shards=2 if scorer == "sharded" else None)
        runs[assign] = eng.run(_trace("port", "poisson_churn_trace", **CHURN))
    assert _seq(runs["batched"]) == _seq(runs["sequential"])
    assert runs["batched"].policy_launches == \
           runs["sequential"].policy_launches > 0
    assert runs["batched"].decisions < runs["sequential"].decisions


def test_batched_equals_sequential_with_overhead_class():
    def fleet(pkg):
        D = PKG[pkg][1]
        reg = D.DeviceClassRegistry([D.DeviceClass("base", overhead=0.7,
                                                   chip_scale=1.0)])
        return reg.build_fleet([("base", 3)])
    reg = lambda D: D.DeviceClassRegistry(  # noqa: E731
        [D.DeviceClass("base", overhead=0.7, chip_scale=1.0)])
    kw = dict(num_sessions=15, arrival_rate=1.0, seed=2, m_min=2, m_max=8,
              session_scale=20.0)
    runs = [_engine("port", fleet, registry=reg, assign=a).run(
        _trace("port", "poisson_churn_trace", **kw)) for a in TD.ASSIGN_MODES]
    assert _seq(runs[0]) == _seq(runs[1])
    assert_same_run(both(fleet, "poisson_churn_trace", kw, registry=reg))


def _tiny_tenant(S, key, at, m=3, seed=0, cost=None):
    rng = np.random.default_rng(seed)
    K = 0.04 * np.eye(m) + 0.01
    return S.TenantArrive(
        at=at, tenant_key=key, K_block=K, mu0=np.full(m, 0.5),
        cost=np.ones(m) if cost is None else np.asarray(cost, float),
        z_true=rng.uniform(0.2, 0.9, m))


def _fixed(events_fn):
    """A trace maker from ``events_fn(stream_pkg)`` (both packages)."""
    def make(pkg_S, **_):
        return pkg_S.ChurnTrace(events=tuple(sorted(events_fn(pkg_S),
                                                    key=lambda e: e.at)))
    return make


def both_fixed(fleet_fn, events_fn, **engine_kw):
    out = {}
    for pkg in PKG:
        eng = _engine(pkg, fleet_fn, **engine_kw)
        out[pkg] = (eng, eng.run(_fixed(events_fn)(PKG[pkg][0])))
    return out


def test_slice_fail_mid_batched_wave_keeps_batched_equal_sequential():
    def events(S):
        out = [_tiny_tenant(S, 0, 0.0, m=16, cost=np.full(16, 4.0))]
        for at, sid in ((4.0, 1), (8.0, 2), (10.0, 0)):
            out.append(S.SliceFail(at=at, slice_id=sid, downtime=4.0))
        return out
    runs = {a: both_fixed(_pod(4), events, assign=a) for a in TD.ASSIGN_MODES}
    for out in runs.values():
        assert_same_run(out)
    seqs = {a: _seq(runs[a]["port"][1]) for a in runs}
    assert seqs["batched"] == seqs["sequential"]
    assert any(t[-1] is None for t in seqs["batched"])
    assert len({t[0] for t in seqs["batched"] if t[-1] is not None}) == 16


def test_join_leave_preempt_equal_reference():
    def events(S):
        return [_tiny_tenant(S, 0, 0.0, m=10, cost=np.full(10, 3.0)),
                _tiny_tenant(S, 1, 0.5, m=6, seed=1),
                S.DeviceJoin(at=1.0, chips=16, speed=1.0, cls="base"),
                S.DevicePreempt(at=2.0, slice_id=0),
                S.DeviceLeave(at=2.5, slice_id=1),
                S.SliceFail(at=3.0, slice_id=2, downtime=2.0),
                S.DeviceLeave(at=4.0, slice_id=2),
                S.DevicePreempt(at=4.5, slice_id=9)]    # no such slice
    out = both_fixed(_pod(2), events)
    assert_same_run(out)
    eng, res = out["port"]
    s = res.telemetry.summary()
    assert s["devices_joined"] == 1 and s["devices_left"] == 2
    assert s["trials_preempted"] >= 1 and res.num_devices == 1
    # the slice that failed and then left never came back
    assert all(t.device != 2 for t in res.trials if t.start > 3.0)
    obs = {(t.tenant_key, t.local_model) for t in res.trials
           if t.z is not None}
    assert len(obs) == 16


def test_autoscale_equals_reference():
    pol = lambda D: D.AutoscalePolicy(  # noqa: E731
        high_backlog=4.0, low_backlog=1.0, cooldown=0.0, join_class="base",
        min_devices=1, max_devices=4)
    out = both_fixed(_pod(1), lambda S: [_tiny_tenant(
        S, 0, 0.0, m=20, cost=np.full(20, 5.0))], autoscale=pol)
    assert_same_run(out)
    eng, res = out["port"]
    assert eng._autoscale_joins > 0 and eng._autoscale_leaves > 0
    assert {t.local_model for t in res.trials if t.z is not None} == \
           set(range(20))
    with pytest.raises(ValueError):
        _engine("port", _pod(1), autoscale=lambda D: D.AutoscalePolicy(
            join_class="nope"))


def test_quarantine_equals_reference():
    """Hangs under supervision strike a device into quarantine; probation
    re-admits it; the port follows the reference event for event."""
    def events(S):
        out = [_tiny_tenant(S, 0, 0.0, m=12, cost=np.full(12, 2.0))]
        for at in (0.5, 2.5, 4.5, 12.5):
            out.append(S.TrialHang(at=at, slice_id=0))
        out.append(S.TrialPoison(at=6.5, slice_id=1))
        return out
    qp = lambda D: D.QuarantinePolicy(threshold=2, window=20.0,  # noqa: E731
                                      duration=6.0, probation_trials=1)
    out = both_fixed(_pod(3), events, quarantine=qp, timeout_factor=1.5,
                     max_retries=3, retry_backoff=0.5)
    assert_same_run(out)
    eng, res = out["port"]
    s = res.telemetry.summary()
    assert s["devices_quarantined"] >= 1 and s["trials_timed_out"] >= 2
    assert s["observations_rejected"] == 1


def test_speed_oblivious_equals_reference():
    out = both_fixed(_two_class(1, 1, fast_speed=4.0, overhead=0.0),
                     lambda S: [_tiny_tenant(S, 0, 0.0, m=12, seed=5,
                                             cost=np.linspace(2.0, 8.0, 12))],
                     registry=lambda D: D.two_class_registry(4.0),
                     speed_oblivious=True)
    assert_same_run(out)


def test_device_join_speed_must_match_registry():
    reg = lambda D: D.two_class_registry(2.0)  # noqa: E731
    eng = _engine("port", _two_class(1, 1, overhead=0.0), registry=reg)
    with pytest.raises(ValueError, match="disagrees"):
        eng.run(_fixed(lambda S: [S.DeviceJoin(at=0.0, speed=3.0,
                                               cls="fast")])(TS))


# --- crash recovery ----------------------------------------------------------------

def _durable(pkg, fleet_fn, root, tag, crash=None, **kw):
    S = PKG[pkg][0]
    return _engine(pkg, fleet_fn, log=S.EventLog(root / f"log_{tag}"),
                   snapshot_root=str(root / f"snap_{tag}"), snapshot_every=7,
                   fault=None if crash is None else S.FaultInjector(*crash),
                   **kw)


DEV_KW = dict(registry=lambda D: D.two_class_registry(2.0, overhead=0.5),
              launch_order="fastest", max_live_models=40, num_shards=2,
              autoscale=lambda D: D.AutoscalePolicy(
                  high_backlog=6.0, low_backlog=1.0, cooldown=5.0,
                  join_class="fast", min_devices=2, max_devices=8),
              quarantine=lambda D: D.QuarantinePolicy(threshold=2,
                                                      duration=10.0))
DEV_TRACE = dict(DEVCHURN, num_sessions=12)


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("crash", [(5, "before"), (40, "after"),
                                   (23, "mid_launch"), (60, "before")])
def test_crash_anywhere_devplane_resumes_in_the_port(tmp_path, writer, crash):
    """snapshot + replay(suffix) == uninterrupted run, with the snapshot and
    log written by either package and the suffix run by the port."""
    fleet = _two_class(2, 2)
    full_eng = _engine("port", fleet, **DEV_KW)
    full = full_eng.run(_trace("port", "device_churn_trace", **DEV_TRACE))
    assert full_eng.event_index > 60
    eng = _durable(writer, fleet, tmp_path, "w", crash, **DEV_KW)
    S = PKG[writer][0]
    with pytest.raises(S.SimulatedCrash):
        eng.run(_trace(writer, "device_churn_trace", **DEV_TRACE))
    eng.log.close()
    log = TS.EventLog.load(tmp_path / "log_w")
    rec, step = TS.recover(lambda: _engine("port", fleet, **DEV_KW),
                           str(tmp_path / "snap_w"), log)
    res = rec.resume()
    assert _seq(res) == _seq(full)
    assert res.telemetry.summary() == full.telemetry.summary()
    assert res.policy_launches == full.policy_launches
    prefix = [tuple(r) for r in log.processed if r[0] <= step]
    assert TS.first_divergence(full_eng.log.processed,
                               prefix + rec.log.processed) is None
    assert rec._scoring_passes == full_eng._scoring_passes
