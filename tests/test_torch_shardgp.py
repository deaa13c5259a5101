"""The port's sharded scoring plane and open-world control plane against
the JAX package, on the CPU.

Layout and compaction are pure Python copies: equal inputs must give equal
outputs.  Decisions must be exactly equal to the reference's: the port's
``scorer="sharded"`` (both score routes, S = 1 and S = 4 logical shards on
the CPU) and ``"ops"`` against the reference's ``"fused"`` at the same
``num_shards`` (the layout of the index space is part of the tie-break
order), through add, retire, compact, reshard and a snapshot carried
across.  Posteriors agree to the GP tolerance of ``test_torch_core.py``
(1e-5).  The reference runs its own multi-shard programs only on forced
host devices in a subprocess; its ``"fused"`` plane runs any ``num_shards``
in process, and at S = 1 its ``"sharded"`` plane is held too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.shardgp as jshard  # noqa: E402
from repro.core import ControlPlane as JPlane  # noqa: E402
from repro.core import synthetic_matern_problem as j_problem  # noqa: E402
from repro.core.tenancy import _matern_block_chol  # noqa: E402
import repro_torch.shardgp as tshard  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import ControlPlane as TPlane  # noqa: E402
from repro_torch.core import synthetic_matern_problem as t_problem  # noqa: E402
from repro_torch.kernels import ei_score, gp_readout  # noqa: E402
from repro_torch.launch.mesh import make_scoring_mesh  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def cpu_path_never_launches():
    """Every plane here lives on the CPU: no kernel launch is counted."""
    before = (ei_score.launches, ei_score.topk_launches, gp_readout.launches)
    yield
    assert (ei_score.launches, ei_score.topk_launches,
            gp_readout.launches) == before


# --- layout and compaction: the port's copies against repro.shardgp -------------

def _allocator_first_fit(m):
    a = m.RangeAllocator(16)
    out = [a.alloc(4), a.alloc(4), a.alloc(8), a.alloc(1)]
    a.free(4, 4)
    out.append(a.alloc(2))
    a.free(0, 4)
    a.free(4, 2)
    out += [a.alloc(8), a.live_slots, list(a._free)]
    return out


def _allocator_bounded(m):
    a = m.RangeAllocator(8)
    out = [a.alloc(4, lo=4, hi=8), a.alloc(4, lo=4, hi=8)]
    a.grow(16)
    return out + [a.capacity, a.alloc(8, lo=8, hi=16), a.free_slots]


def _allocator_double_free(m):
    a = m.RangeAllocator(8)
    out = [a.alloc(4)]
    a.free(0, 4)
    with pytest.raises(ValueError):
        a.free(2, 2)
    return out + [list(a._free)]


def _layout_spans(m):
    lay = m.ShardLayout(num_shards=4, shard_capacity=8)
    starts = [lay.place(key, size) for key, size in enumerate([6, 6, 3, 5])]
    confined = all(lay.shard_of(pl.start) == lay.shard_of(pl.stop - 1)
                   for pl in lay.blocks.values())
    return [starts, confined, lay.live_counts(), lay.imbalance(),
            lay.occupancy()]


def _layout_growth(m):
    lay = m.ShardLayout(num_shards=4, shard_capacity=4)
    starts = [lay.place(key, 3) for key in range(8)]
    confined = all(lay.shard_of(pl.start) == lay.shard_of(pl.stop - 1)
                   for pl in lay.blocks.values())
    return [starts, confined, lay.capacity, lay.shard_capacity]


def _layout_reuse(m):
    lay = m.ShardLayout(num_shards=2, shard_capacity=8)
    s0 = lay.place(0, 4)
    lay.place(1, 4)
    lay.release(0)
    return [s0, lay.place(2, 4), lay.live_counts()]


def _plan_moves(m):
    lay = m.ShardLayout(num_shards=2, shard_capacity=16)
    for key in range(4):
        lay.place(key, 4)
    for key in (1, 3):
        lay.release(key)
    out = [lay.imbalance(), m.plan_moves(lay, set(), 1.05)]
    out.append(m.plan_moves(lay, {0, 2}, 1.05))
    out += [lay.imbalance(), {k: (p.start, p.length)
                              for k, p in lay.blocks.items()}]
    lay2, remap = m.ShardLayout.repartition(lay.blocks, 3)
    return out + [remap, lay2.occupancy()]


@pytest.mark.parametrize("case,expected_head", [
    (_allocator_first_fit, [0, 4, 8, None, 4, 0, 16]),
    (_allocator_bounded, [4, None, 16, 8]),
    (_allocator_double_free, [0]),
    (_layout_spans, [[0, 8, 16, 24], True, [6, 6, 3, 5]]),
    (_layout_growth, [None, True]),
    (_layout_reuse, [0, 0]),
    (_plan_moves, [2.0, []]),
], ids=["allocator-first-fit", "allocator-bounded-grow",
        "allocator-double-free", "layout-spans", "layout-growth",
        "layout-reuse", "plan-moves"])
def test_layout_and_compaction_equal_the_reference(case, expected_head):
    got, want = case(tshard), case(jshard)
    assert got == want
    for g, e in zip(got, expected_head):
        if e is not None:
            assert g == e
    assert tshard.DEFAULT_MAX_IMBALANCE == jshard.DEFAULT_MAX_IMBALANCE


def test_plan_moves_restores_balance_and_respects_pins():
    out = _plan_moves(tshard)
    assert out[1] == [] and len(out[2]) == 1 and out[3] == 1.0


# --- the open-world plane against the reference -----------------------------------

def _k5():
    return _matern_block_chol(5, 0.2, 0.04)[0]


def _dyn_plane(cls, scorer, num_shards, **kw):
    """The reference's ``_dyn_plane`` problem: five identical tenants of
    five models, unit costs, so fresh tenants tie exactly."""
    extra = {} if cls is JPlane else {"device": "cpu"}
    cp = cls(np.random.default_rng(0), scorer=scorer, model_capacity=16,
             tenant_capacity=4, num_shards=num_shards, **kw, **extra)
    for _ in range(5):
        cp.add_tenant(_k5(), np.zeros(5), np.ones(5))
    return cp


def _port_planes(S):
    return {
        "sharded/eirate_topk": _dyn_plane(TPlane, "sharded", S),
        "sharded/eirate": _dyn_plane(TPlane, "sharded", S,
                                     score_kernel="eirate"),
        "ops": _dyn_plane(TPlane, "ops", S),
    }


def _churn(planes, ref, steps=26, reshard_to=2):
    """Steps with observations, a retire, an add with other costs, a
    compaction that moves blocks, a reshard; every plane must pick what the
    reference picks.  Returns the picks."""
    rng = np.random.default_rng(3)
    picks = []
    everyone = [ref, *planes.values()]
    for step in range(steps):
        want = ref.choose_mdmt()
        for name, p in planes.items():
            assert p.choose_mdmt() == want, f"step {step}: {name}"
        if want is None:
            break
        picks.append(want)
        z = float(rng.uniform(0, 1))
        for p in everyone:
            p.record_start(want[0])
            p.record_observation(want[0], z)
        if step == 6:
            for p in everyone:
                p.retire_tenant(0)
                p.retire_tenant(2)
        if step == 8:
            K7 = _matern_block_chol(7, 0.2, 0.04)[0]
            for p in everyone:
                h = p.add_tenant(K7, np.zeros(7), np.linspace(0.5, 2.0, 7))
                assert h.tenant_id == 0
        if step == 10:
            remaps = [p.compact(1.0) for p in everyone]
            for r in remaps[1:]:
                assert r.keys() == remaps[0].keys()
                for t in r:
                    for a, b in zip(r[t], remaps[0][t]):
                        np.testing.assert_array_equal(a, b)
        if step == 16:
            remaps = [p.reshard(reshard_to) for p in everyone]
            assert all(r == remaps[0] for r in remaps)
    for p in planes.values():
        for g, w in zip(p.gp.posterior(), ref.gp.posterior()):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        np.testing.assert_array_equal(p.selected, ref.selected)
        np.testing.assert_array_equal(p.membership, ref.membership)
        assert p.capacity == ref.capacity and p.num_models == ref.num_models
    return picks


@pytest.mark.parametrize("S,reshard_to", [(1, 2), (4, 2), (4, 1)],
                         ids=["S1-to-2", "S4-to-2", "S4-to-1"])
def test_sharded_plane_decides_as_the_reference(S, reshard_to):
    planes = _port_planes(S)
    ref = _dyn_plane(JPlane, "fused", S)
    picks = _churn(planes, ref, reshard_to=reshard_to)
    assert len(picks) >= 20
    if reshard_to == 1:
        # one shard falls back to "ops", as the reference falls back to fused
        assert {p.scorer for p in planes.values()} == {"ops"}
        assert ref.scorer == "fused"
    else:
        assert planes["sharded/eirate"]._sharded.num_shards == reshard_to


def test_sharded_plane_at_one_shard_decides_as_the_reference_sharded():
    planes = {"sharded": _dyn_plane(TPlane, "sharded", 1)}
    ref = _dyn_plane(JPlane, "sharded", 1, score_kernel="xla")
    assert len(_churn(planes, ref, reshard_to=1)) >= 20


def test_compact_moves_posteriors_and_pins_in_flight():
    cp = _dyn_plane(TPlane, "sharded", 4)
    ref = _dyn_plane(JPlane, "fused", 4)
    rng = np.random.default_rng(0)
    for t in range(5):
        g = int(np.nonzero(cp.membership[t])[0][t % 5])
        z = float(rng.uniform(0, 1))
        for p in (cp, ref):
            p.record_start(g)
            p.record_observation(g, z)
    pinned = int(np.nonzero(cp.membership[4])[0][0]) + 1
    for p in (cp, ref):
        p.record_start(pinned)            # tenant 4 has a trial in flight
        p.retire_tenant(2)                # shard 0 keeps two blocks, 3 none
    mu0, var0 = (x.numpy() for x in cp.gp.posterior())
    ref.gp.posterior()                    # flush the reference's cache too
    ids_before = {t: np.nonzero(cp.membership[t])[0] for t in (0, 1, 3, 4)}
    remap, ref_remap = cp.compact(1.0), ref.compact(1.0)
    assert remap.keys() == ref_remap.keys() and remap
    assert 4 not in remap                 # pinned
    mu1, var1 = (x.numpy() for x in cp.gp.posterior())
    for t, old in ids_before.items():
        new = np.nonzero(cp.membership[t])[0]
        if t in remap:
            np.testing.assert_array_equal(remap[t][0], old)
            np.testing.assert_array_equal(remap[t][1], new)
        np.testing.assert_array_equal(mu0[old], mu1[new])
        np.testing.assert_array_equal(var0[old], var1[new])
    # the vacated entries are zeroed, the stale entries of retired blocks kept
    np.testing.assert_array_equal(cp.gp._mu, np.asarray(ref.gp._mu))
    np.testing.assert_array_equal(cp.gp._var, np.asarray(ref.gp._var))
    assert cp.choose_mdmt() == ref.choose_mdmt()


def test_capacity_stats_equal_the_reference():
    cp = _dyn_plane(TPlane, "sharded", 4)
    ref = _dyn_plane(JPlane, "fused", 4)
    for p in (cp, ref):
        g = int(np.nonzero(p.membership[1])[0][2])
        p.record_start(g)
        p.record_observation(g, 0.5)
        p.retire_tenant(3)
    assert cp.capacity_stats() == ref.capacity_stats()
    assert cp.capacity_stats()["gp"]["tenants"][1]["obs"] == 1
    closed = TPlane.from_problem(t_problem(2, 4, seed=0), device="cpu")
    assert closed.capacity_stats()["layout"] is None


def test_snapshot_carried_across_decides_the_same():
    """A reference plane mid-churn, its ``state_snapshot()`` through
    ``convert.control_plane_from_snapshot``: the next decisions are equal,
    and the port's own snapshot round-trips to the same bytes."""
    ref = _dyn_plane(JPlane, "fused", 4)
    rng = np.random.default_rng(5)
    for step in range(9):
        m, _ = ref.choose_mdmt()
        ref.record_start(m)
        if step % 3:                      # some trials stay in flight
            ref.record_observation(m, float(rng.uniform(0, 1)))
        if step == 4:
            ref.retire_tenant(1)
    arrays, meta = ref.state_snapshot()
    ports = [convert.control_plane_from_snapshot(arrays, meta, scorer=sc,
                                                 score_kernel=kern,
                                                 device="cpu")
             for sc, kern in (("sharded", "eirate_topk"),
                              ("sharded", "eirate"), ("ops", "eirate_topk"))]
    for p in ports:
        assert p._layout.num_shards == 4
        mine, _ = p.state_snapshot()
        for key, value in arrays.items():
            np.testing.assert_array_equal(mine[key], np.asarray(value), key)
    for _ in range(10):
        want = ref.choose_mdmt()
        assert all(p.choose_mdmt() == want for p in ports)
        z = float(rng.uniform(0, 1))
        for p in (ref, *ports):
            p.record_start(want[0])
            p.record_observation(want[0], z)
    assert all(p.rng.random() == ref.rng.random() for p in ports[:1])


# --- closed world -----------------------------------------------------------------

@pytest.mark.parametrize("S,kernel", [(1, "eirate_topk"), (4, "eirate_topk"),
                                      (4, "eirate")])
def test_from_problem_sharded_picks_the_ops_sequence(S, kernel):
    prob = t_problem(6, 12, seed=3)
    jprob = j_problem(6, 12, seed=3)
    ops = TPlane.from_problem(prob, device="cpu")
    sh = TPlane.from_problem(prob, scorer="sharded", num_shards=S,
                             score_kernel=kernel, device="cpu")
    ref = JPlane.from_problem(jprob)
    seq = []
    while True:
        want = ref.choose_mdmt()
        assert ops.choose_mdmt() == want and sh.choose_mdmt() == want
        if want is None:
            break
        seq.append(want[0])
        for p in (ops, sh, ref):
            p.record_start(want[0])
            p.record_observation(want[0], float(prob.z_true[want[0]]))
    assert sorted(seq) == list(range(prob.num_models))
    with pytest.raises(RuntimeError, match="open-world"):
        sh.add_tenant(_k5(), np.zeros(5), np.ones(5))


# --- scorer and mesh ----------------------------------------------------------------

def test_scorer_tie_break_topk_and_padding():
    cp = _dyn_plane(TPlane, "sharded", 4)
    assert cp.choose_mdmt() == (0, -1)    # identical tenants: lowest global id
    sc = cp._sharded
    mu, var = cp.gp.posterior_host()
    v, g = sc.decide_topk(mu, np.sqrt(var), cp._best_t, cp.selected)
    assert v.shape == (4,) and g.shape == (4,)
    assert (torch.diff(v) <= 0).all() and g.tolist() == [0, 1, 2, 3]
    # a pool smaller than topk: the real candidates in order, then padding
    sc = tshard.ShardedScorer(2, topk=8, kernel="eirate", device="cpu")
    member = np.zeros((2, 4), bool)
    member[0, :2] = member[1, 2:] = True
    sc.refresh(member, np.ones(4, np.float32))
    args = (np.zeros(4, np.float32), np.ones(4, np.float32),
            np.zeros(2, np.float32), np.zeros(4, bool))
    v, g = sc.decide_topk(*args)
    assert g[:4].tolist() == [0, 1, 2, 3] and (v[4:] == -np.inf).all()
    assert sc.decide(*args) == (0, float(v[0]))
    # exhaustion
    cp.selected[:] = True
    cp._selected_t[:] = True
    assert cp.choose_mdmt() is None


def test_readout_decide_equals_the_unsharded_pick(rng):
    """Readout, score and pick per shard == readout, EIrate and the first
    argmax over the whole vector."""
    from repro_torch.kernels import ops
    k, n, N = 12, 64, 5
    W = torch.from_numpy((rng.standard_normal((k, n)) * 0.3).astype(np.float32))
    alpha = torch.from_numpy(rng.standard_normal(k).astype(np.float32))
    mu0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    kd = (W * W).sum(0) + 1.0
    best = rng.standard_normal(N).astype(np.float32)
    member = rng.random((N, n)) < 0.3
    cost = rng.uniform(0.5, 2.0, n).astype(np.float32)
    sel = rng.random(n) < 0.3
    mu, sd = ops.gp_readout(W, alpha, mu0, kd, emit_sd=True)
    scores = ops.eirate(mu, sd, torch.from_numpy(best), torch.from_numpy(member),
                        torch.from_numpy(cost), torch.from_numpy(sel))
    want = int(torch.argmax(scores))
    for S in (1, 4):
        for kernel in tshard.SCORE_KERNELS:
            sc = tshard.ShardedScorer(S, kernel=kernel, device="cpu")
            sc.refresh(member, cost)
            v, g = sc.readout_decide_topk(W, alpha, mu0, kd, best, sel)
            assert int(g[0]) == want and float(v[0]) == float(scores[want])


def test_mesh_placement_and_route_names():
    assert make_scoring_mesh(4, "cpu") == (torch.device("cpu"),) * 4
    assert make_scoring_mesh(None, "cpu") == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_scoring_mesh(2)
    with pytest.raises(ValueError):
        make_scoring_mesh(0, "cpu")
    assert tshard.SCORING_RULES == {"models": "shard", "tenants": None,
                                    "obs": None}
    for jax_name in jshard.SCORE_KERNELS:
        with pytest.raises(ValueError, match="eirate_topk"):
            tshard.ShardedScorer(1, kernel=jax_name, device="cpu")
    # the per-class decision of the device plane equals the ops plane's
    cp, ops_cp = _dyn_plane(TPlane, "sharded", 2), _dyn_plane(TPlane, "ops", 2)
    for k in (1, 3):
        got = cp.choose_mdmt_batch([1.0, 0.5], [0.0, 0.25], k)
        want = ops_cp.choose_mdmt_batch([1.0, 0.5], [0.0, 0.25], k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
