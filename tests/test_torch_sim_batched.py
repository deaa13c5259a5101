"""The port's batched sweep engine against ``repro.core.simulate_batch`` and
the port's own event engine, on the CPU.

Every case of ``tests/test_sim_batched.py`` on its problem
(``synthetic_matern_problem(3, 8, seed=5)``): for ``mdmt`` and
``round_robin`` the port's batched episodes equal the reference's batched
episodes and the port's event-driven episodes trial for trial (models,
hints and devices exact; times within 1e-5, as ``assert_episode_matches``
holds them), and the step logs agree with the reference's (regret curves
to float32 rounding: the port sums over tenants as a pairwise tree; step
times and observed models exact; ``decisions`` equal).  The ``random``
baseline draws the reference's threefry stream: its keys, raw bits and
uniforms equal ``jax.random``'s on several keys, its categorical picks
equal ``jax.random.categorical``'s, and its episodes on the Fig. 2 and
Fig. 4 problems equal the reference's trial for trial.  Its Gumbels are
``-log(-log(u))`` with each log in float64 rounded once, where XLA's
float32 log is off by up to an ulp: they are held to 2 float32 ulps of
max(|g|, 1), and a
pick could part from the reference's only where two tenants' Gumbels lie
that close (none does in these episodes).  It is also held to its
invariants, its own determinism and, over 2,000 seeds, to the uniform law
of the first policy pick, in both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import sim_batched  # noqa: E402


def _problem(m):
    return m.synthetic_matern_problem(num_users=3, num_models_per_user=8, seed=5)


def _other(m):
    return m.synthetic_matern_problem(num_users=3, num_models_per_user=8, seed=9)


def _specs(m, rows):
    """EpisodeSpecs of package ``m`` from (policy, M, seed, kwargs) rows;
    ``z="other"`` takes the seed-9 problem's ground truth."""
    out = []
    for policy, M, seed, kw in rows:
        kw = dict(kw)
        if kw.get("z_true") == "other":
            kw["z_true"] = _other(m).z_true
        out.append(m.EpisodeSpec(policy, M, seed, **kw))
    return out


def _pair(rows, warm_start=2, problem=_problem):
    """(reference batch, port batch) of the same specs."""
    want = J.simulate_batch(problem(J), _specs(J, rows), warm_start=warm_start)
    got = T.simulate_batch(problem(T), _specs(T, rows), warm_start=warm_start,
                           device="cpu")
    return want, got


def event_sequence(res):
    return [(t.model, t.user_hint, t.device) for t in res.trials]


def batched_sequence(batch, i):
    n = batch.problem.num_models
    return [(int(batch.trial_model[i, j]), int(batch.trial_user[i, j]),
             int(batch.trial_device[i, j])) for j in range(n)]


def assert_episode_matches(batch, i, res):
    """Trial-for-trial equality with an event-driven episode: models,
    devices and hints exact, times close (the reference test's tolerances)."""
    assert batched_sequence(batch, i) == event_sequence(res)
    np.testing.assert_allclose(
        batch.trial_start[i], [t.start for t in res.trials], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        batch.trial_end[i], [t.end for t in res.trials], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        batch.trial_z[i], [t.z for t in res.trials], rtol=1e-6)


def assert_batches_match(want, got, episodes=None):
    """The port's batch against the reference's on the same specs: trial
    logs, step times and observed models exact (both in float32), regret
    curves within float32 rounding of the sum over tenants, decisions and
    end times equal."""
    for i in range(want.num_episodes) if episodes is None else episodes:
        assert batched_sequence(got, i) == batched_sequence(want, i)
        for key in ("trial_start", "trial_end", "trial_z", "obs_model",
                    "obs_time"):
            np.testing.assert_array_equal(getattr(got, key)[i],
                                          getattr(want, key)[i], err_msg=key)
        np.testing.assert_allclose(got.inst_regret[i], want.inst_regret[i],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got.cum_regret[i], want.cum_regret[i],
                                   rtol=1e-6, atol=1e-6)
        assert got.decisions[i] == want.decisions[i]
        assert got.end_time[i] == want.end_time[i]
    np.testing.assert_allclose(got.inst0, want.inst0, rtol=1e-6)


@pytest.mark.parametrize("policy", ["mdmt", "round_robin"])
def test_matches_event_engine(policy):
    want, got = _pair([(policy, 2, 0, {})])
    assert_batches_match(want, got)
    assert_episode_matches(got, 0, T.simulate(_problem(T), policy, 2, seed=0,
                                              device="cpu"))


@pytest.mark.parametrize("policy", ["mdmt", "round_robin"])
def test_matches_event_engine_no_warm_start(policy):
    """Algorithm 1 line 1-2 initialization (prior-mean argmax per tenant)."""
    want, got = _pair([(policy, 2, 0, {})], warm_start=0)
    assert_batches_match(want, got)
    assert_episode_matches(got, 0, T.simulate(_problem(T), policy, 2, seed=0,
                                              warm_start=0, device="cpu"))


def test_heterogeneous_device_speeds():
    """Device-aware EIrate: durations scale by speed, sequence still matches."""
    speeds = (1.0, 4.0)
    want, got = _pair([("mdmt", 2, 3, {"device_speeds": speeds})])
    assert_batches_match(want, got)
    assert_episode_matches(got, 0, T.simulate(
        _problem(T), "mdmt", 2, seed=3, device_speeds=np.asarray(speeds),
        device="cpu"))
    per_dev = np.bincount(got.trial_device[0], minlength=2)
    assert per_dev[1] > per_dev[0]


MIXED = [("mdmt", 2, 0, {}), ("round_robin", 2, 1, {}), ("random", 2, 2, {}),
         ("mdmt", 1, 3, {})]


def test_vmap_batch_matches_singleton_runs():
    """A mixed batch == each episode alone (padded with a throwaway episode
    so Mmax is unchanged), and its deterministic episodes == the
    reference's batch and the port's event engine."""
    want, batch = _pair(MIXED)
    assert_batches_match(want, batch, episodes=(0, 1, 3))
    for i, spec in enumerate(_specs(T, MIXED)):
        single = T.simulate_batch(_problem(T), [spec, T.EpisodeSpec("mdmt", 2, 99)],
                                  device="cpu")
        assert batched_sequence(batch, i) == batched_sequence(single, 0)
        np.testing.assert_array_equal(batch.trial_start[i], single.trial_start[0])
        np.testing.assert_array_equal(batch.trial_end[i], single.trial_end[0])
        np.testing.assert_array_equal(batch.inst_regret[i], single.inst_regret[0])
        if spec.policy != "random":
            assert_episode_matches(batch, i, T.simulate(
                _problem(T), spec.policy, spec.num_devices, seed=spec.seed,
                device="cpu"))


def _seven_tenants(m):
    return m.synthetic_matern_problem(num_users=7, num_models_per_user=8, seed=5)


@pytest.mark.parametrize("Mmax", [8, 9, 7], ids=["T%32=0", "T%32=1", "T%32=31"])
def test_step_logs_across_gumbel_chunks(Mmax):
    """A batch of all three policies, heterogeneous speeds and the warm
    start, over T = 56 + Mmax steps (the ``random`` Gumbels are made
    ``_GUMBEL_CHUNK`` = 32 steps at a time, so T ends a chunk, starts one
    or falls one short): every episode equals the reference's batch, the
    deterministic ones the event engine, and each step's column of the
    (B, T) logs holds the observation that step pops, in the event order
    of the episode's own trials."""
    speeds = tuple((1.0, 2.0, 0.5, 4.0)[j % 4] for j in range(Mmax))
    rows = [("mdmt", Mmax, 0, {"device_speeds": speeds}),
            ("round_robin", 3, 1, {"device_speeds": (1.0, 2.0, 0.5)}),
            ("random", 2, 2, {}), ("random", Mmax, 7, {"device_speeds": speeds}),
            ("mdmt", 1, 3, {})]
    want, got = _pair(rows, problem=_seven_tenants)
    n = got.problem.num_models
    assert got.obs_model.shape == (len(rows), n + Mmax)
    assert_batches_match(want, got)
    for i, (policy, M, seed, kw) in enumerate(rows):
        if policy != "random":
            assert_episode_matches(got, i, T.simulate(
                _seven_tenants(T), policy, M, seed=seed, device="cpu",
                device_speeds=np.asarray(kw.get("device_speeds", (1.0,) * M))))
        # the steps pop the trials by (end time, launch order)
        obs = got.obs_model[i] >= 0
        order = np.lexsort((np.arange(n), got.trial_end[i]))
        np.testing.assert_array_equal(got.obs_model[i][obs], got.trial_model[i][order])
        np.testing.assert_array_equal(got.obs_time[i][obs], got.trial_end[i][order])
        assert (np.diff(got.obs_time[i]) >= 0).all()
        assert got.end_time[i] == got.obs_time[i][-1] == got.trial_end[i].max()


@pytest.mark.parametrize("policy", ["mdmt", "round_robin", "random"])
def test_every_model_observed_exactly_once(policy):
    batch = T.simulate_batch(_problem(T), [T.EpisodeSpec(policy, 2, 0)], device="cpu")
    n = batch.problem.num_models
    assert sorted(batch.trial_model[0].tolist()) == list(range(n))
    assert sorted(batch.obs_model[0][batch.obs_model[0] >= 0].tolist()) == list(range(n))


def test_regret_curves_match_host_metrics():
    """In-loop regret integration vs the exact host-side regret.py curves
    (the reference test's tolerances and tie-group rule)."""
    specs = [T.EpisodeSpec("mdmt", 2, 0), T.EpisodeSpec("round_robin", 2, 1)]
    batch = T.simulate_batch(_problem(T), specs, device="cpu")
    for i in range(len(specs)):
        curves = T.regret_curves(batch.episode_result(i))
        mask = batch.obs_model[i] >= 0
        times = batch.obs_time[i][mask]
        np.testing.assert_allclose(times, curves.times[1:], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            batch.cum_regret[i][mask], curves.cumulative[1:],
            rtol=1e-3, atol=1e-2)
        last_of_time = np.r_[np.diff(times) > 1e-9, True]
        np.testing.assert_allclose(
            batch.inst_regret[i][mask][last_of_time],
            curves.instantaneous[1:][last_of_time],
            rtol=1e-4, atol=1e-5)


def test_instantaneous_regret_monotone():
    """Best-so-far only improves, so the mean per-user gap never rises."""
    batch = T.simulate_batch(
        _problem(T), [T.EpisodeSpec(p, 2, s) for s in range(2)
                      for p in ("mdmt", "round_robin", "random")], device="cpu")
    for i in range(batch.num_episodes):
        inst = batch.inst_regret[i][batch.obs_model[i] >= 0]
        assert (np.diff(inst) <= 1e-6).all()


def test_per_episode_z_true_override():
    """Many-seed mode: fresh GP sample per episode, shared prior."""
    rows = [("mdmt", 2, 0, {}), ("mdmt", 2, 0, {"z_true": "other"}),
            ("round_robin", 2, 0, {"z_true": "other"})]
    want, got = _pair(rows)
    assert_batches_match(want, got)
    # episodes 1 and 2 behave as if the problem had `other`'s ground truth
    for i, policy in ((1, "mdmt"), (2, "round_robin")):
        assert_episode_matches(got, i, T.simulate(_other(T), policy, 2, seed=0,
                                                  device="cpu"))
    assert batched_sequence(got, 0) != batched_sequence(got, 1)


def test_episode_result_respects_z_override():
    """regret.py metrics on an overridden episode use the override's ground
    truth, and equal the reference's on the same episode."""
    other = _other(T)
    batch = T.simulate_batch(
        _problem(T), [T.EpisodeSpec("mdmt", 2, 0, z_true=other.z_true)], device="cpu")
    res = batch.episode_result(0)
    np.testing.assert_array_equal(res.problem.z_true, other.z_true)
    curves = T.regret_curves(res)
    ref = T.regret_curves(T.simulate(other, "mdmt", num_devices=2, seed=0, device="cpu"))
    np.testing.assert_allclose(curves.cumulative, ref.cumulative, rtol=1e-5)
    assert (curves.instantaneous >= -1e-6).all()
    jb = J.simulate_batch(_problem(J), [J.EpisodeSpec("mdmt", 2, 0, z_true=_other(J).z_true)])
    jcurves = J.regret_curves(jb.episode_result(0))
    np.testing.assert_array_equal(curves.times, jcurves.times)
    np.testing.assert_array_equal(curves.cumulative, jcurves.cumulative)
    np.testing.assert_array_equal(curves.instantaneous, jcurves.instantaneous)


def test_synthetic_matern_z_matches_problem():
    """The cheap many-seed sampler replays the full generator's draw, and
    the reference's."""
    full = T.synthetic_matern_problem(num_users=4, num_models_per_user=6, seed=11)
    z = T.synthetic_matern_z(num_users=4, num_models_per_user=6, seed=11)
    np.testing.assert_array_equal(z, full.z_true)
    np.testing.assert_array_equal(
        z, J.synthetic_matern_z(num_users=4, num_models_per_user=6, seed=11))


@pytest.mark.parametrize("M", [1, 4])
@pytest.mark.parametrize("policy", ["mdmt", "round_robin"])
def test_azure_matches_event_engine(policy, M):
    """On the Azure workload (9 test tenants x 8 models, real costs): the
    port's batch equals the reference's batch and the port's event engine."""
    want, got = _pair([(policy, M, 0, {})], problem=lambda m: m.azure_problem(0))
    assert_batches_match(want, got)
    assert_episode_matches(got, 0, T.simulate(T.azure_problem(0), policy, M, seed=0,
                                              device="cpu"))


# ---- the random baseline -----------------------------------------------------

def test_random_invariants_and_determinism():
    """Each model launched and observed once; each policy pick's hint is a
    tenant that still had work, and the model is that tenant's; the warm
    start first; the same seeds give the same trials, also inside another
    batch."""
    problem = _problem(T)
    N, m = problem.num_users, problem.num_models // problem.num_users
    warm = len(T.warm_start_queue(problem, 2))
    specs = [T.EpisodeSpec("random", M, seed) for M in (1, 2, 3) for seed in range(4)]
    batch = T.simulate_batch(problem, specs, device="cpu")
    for i in range(batch.num_episodes):
        models, hints = batch.trial_model[i], batch.trial_user[i]
        assert sorted(models.tolist()) == list(range(problem.num_models))
        assert (hints[:warm] == -2).all() and (hints[warm:] >= 0).all()
        left = np.ones((N, m), bool)
        for j, (x, u) in enumerate(zip(models.tolist(), hints.tolist())):
            if u >= 0:
                assert left[u].any() and x // m == u, (i, j)
            left[x // m, x % m] = False
    again = T.simulate_batch(problem, specs[::-1] + [T.EpisodeSpec("mdmt", 3, 0)],
                             device="cpu")
    for i in range(len(specs)):
        j = len(specs) - 1 - i
        assert batched_sequence(batch, i) == batched_sequence(again, j)
        np.testing.assert_array_equal(batch.trial_end[i], again.trial_end[j])
    # the stream is the seed's: other seeds give other episodes
    firsts = {tuple(batch.trial_model[i, warm:warm + 4]) for i in range(4)}
    assert len(firsts) > 1


def test_threefry_stream_equals_jax():
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    tiny = np.finfo(np.float32).tiny
    mask = np.arange(37) % 3 == 0
    for seed in (0, 1, 7, 12345, 2**31 + 5):
        key = jax.random.PRNGKey(np.uint32(seed))
        k1, k2 = sim_batched.prng_key(seed)
        assert [int(k1), int(k2)] == np.asarray(key).tolist()
        for _ in range(4):
            key, sub = jax.random.split(key)
            (k1, k2), (s1, s2) = sim_batched.split(k1, k2)
            assert [int(k1), int(k2)] == np.asarray(key).tolist()
            assert [int(s1), int(s2)] == np.asarray(sub).tolist()
            bits = sim_batched.random_bits(torch.tensor(s1), torch.tensor(s2), 37)
            np.testing.assert_array_equal(
                bits.numpy(), np.asarray(jax.random.bits(sub, (37,), jnp.uint32)))
            np.testing.assert_array_equal(
                sim_batched.uniform(bits).numpy(),
                np.asarray(jax.random.uniform(sub, (37,), jnp.float32, tiny, 1.0)))
            g = sim_batched.gumbel(bits).numpy()
            want = np.asarray(jax.random.gumbel(sub, (37,), jnp.float32))
            # the outer log's error is absolute near g = 0: ulps of max(|g|, 1)
            assert np.all(np.abs(g - want) <= 2 * np.spacing(np.maximum(np.abs(want), 1)))
            logits = jnp.where(jnp.asarray(mask), -jnp.inf, 0.0)
            assert int(jax.random.categorical(sub, logits)) == \
                int(np.argmax(np.where(mask, -np.inf, g)))


@pytest.mark.parametrize("M", [1, 4])
def test_random_episodes_equal_reference(M):
    """Every random episode on the Fig. 2 (M = 1) and Fig. 4 (M = 4)
    problems takes the reference's trials: models, hints, devices."""
    for make in ("azure_problem", "deeplearning_problem"):
        rows = [("random", M, seed, {}) for seed in range(3)]
        problem = lambda m, make=make: getattr(m, make)()  # noqa: E731
        want, got = _pair(rows, problem=problem)
        np.testing.assert_array_equal(got.trial_model, want.trial_model)
        np.testing.assert_array_equal(got.trial_user, want.trial_user)
        np.testing.assert_array_equal(got.trial_device, want.trial_device)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_random_first_pick_is_uniform(pkg):
    """At M = 1 the first policy pick comes after the warm start, with all
    three tenants holding work: over 2,000 seeds each tenant's share lies
    within 4 binomial standard deviations of 1/3."""
    seeds = 2000
    m = J if pkg == "reference" else T
    problem = _problem(m)
    kw = {} if pkg == "reference" else {"device": "cpu"}
    batch = m.simulate_batch(problem, [m.EpisodeSpec("random", 1, s) for s in range(seeds)],
                             **kw)
    warm = len(m.warm_start_queue(problem, 2))
    first = batch.trial_user[:, warm]
    assert (batch.trial_user[:, :warm] == -2).all() and (first >= 0).all()
    counts = np.bincount(first, minlength=3)
    p = 1.0 / 3.0
    sd = np.sqrt(seeds * p * (1 - p))
    assert np.all(np.abs(counts - seeds * p) <= 4 * sd), counts


# ---- structure checks --------------------------------------------------------

def _bad_problems(m):
    """(name, problem) pairs that break each structural requirement."""
    good = _problem(m)
    n = good.num_models
    K = np.asarray(good.K)
    overlap = np.ones((2, n), bool)
    unequal = np.zeros((3, n), bool)
    unequal[0, :7], unequal[1, 7:16], unequal[2, 16:] = True, True, True
    shuffled = np.zeros((3, n), bool)
    for i in range(3):
        shuffled[i, [(j * 3 + i) for j in range(8)]] = True
    K_off = K.copy()
    K_off[0, 8] = K_off[8, 0] = 1e-3
    mk = lambda **kw: type(good)(**{**dict(K=good.K, mu0=good.mu0, z_true=good.z_true,  # noqa: E731
                                           cost=good.cost, membership=good.membership),
                                    **kw})
    return {"overlapping": mk(membership=overlap),
            "unequal_sizes": mk(membership=unequal),
            "not_tenant_major": mk(membership=shuffled),
            "not_block_diagonal": mk(K=K_off)}


@pytest.mark.parametrize("case", ["overlapping", "unequal_sizes", "not_tenant_major",
                                  "not_block_diagonal", "no_specs", "z_true_shape"])
def test_rejects_as_reference(case):
    """Each structural check raises ValueError with the reference's message."""
    def run(m, **kw):
        if case == "no_specs":
            return m.simulate_batch(_problem(m), [], **kw)
        if case == "z_true_shape":
            return m.simulate_batch(
                _problem(m), [m.EpisodeSpec("mdmt", 1, 0, z_true=np.zeros(5))], **kw)
        return m.simulate_batch(_bad_problems(m)[case], [m.EpisodeSpec("mdmt", 1, 0)], **kw)

    with pytest.raises(ValueError) as want:
        run(J)
    with pytest.raises(ValueError) as got:
        run(T, device="cpu")
    assert str(got.value) == str(want.value)
    if case not in ("no_specs", "z_true_shape"):
        with pytest.raises(ValueError, match=str(want.value)[:30]):
            sim_batched._block_shape(_bad_problems(T)[case])


@pytest.mark.parametrize("kw", [dict(policy="greedy"), dict(num_devices=0),
                                dict(num_devices=2, device_speeds=(1.0,))])
def test_episode_spec_rejects_as_reference(kw):
    with pytest.raises(ValueError) as want:
        J.EpisodeSpec(**kw)
    with pytest.raises(ValueError) as got:
        T.EpisodeSpec(**kw)
    assert str(got.value) == str(want.value)


def test_needs_a_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.simulate_batch(_problem(T), [T.EpisodeSpec("mdmt", 1, 0)])
