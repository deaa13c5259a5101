"""The port's core modules against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Problems must be equal array for array; EI functions and GP buffers agree
to float32 tolerance (1e-5: the two frameworks' erfc/exp and matrix-vector
orders differ in the last bits); a decision taken from the same carried-over
state must be the same decision.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from conftest import random_psd  # noqa: E402
from repro.core import ei as jei  # noqa: E402
from repro.core import gp as jgp  # noqa: E402
from repro.core.control_plane import ControlPlane as JPlane  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import ei as tei  # noqa: E402
from repro_torch.core import gp as tgp  # noqa: E402
from repro_torch.core.control_plane import ControlPlane as TPlane  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- tenancy -------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda m: m.synthetic_matern_problem(3, 8, seed=5),
    lambda m: m.synthetic_matern_problem(4, 6, seed=1, cost="lognormal"),
    lambda m: m.azure_problem(0),
    lambda m: m.deeplearning_problem(1),
], ids=["matern", "matern-lognormal", "azure", "deeplearning"])
def test_problems_equal_at_equal_seeds(make):
    a, b = make(J), make(T)
    for field in ("K", "mu0", "z_true", "cost", "membership"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert (a.name, a.model_names, a.user_names) == (b.name, b.model_names, b.user_names)
    np.testing.assert_array_equal(a.best_per_user(), b.best_per_user())
    np.testing.assert_array_equal(J.synthetic_matern_z(5, 7, seed=2),
                                  T.synthetic_matern_z(5, 7, seed=2))
    np.testing.assert_array_equal(J.matern52(np.arange(4.0), np.arange(3.0)),
                                  T.matern52(np.arange(4.0), np.arange(3.0)))


# --- ei ------------------------------------------------------------------------

def _ei_inputs(rng, n=96, N=7):
    mu = rng.standard_normal(n).astype(np.float32)
    sg = np.abs(rng.standard_normal(n)).astype(np.float32)
    sg[:10] = 0.0                              # the sigma = 0 branch
    sg[10:20] = 0.02                           # deep tail: u far below -5
    best = (rng.standard_normal(N) + 0.5).astype(np.float32)
    mem = rng.random((N, n)) < 0.5
    cost = rng.uniform(0.3, 3.0, n).astype(np.float32)
    sel = rng.random(n) < 0.2
    return mu, sg, best, mem, cost, sel


def test_tau_and_expected_improvement_match(rng):
    u = np.linspace(-14, 6, 401).astype(np.float32)
    np.testing.assert_allclose(_np(tei.tau(torch.from_numpy(u))),
                               _np(jei.tau(jnp.asarray(u))), **TOL)
    mu, sg, best, *_ = _ei_inputs(rng)
    got = _np(tei.expected_improvement(torch.from_numpy(mu), torch.from_numpy(sg),
                                       torch.tensor(best[0])))
    want = _np(jei.expected_improvement(jnp.asarray(mu), jnp.asarray(sg), best[0]))
    np.testing.assert_allclose(got, want, **TOL)
    # sigma == 0 is exactly max(mu - best, 0)
    np.testing.assert_array_equal(got[:10], np.maximum(mu[:10] - best[0], 0))


@pytest.mark.parametrize("fn", ["ei_matrix", "ei_total", "eirate_scores",
                                "choose_next", "single_tenant_ei_scores"])
def test_ei_functions_match(rng, fn):
    mu, sg, best, mem, cost, sel = _ei_inputs(rng)
    t = [torch.from_numpy(a) for a in (mu, sg, best, mem, cost, sel)]
    j = [jnp.asarray(a) for a in (mu, sg, best, mem, cost, sel)]
    if fn == "single_tenant_ei_scores":
        got = tei.single_tenant_ei_scores(t[0], t[1], t[2][3], t[3][3], t[5])
        want = jei.single_tenant_ei_scores(j[0], j[1], j[2][3], j[3][3], j[5])
    elif fn in ("ei_matrix", "ei_total"):
        got, want = getattr(tei, fn)(*t[:4]), getattr(jei, fn)(*j[:4])
    else:
        got, want = getattr(tei, fn)(*t), getattr(jei, fn)(*j)
    if fn == "choose_next":
        assert int(got[0]) == int(want[0])
        got, want = got[1], want[1]
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# --- gp ------------------------------------------------------------------------

def test_posterior_masked_matches(rng):
    n = 12
    K = random_psd(rng, n).astype(np.float32)
    mu0 = rng.standard_normal(n).astype(np.float32)
    z = rng.standard_normal(n).astype(np.float32)
    mask = rng.random(n) < 0.5
    got = tgp.posterior_masked(*(torch.from_numpy(a) for a in (K, mu0, z, mask)))
    want = jgp.posterior_masked(*(jnp.asarray(a) for a in (K, mu0, z, mask)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-4)


def test_incremental_gp_matches_after_every_fold(rng):
    n = 24
    K = random_psd(rng, n, scale=0.5)
    mu0 = rng.standard_normal(n) * 0.1
    order = rng.permutation(n)[:16]
    z = rng.standard_normal(n)
    a = jgp.IncrementalGP(K, mu0)
    b = tgp.IncrementalGP(K, mu0, device="cpu")
    for step, idx in enumerate(order.tolist(), 1):
        a.observe(idx, float(z[idx]))
        b.observe(idx, float(z[idx]))
        np.testing.assert_allclose(_np(b._W), _np(a._W), **TOL)
        np.testing.assert_allclose(_np(b._alpha), _np(a._alpha), **TOL)
        np.testing.assert_allclose(_np(b._diag_acc), _np(a._diag_acc), **TOL)
        np.testing.assert_allclose(float(b.last_d2), float(a.last_d2), **TOL)
        for g, w in zip(b.posterior(), a.posterior()):
            np.testing.assert_allclose(_np(g), _np(w), **TOL)
        # the readout's variance is K_diag minus the running diag_acc, bit for bit
        np.testing.assert_array_equal(
            _np(b.posterior()[1]),
            np.maximum(_np(b._kdiag) - _np(b._diag_acc), 0))
        assert b.num_observed == step
    with pytest.raises(ValueError):
        b.observe(int(order[0]), 0.0)
    unobserved = next(i for i in range(n) if i not in set(order.tolist()))
    with pytest.raises(ValueError):
        b.observe(unobserved, float("nan"))


def test_block_gp_matches_after_every_fold():
    prob = J.synthetic_matern_problem(4, 6, seed=2)
    a = jgp.make_gp(prob.K, prob.mu0, prob.membership)
    b = tgp.make_gp(prob.K, prob.mu0, prob.membership, device="cpu")
    assert isinstance(a, jgp.BlockIncrementalGP) and isinstance(b, tgp.BlockIncrementalGP)
    for g, w in zip(b.posterior_sd(), a.posterior_sd()):
        np.testing.assert_array_equal(_np(g), _np(w))     # prior: same float32 cast
    for idx in np.random.default_rng(4).permutation(prob.num_models)[:15].tolist():
        a.observe(idx, float(prob.z_true[idx]))
        b.observe(idx, float(prob.z_true[idx]))
        for g, w in zip(b.posterior_sd(), a.posterior_sd()):
            np.testing.assert_allclose(_np(g), _np(w), **TOL)
    assert b.observed == a.observed and b.num_observed == 15
    with pytest.raises(KeyError):
        b.observe(10_000, 0.0)


def test_make_gp_picks_the_same_engine(rng):
    K = random_psd(rng, 6)
    mem = np.array([[1, 1, 1, 0, 0, 0], [0, 0, 1, 1, 1, 1]], bool)   # overlapping
    assert isinstance(tgp.make_gp(K, np.zeros(6), mem, device="cpu"), tgp.IncrementalGP)
    assert isinstance(jgp.make_gp(K, np.zeros(6), mem), jgp.IncrementalGP)
    prob = J.azure_problem(0)
    assert (tgp.BlockIncrementalGP.blocks_from_membership(prob.K, prob.membership) is not None)


# --- carrying state across -----------------------------------------------------

def _jax_plane_mid_episode(prob, steps, seed=7):
    """A reference plane after ``steps`` launch/observe events of a warm
    start followed by its own mdmt picks."""
    plane = JPlane.from_problem(prob, np.random.default_rng(seed))
    queue = J.warm_start_queue(prob, 2)
    for _ in range(steps):
        m = queue.pop(0) if queue else plane.choose_mdmt()[0]
        plane.record_start(m)
        plane.record_observation(m, float(prob.z_true[m]))
    plane.record_start(int(np.nonzero(~plane.selected)[0][0]))   # one in flight
    plane.rr_pointer = 2
    plane.rng.random(3)                                           # advance the stream
    return plane


def _engine_state(eng):
    return dict(W=np.asarray(eng._W), alpha=np.asarray(eng._alpha),
                diag_acc=np.asarray(eng._diag_acc), k=eng._k, K=np.asarray(eng.K),
                mu0=np.asarray(eng.mu0), observed=list(eng.observed),
                z=[eng._z[i] for i in eng.observed])


def _carry(plane, prob):
    gp = plane.gp
    if isinstance(gp, jgp.BlockIncrementalGP):
        bids = sorted(gp._blocks)
        port_gp = convert.block_gp(
            blocks=[gp._blocks[b] for b in bids],
            engines=[_engine_state(gp._engines[b]) for b in bids],
            mu=gp._mu, var=gp._var, dirty=gp._dirty, observed=gp.observed,
            z=[gp._z[i] for i in gp.observed], device="cpu")
    else:
        port_gp = convert.incremental_gp(**_engine_state(gp), device="cpu")
    return convert.control_plane(
        port_gp, selected=plane.selected, observed=plane.observed, best=plane.best,
        cost=plane.cost, membership=plane.membership, rr_pointer=plane.rr_pointer,
        rng_state=plane.rng.bit_generator.state, no_obs_floor=plane._no_obs_floor,
        device="cpu")


@pytest.mark.parametrize("make,steps", [
    (lambda m: m.synthetic_matern_problem(5, 10, seed=3), 20),
    (lambda m: m.synthetic_matern_problem(1, 30, seed=1), 9),        # dense engine
    (lambda m: m.azure_problem(0), 30),
], ids=["block", "dense", "azure"])
def test_mid_episode_decision_after_carrying_state(make, steps):
    prob = make(J)
    ref = _jax_plane_mid_episode(prob, steps)
    port = _carry(ref, prob)
    assert isinstance(port, TPlane)
    for g, w in zip(port.gp.posterior_sd(), ref.gp.posterior_sd()):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    # the same decisions, in the same order, from the same state and stream
    for _ in range(3):
        for name in ("choose_mdmt", "choose_round_robin", "choose_random"):
            want, got = getattr(ref, name)(), getattr(port, name)()
            assert (got is None) == (want is None)
            if want is not None:
                assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
                for p in (ref, port):
                    p.record_start(int(want[0]))
        assert port.rr_pointer == ref.rr_pointer
    assert port.rng.random() == ref.rng.random()


# --- plane guards ---------------------------------------------------------------

def test_plane_guards():
    prob = T.synthetic_matern_problem(2, 4, seed=0)
    sharded = T.ControlPlane.from_problem(prob, scorer="sharded", device="cpu")
    assert sharded.scorer == "sharded" and sharded.choose_mdmt() == (0, -1)
    # the batched pass: one class at rate 1, overhead 0 heads with the pick
    v, g = sharded.choose_mdmt_batch([1.0, 2.0], [0.0, 0.5], 2)
    assert v.shape == g.shape == (2, 2) and int(g[0, 0]) == 0
    assert (v[:, 0] >= v[:, 1]).all() and np.isfinite(v).all()
    with pytest.raises(ValueError):
        T.ControlPlane.from_problem(prob, scorer="fused", device="cpu")
    plane = T.ControlPlane.from_problem(prob, device="cpu")
    with pytest.raises(ValueError, match="non-finite"):
        plane.record_observation(0, float("nan"))
    assert plane.record_observation(0, 0.5) is True
    assert plane.record_observation(1, 0.1) is False


# --- isolation -------------------------------------------------------------------

def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("*.py")))
    assert len(files) > 10
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
