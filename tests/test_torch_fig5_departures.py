"""The five other Fig-5 episodes that part from the reference, each at its
first departing decision: every one is a float32 near-tie.

The Fig-5 protocol's 25 episodes ((1, 2, 4, 8, 16) devices x seeds 0-4:
``synthetic_matern_problem(50, 50, seed=SEED)``, mdmt on M devices,
simulator seed SEED) run in both packages' event engines on the CPU;
besides the pinned episode of ``test_torch_fig5_tie.py`` (M 4, seed 0),
five part.  For each, both engines run to a horizon just past the first
departing trial, each decision's scorer inputs recorded, and the decision
that made the trial is taken apart: the reference's float32 EIrate scores
of its pick and the port's pick, the port's scores of the same two, and
both against the same incremental posterior and EIrate in float64
(``_posterior64``: the packages' fold, jitter on the pivot, block by block
in observation order).

The verdict is ``near_tie`` when each package's own relative gap between
the two picks is at most the sum of the two packages' relative float32
errors against float64 on these two scores: then float32 arithmetic does
not determine the order, and the departure is no fault of the port.  The
two picks are the two packages' first choices at that decision, the trials
before it equal, and (where the run reaches it) the next decision takes the
other model in each package.

Run as a script it searches each episode's horizon (doubled from 16 until
the sequences part) and prints one JSON line per episode, or per
``M,SEED`` argument:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fig5_departures.py [M,SEED ...]
"""

import json
import math
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import repro.core as J  # noqa: E402
import repro.core.control_plane as jcp  # noqa: E402
from repro.core import ei as jei  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

JITTER = 1e-6                     # both packages' DEFAULT_JITTER
FIRST_HORIZON = 16.0
MAX_HORIZON = 1024.0


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs several test files at once on the
    CPU's cores, where more threads a process only oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _posterior64(problem, observed, z):
    """The packages' incremental Cholesky fold (jitter on the pivot, the
    pivot clamped at the jitter), block by block in observation order, in
    float64: (mu, sd) over all models."""
    K = np.asarray(problem.K, np.float64)
    mu = np.asarray(problem.mu0, np.float64).copy()
    var = np.diag(K).copy()
    for members in np.asarray(problem.membership):
        block = np.nonzero(members)[0]
        local = {int(g): i for i, g in enumerate(block)}
        obs = [g for g in observed if g in local]
        if not obs:
            continue
        Kb = K[np.ix_(block, block)]
        W, alpha = np.zeros((len(obs), len(block))), np.zeros(len(obs))
        for k, g in enumerate(obs):
            i = local[g]
            l = W[:k, i]
            d = math.sqrt(max(Kb[i, i] + JITTER - l @ l, JITTER))
            W[k] = (Kb[i] - l @ W[:k]) / d
            alpha[k] = (z[g] - mu[block[i]] - l @ alpha[:k]) / d
        mu[block] = mu[block] + alpha @ W
        var[block] = np.maximum(np.diag(Kb) - (W * W).sum(0), 0.0)
    return mu, np.sqrt(var)


def _eirate64(problem, mu, sd, best, j):
    u = int(np.nonzero(np.asarray(problem.membership)[:, j])[0][0])
    diff, s = mu[j] - best[u], sd[j]
    t = diff / s
    tau = t * 0.5 * math.erfc(-t / math.sqrt(2)) + math.exp(-t * t / 2) / math.sqrt(2 * math.pi)
    return s * tau / float(np.asarray(problem.cost)[j])


def _runs(M, seed, horizon, setattr):
    """Both engines to ``horizon`` with the decisions recorded: (reference
    result, port result, the reference's scorer inputs and GP state at each
    policy decision, the port's scorer inputs and scores at each)."""
    ref_inputs, ref_state = [], []
    choose, fused = jcp.ControlPlane.choose_mdmt, jcp.choose_next_fused

    def record_state(self, device_speed=1.0):
        ref_state.append((list(self.gp.observed), dict(self.gp._z), self.best.copy()))
        return choose(self, device_speed)

    def record_inputs(*args):
        # copies: the posterior's arrays may share the GP's host buffers,
        # which later folds overwrite
        ref_inputs.append(tuple(np.array(a) for a in args))
        return fused(*args)

    port_scores = []
    eirate = tops.eirate

    def record_scores(*args):
        out = eirate(*args)
        port_scores.append((tuple(a.clone() for a in args), out.clone()))
        return out

    setattr(jcp.ControlPlane, "choose_mdmt", record_state)
    setattr(jcp, "choose_next_fused", record_inputs)
    setattr(tops, "eirate", record_scores)
    try:
        ref = J.simulate(J.synthetic_matern_problem(50, 50, seed=seed), "mdmt",
                         num_devices=M, seed=seed, horizon=horizon)
        port = T.simulate(T.synthetic_matern_problem(50, 50, seed=seed), "mdmt",
                          num_devices=M, seed=seed, horizon=horizon, device="cpu")
    finally:
        setattr(jcp.ControlPlane, "choose_mdmt", choose)
        setattr(jcp, "choose_next_fused", fused)
        setattr(tops, "eirate", eirate)
    return ref, port, ref_inputs, ref_state, port_scores


def departure(M: int, seed: int, setattr=setattr, horizon: float | None = None) -> dict:
    """The first departing decision of episode (M, seed) taken apart (see
    the module's docstring).  ``horizon`` None searches for one."""
    t0 = time.perf_counter()
    h = horizon or FIRST_HORIZON
    while True:
        ref, port, ref_inputs, ref_state, port_scores = _runs(M, seed, h, setattr)
        jm, tm = [t.model for t in ref.trials], [t.model for t in port.trials]
        trial = next((i for i, (a, b) in enumerate(zip(jm, tm)) if a != b), None)
        if trial is not None or horizon is not None or h >= MAX_HORIZON:
            break
        h *= 2
    seconds = time.perf_counter() - t0
    if trial is None:
        return dict(M=M, seed=seed, horizon=h, departs=False, seconds=seconds)
    hints = [t.user_hint for t in ref.trials]
    decision = sum(x == -1 for x in hints[:trial])
    ref_pick, port_pick = jm[trial], tm[trial]
    problem = J.synthetic_matern_problem(50, 50, seed=seed)
    scores = np.asarray(jax.jit(lambda mu, sd, b, m, c, s: jnp.where(
        s, jei.NEG_INF, jei.ei_total(mu, sd, b, m) / c))(
            *(jnp.asarray(a) for a in ref_inputs[decision])))
    port_out = port_scores[decision][1].numpy()
    observed, z, best = ref_state[decision]
    mu64, sd64 = _posterior64(problem, observed, z)
    picks = (ref_pick, port_pick)
    exact = {j: _eirate64(problem, mu64, sd64, best, j) for j in picks}
    err = {name: max(abs(float(sc[j]) - exact[j]) / exact[j] for j in picks)
           for name, sc in (("ref", scores), ("port", port_out))}
    ref_gap = float((scores[ref_pick] - scores[port_pick]) / scores[ref_pick])
    port_gap = float((port_out[port_pick] - port_out[ref_pick]) / port_out[port_pick])
    return dict(
        M=M, seed=seed, horizon=h, departs=True, trial=trial, decision=decision,
        policy_decision=hints[trial] == -1,
        starts=[ref.trials[trial].start, port.trials[trial].start],
        same_before=jm[:trial] == tm[:trial],
        ref_pick=ref_pick, port_pick=port_pick,
        ref_first=int(np.argmax(scores)), port_first=int(np.argmax(port_out)),
        ref_next=jm[trial + 1] if trial + 1 < len(jm) else None,
        port_next=tm[trial + 1] if trial + 1 < len(tm) else None,
        ref_gap=ref_gap, port_gap=port_gap,
        gap64=(exact[ref_pick] - exact[port_pick]) / exact[ref_pick],
        err=err, near_tie=max(ref_gap, port_gap) <= err["ref"] + err["port"],
        seconds=seconds)


# M, seed, the departing trial's start, the trial, its policy decision, the
# reference's pick and the port's
CASES = [
    (8, 4, 16.0, 131, 31, 1263, 2359),
    (2, 2, 101.0, 203, 103, 44, 2477),
    (4, 3, 61.0, 245, 145, 2210, 1285),
    (16, 1, 31.0, 504, 404, 1266, 818),
    (16, 0, 40.0, 643, 543, 143, 1712),
]


@pytest.mark.parametrize("M,seed,start,trial,decision,ref_pick,port_pick", CASES,
                         ids=[f"M{c[0]}-seed{c[1]}" for c in CASES])
def test_first_departure_is_a_float32_near_tie(monkeypatch, M, seed, start, trial,
                                               decision, ref_pick, port_pick):
    d = departure(M, seed, monkeypatch.setattr, horizon=start + 1.0)
    assert (d["trial"], d["decision"]) == (trial, decision)
    assert d["same_before"] and d["policy_decision"]
    assert d["starts"] == [start, start]
    assert (d["ref_pick"], d["port_pick"]) == (ref_pick, port_pick)
    assert (d["ref_first"], d["port_first"]) == (ref_pick, port_pick)
    if d["ref_next"] is not None:
        assert (d["ref_next"], d["port_next"]) == (port_pick, ref_pick)
    assert d["near_tie"], d
    # the gaps are float32-sized: under 2e-3 of the score
    assert 0.0 <= d["ref_gap"] < 2e-3 and 0.0 < d["port_gap"] < 2e-3


if __name__ == "__main__":
    episodes = ([tuple(int(v) for v in a.split(",")) for a in sys.argv[1:]]
                or [c[:2] for c in CASES])
    for M, seed in episodes:
        print(json.dumps(departure(M, seed), default=lambda o: o.item()), flush=True)
