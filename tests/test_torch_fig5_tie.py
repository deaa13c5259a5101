"""Where the port and the reference part on the Fig-5 episode, and why.

On ``synthetic_matern_problem(50, 50, seed=0)`` (mdmt, M = 4, the paper's
Fig-5 problem) the two packages' event engines take the same 689 trials;
at policy decision 589 (trial 689, t = 172) the reference picks model 1426
and the port model 2345, and the next decision picks the other.  The two
EIrate values differ by 1.1e-4 of their size in the reference's own float32
scores (1,384 float32 ulps), but the Matern blocks are ill-conditioned:
against the same incremental posterior evaluated in float64 each package's
float32 scores of these two models are off by about as much (the port by
more than the gap), and the two posteriors are equally accurate overall.
So the order of the two is not determined at float32 resolution: a tie, not
a fault of the port.  The runs stop just after that decision.
"""

import math

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

DECISION, TRIAL, T_DECIDE = 589, 689, 172.0
REF_PICK, PORT_PICK = 1426, 2345
JITTER = 1e-6                     # both packages' DEFAULT_JITTER


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


def divergence(setattr):
    """Both engines stopped just after the decision, ``setattr`` installing
    the hooks (``monkeypatch.setattr`` in the test): the trial logs, the
    reference's scores at the decision, the port's, and the float64 scores
    and posterior errors the verdict rests on."""
    # the reference: its scorer's inputs and its GP's observations at every
    # policy decision
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

    setattr(jcp.ControlPlane, "choose_mdmt", record_state)
    setattr(jcp, "choose_next_fused", record_inputs)
    problem = J.synthetic_matern_problem(50, 50, seed=0)
    ref = J.simulate(problem, "mdmt", num_devices=4, seed=0, horizon=T_DECIDE + 1e-9)

    port_scores = []
    eirate = tops.eirate

    def record_scores(*args):
        out = eirate(*args)
        port_scores.append((tuple(a.clone() for a in args), out.clone()))
        return out

    setattr(tops, "eirate", record_scores)
    port = T.simulate(T.synthetic_matern_problem(50, 50, seed=0), "mdmt", num_devices=4,
                      seed=0, horizon=T_DECIDE + 1e-9, device="cpu")

    scores = np.asarray(jax.jit(lambda mu, sd, b, m, c, s: jnp.where(
        s, jei.NEG_INF, jei.ei_total(mu, sd, b, m) / c))(
            *(jnp.asarray(a) for a in ref_inputs[DECISION])))
    port_out = port_scores[DECISION][1].numpy()
    observed, z, best = ref_state[DECISION]
    mu64, sd64 = _posterior64(problem, observed, z)
    exact = {j: _eirate64(problem, mu64, sd64, best, j) for j in (REF_PICK, PORT_PICK)}
    mus = {"ref": np.asarray(ref_inputs[DECISION][0]),
           "port": port_scores[DECISION][0][0].numpy()}
    bits = [int(np.float32(scores[j]).view(np.int32)) for j in (REF_PICK, PORT_PICK)]
    return dict(
        ref_models=[t.model for t in ref.trials], port_models=[t.model for t in port.trials],
        ref_hints=[t.user_hint for t in ref.trials],
        starts=(ref.trials[TRIAL].start, port.trials[TRIAL].start),
        ref_order=np.argsort(-scores, kind="stable")[:2].tolist(),
        port_pick=int(np.argmax(port_out)),
        ref_scores=(float(scores[REF_PICK]), float(scores[PORT_PICK])),
        ref_gap=float((scores[REF_PICK] - scores[PORT_PICK]) / scores[REF_PICK]),
        ref_gap_ulps=abs(bits[0] - bits[1]),
        gap64=(exact[REF_PICK] - exact[PORT_PICK]) / exact[REF_PICK],
        err={name: max(abs(float(sc[j]) - exact[j]) / exact[j] for j in exact)
             for name, sc in (("ref", scores), ("port", port_out))},
        worst_mu_err={name: float(np.abs(m - mu64).max()) for name, m in mus.items()},
        typical_mu_err={name: float(np.median(np.abs(m - mu64))) for name, m in mus.items()})


def test_fig5_divergence_is_a_float32_tie(monkeypatch):
    d = divergence(monkeypatch.setattr)
    # the same trials up to the decision, then the two picks swapped
    jm, tm = d["ref_models"], d["port_models"]
    assert jm[:TRIAL] == tm[:TRIAL]
    assert sum(h == -1 for h in d["ref_hints"][:TRIAL]) == DECISION
    assert d["starts"] == (T_DECIDE, T_DECIDE)
    assert (jm[TRIAL], tm[TRIAL]) == (REF_PICK, PORT_PICK)
    assert (jm[TRIAL + 1], tm[TRIAL + 1]) == (PORT_PICK, REF_PICK)
    # the reference's own scores: REF_PICK first, PORT_PICK next, 1.1e-4
    # apart; the port's put PORT_PICK first
    assert d["ref_order"] == [REF_PICK, PORT_PICK] and d["port_pick"] == PORT_PICK
    assert 0 < d["ref_gap"] < 2e-4
    # the same posterior in float64 keeps the reference's order, and the
    # float32 errors of either package's scores of the two models reach the
    # gap between them
    assert d["gap64"] > 0
    assert max(d["err"].values()) > d["gap64"]
    assert d["err"]["ref"] > d["ref_gap"] / 2 and d["err"]["ref"] > 1e-5
    # and the port's posterior is no less accurate than the reference's
    assert d["worst_mu_err"]["port"] < 1.5 * d["worst_mu_err"]["ref"]
    assert d["typical_mu_err"]["port"] < 1.5 * d["typical_mu_err"]["ref"]


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fig5_tie.py:
    # the numbers the test holds, as one JSON line
    import json
    out = divergence(setattr)
    for key in ("ref_models", "port_models", "ref_hints"):
        out[key] = out[key][TRIAL:TRIAL + 2]
    print(json.dumps(out))
