"""The port's event-driven scheduler against ``repro.core.simulate``, on the CPU.

Decisions must agree exactly: the same trial sequence, trial for trial,
for all three policies (the port scores through ``kernels.ops.eirate``, the
reference through its default fused XLA scorer).  Regret curves follow from
the trial log and must be equal; MIU is numpy in both and must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from conftest import random_psd  # noqa: E402


def _overlapping(m):
    """Dense-prior problem: three tenants with overlapping candidate sets
    over one correlated prior (the dense GP engine)."""
    rng = np.random.default_rng(11)
    n = 14
    K = random_psd(rng, n, scale=0.05)
    mem = np.zeros((3, n), bool)
    mem[0, :7] = mem[1, 5:11] = mem[2, 9:] = True
    return m.Problem(K=K, mu0=np.full(n, 0.5), z_true=rng.uniform(0.3, 0.9, n),
                     cost=rng.uniform(1.0, 4.0, n), membership=mem,
                     name="overlapping-3x14")


PROBLEMS = {
    "verify-3x8": (lambda m: m.synthetic_matern_problem(3, 8, seed=5), 2, None),
    "sched-6x12": (lambda m: m.synthetic_matern_problem(6, 12, seed=3), 3, None),
    "azure": (lambda m: m.azure_problem(0), 3, None),
    "dense-1x40": (lambda m: m.synthetic_matern_problem(1, 40, seed=1), 2, None),
    "overlapping": (_overlapping, 2, None),
    "failures-6x12": (lambda m: m.synthetic_matern_problem(6, 12, seed=3), 2,
                      [(0, 2.5, 1.0), (1, 7.0, 3.0), (0, 15.5, 0.5)]),
}


def _run(m, name, policy, **kw):
    make, M, fails = PROBLEMS[name]
    failures = [m.FailureEvent(*f) for f in fails] if fails else None
    return m.simulate(make(m), policy, num_devices=M, seed=0, failures=failures, **kw)


def _log(res):
    return [(int(t.model), t.user_hint, t.device, t.start, t.end, t.z)
            for t in res.trials]


@pytest.mark.parametrize("policy", T.POLICIES)
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_trial_for_trial_equal(name, policy):
    want = _run(J, name, policy)
    got = _run(T, name, policy, device="cpu")
    assert _log(got) == _log(want)
    assert (got.decisions, got.end_time) == (want.decisions, want.end_time)
    if PROBLEMS[name][2]:
        assert any(t.z is None for t in got.trials)     # failures were exercised
    cj, ct = J.regret_curves(want), T.regret_curves(got)
    for field in ("times", "instantaneous", "cumulative", "per_user_best"):
        np.testing.assert_array_equal(getattr(ct, field), getattr(cj, field))
    assert T.final_regret(got) == J.final_regret(want)


def test_heterogeneous_speeds_and_horizon_equal():
    """Device-aware EIrate, EI / (c / speed), and a horizon cut."""
    kw = dict(num_devices=3, seed=1, horizon=4000.0,
              device_speeds=np.array([1.0, 2.0, 0.5]))
    want = J.simulate(J.azure_problem(1), "mdmt", **kw)
    got = T.simulate(T.azure_problem(1), "mdmt", device="cpu", **kw)
    assert _log(got) == _log(want)
    assert got.end_time < J.simulate(J.azure_problem(1), "mdmt", num_devices=3,
                                     seed=1, device_speeds=kw["device_speeds"]).end_time


@pytest.mark.parametrize("s", [1, 2, 4, 6])
def test_miu_equal(rng, s):
    K = random_psd(rng, 8)
    assert T.miu_s_exact(K, s) == J.miu_s_exact(K, s)
    assert T.miu_greedy(K, s) == J.miu_greedy(K, s)
    assert T.miu_cumulative_exact(K, s) == J.miu_cumulative_exact(K, s)
    assert T.miu_diag_upper_bound(K, s) == J.miu_diag_upper_bound(K, s)
    assert T.miu_diag_paper_bound(K, s) == J.miu_diag_paper_bound(K, s)


def test_miu_equal_on_a_problem_block():
    K = T.synthetic_matern_problem(1, 14, seed=0).K
    assert T.miu_s_exact(K, 3) == J.miu_s_exact(K, 3)


def test_default_device_is_the_card(monkeypatch):
    """device=None means "cuda": without a card it raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = T.synthetic_matern_problem(2, 4, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.simulate(prob, "mdmt", num_devices=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.ControlPlane.from_problem(prob)
    with pytest.raises(RuntimeError):
        T.make_gp(prob.K, prob.mu0, prob.membership)


def test_bad_arguments_raise():
    prob = T.synthetic_matern_problem(2, 4, seed=0)
    with pytest.raises(ValueError, match="policy"):
        T.simulate(prob, "greedy", num_devices=2, device="cpu")
    with pytest.raises(ValueError, match="device_speeds"):
        T.simulate(prob, "mdmt", num_devices=2, device="cpu",
                   device_speeds=np.ones(3))
