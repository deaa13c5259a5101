"""Regret metrics for cumulative global happiness (Section 3.2 + Section 6.1).

  Regret_T            = sum_i  integral_0^T ( z(x_i^*) - z(x_i^*(t)) ) dt
  instantaneous(T)    = mean_i ( z(x_i^*) - z(x_i^*(T)) )

Both are step functions of the observation log, so we integrate exactly
between observation events.  Before a tenant's first observation their gap is
undefined in the paper; following the ease.ml convention we clamp it to
``initial_gap`` = z(x_i^*) - min_{x in L_i} z(x) (the worst the tenant could
be doing), which only shifts all policies by the same warm-up constant.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .scheduler import SimResult


@dataclass(frozen=True)
class RegretCurves:
    times: np.ndarray        # event times, ascending, starting at 0
    instantaneous: np.ndarray  # mean per-user gap right after each time
    cumulative: np.ndarray   # Regret_t at each time
    per_user_best: np.ndarray  # (num_events+1, N) best-so-far trace

    def cumulative_at(self, T: float) -> float:
        """Exact Regret_T for any T >= 0 (step-function integration)."""
        i = int(np.searchsorted(self.times, T, side="right") - 1)
        i = max(i, 0)
        base = self.cumulative[i]
        rate = self.instantaneous[i] * self.per_user_best.shape[1]
        return float(base + rate * (T - self.times[i]))

    def time_to_instantaneous(self, threshold: float) -> float:
        """First time the mean per-user gap drops to <= threshold (inf if never)."""
        hit = np.nonzero(self.instantaneous <= threshold)[0]
        return float(self.times[hit[0]]) if hit.size else float("inf")


def regret_curves(result: SimResult) -> RegretCurves:
    problem = result.problem
    N = problem.num_users
    z_star = problem.best_per_user()
    worst = np.where(problem.membership, problem.z_true[None, :], np.inf).min(axis=1)
    best = worst.copy()  # pessimistic start: clamp pre-observation gap

    obs = result.observations
    times = [0.0]
    inst = [float(np.mean(z_star - best))]
    cum = [0.0]
    traces = [best.copy()]

    t_prev = 0.0
    running = 0.0
    for t, model, z in obs:
        running += float(np.sum(z_star - best)) * (t - t_prev)
        users = np.nonzero(problem.membership[:, model])[0]
        for u in users:
            if z > best[u]:
                best[u] = z
        times.append(t)
        inst.append(float(np.mean(z_star - best)))
        cum.append(running)
        traces.append(best.copy())
        t_prev = t

    return RegretCurves(
        times=np.asarray(times),
        instantaneous=np.asarray(inst),
        cumulative=np.asarray(cum),
        per_user_best=np.stack(traces),
    )


def final_regret(result: SimResult, T: float | None = None) -> float:
    curves = regret_curves(result)
    if T is None:
        T = result.end_time
    return curves.cumulative_at(T)


def speedup_to_threshold(
    baseline: SimResult, ours: SimResult, threshold: float
) -> float:
    """time(baseline reaches threshold) / time(ours reaches threshold)."""
    tb = regret_curves(baseline).time_to_instantaneous(threshold)
    to = regret_curves(ours).time_to_instantaneous(threshold)
    return tb / to
