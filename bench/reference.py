"""Plain reference of the sweep: one episode of the paper's Algorithm 1 at a
time, in NumPy, written from the paper and the configuration's stated
arithmetic, importing nothing of the program under test.

An episode is a problem (tenant-major disjoint candidate sets, a
block-diagonal GP prior, costs), a policy, M devices, a seed and a ground
truth ``z_true``.  Its semantics, as the configuration states them:

* M devices start free at t = 0 and are filled in the order M-1, ..., 0.
  The next event is the device with the earliest finish time, ties to the
  earliest launch.  Times are float32: a trial on a freed device ends at
  ``t + cost[model]``.
* The first launches are the warm-start queue: each tenant's
  ``warm_start`` cheapest models (stable order), tenant by tenant.
* An observation of model i of tenant u extends that tenant's GP by the
  textbook rank-one Cholesky step: with W the rows of L^-1 K[obs, :] and
  alpha = L^-1 (z_obs - mu0_obs), ``l = W[:, i]``, ``d = sqrt(K_ii +
  jitter - l.l)``, the new row ``(K_i - l W) / d`` and ``(z - mu0_i -
  l.alpha) / d``; the posterior is ``mu0 + alpha W`` and ``diag K -
  sum W^2``.  Float32, each product and sum rounded on its own, every sum
  over the observed rows in observation order, square roots (and erf,
  erfc, exp, log) taken in float64 and rounded once.
* EI (Lemma 1) of the tenant's models against its best observed value (a
  floor 5 prior sds below the prior mean before any), subnormal results
  flushed to zero as the configuration's float32 arithmetic does.
* ``mdmt`` launches the first argmax of EI / cost over all models not yet
  launched (Algorithm 1's EIrate rule); ``round_robin`` serves tenants in
  turn, skipping those with no model left, and ``random`` the tenant of the
  first argmax of the step's Gumbels (the ``random`` seed's threefry
  chain, one split a step) among those with models left; both then launch
  the tenant's first argmax of EI.
* Regret (the paper's Sec. 3.2): the mean over tenants of the gap between
  a tenant's best model and its best observed one (the worst in its set
  before any observation), and the integral of its sum over time; in
  float64 here.

``precision="bfloat16"`` is the control: the same episode with the GP
state, EI and EIrate rounded to bfloat16 after every operation (times and
regret as above).
"""

from __future__ import annotations

import multiprocessing
from dataclasses import dataclass

import numpy as np
from scipy import special

from . import threefry

F32 = np.float32
TINY = F32(np.finfo(np.float32).tiny)
HALF_SQRT2 = F32(0.7071067811865476)
LOG_2PI = F32(1.8378770664093453)
FLOOR_SDS = 5.0
NEG_INF = F32(-np.inf)


def _to_bf16(x):
    """Round float32 values to bfloat16 (nearest, ties to even), kept as
    float32."""
    x = np.asarray(x, F32)
    b = x.view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    out = b.astype(np.uint32).view(F32)
    return np.where(np.isfinite(x), out, x)


class Arith:
    """Float32 arithmetic (``r`` is the identity) or bfloat16 (``r`` rounds
    every result)."""

    def __init__(self, precision: str):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(precision)
        self.bf16 = precision == "bfloat16"

    def r(self, x):
        return _to_bf16(x) if self.bf16 else F32(x) if np.ndim(x) == 0 else x

    def rn(self, fn, x):
        """``fn`` in float64, rounded once."""
        return self.r(np.asarray(fn(np.asarray(x, np.float64))).astype(F32))

    def rowsum(self, rows):
        """Sum over the rows, first to last, each add rounded."""
        if not self.bf16:
            # accumulate is strictly sequential; adding +0 makes a -0 sum +0,
            # as a running sum started at 0 is
            return np.add.accumulate(rows, axis=0)[-1] + F32(0)
        acc = np.zeros(rows.shape[1:], F32)
        for row in rows:
            acc = self.r(acc + row)
        return acc

    def ftz(self, x):
        return np.where(np.abs(x) < TINY, F32(0), x).astype(F32)

    def ei(self, mu, sigma, best):
        """E[max(X - best, 0)], X ~ N(mu, sigma^2); max(mu - best, 0) where
        sigma is 0.  tau(u) = u Phi(u) + phi(u), Phi with erfc in the tails."""
        r, rn, ftz = self.r, self.rn, self.ftz
        positive = sigma > 0
        safe = np.where(positive, sigma, F32(1))
        diff = r(mu - best)
        u = r(diff / safe)
        w = r(u * HALF_SQRT2)
        z = np.abs(w)
        y = np.where(z < HALF_SQRT2, r(F32(1) + rn(special.erf, w)),
                     np.where(w > 0, r(F32(2) - rn(special.erfc, z)),
                              rn(special.erfc, z)))
        cdf = ftz(r(F32(0.5) * y))
        pdf = ftz(rn(np.exp, r(r(LOG_2PI + r(u * u)) / F32(-2))))
        tau = ftz(r(ftz(r(u * cdf)) + pdf))
        return np.where(positive, ftz(r(safe * tau)), np.maximum(diff, F32(0))).astype(F32)


@dataclass
class Episode:
    """One episode's outputs, in the program's layout: trials in launch
    order, one event record a step (T = n + M steps)."""

    trial_model: np.ndarray
    trial_user: np.ndarray      # -2 warm start, -1 mdmt, else the tenant
    trial_device: np.ndarray
    trial_start: np.ndarray
    trial_end: np.ndarray
    obs_model: np.ndarray       # -1 where the step observed nothing
    obs_time: np.ndarray
    inst_regret: np.ndarray     # float64
    cum_regret: np.ndarray      # float64
    decisions: int
    end_time: float


def _blocks(membership: np.ndarray) -> tuple[int, int]:
    N, n = membership.shape
    m = n // N
    if m * N != n or not (membership == np.kron(np.eye(N, dtype=bool),
                                                np.ones((1, m), bool))).all():
        raise ValueError("the reference needs tenant-major disjoint candidate sets")
    return N, m


def run_episode(problem: dict, policy: str, num_devices: int, seed: int,
                z_true: np.ndarray, warm_start: int, jitter: float,
                steps: int, precision: str = "float32") -> Episode:
    """One episode of ``steps`` events (the sweep's T = n + its batch's
    largest M; steps past the episode's last event record nothing new)."""
    # the bfloat16 control's Cholesky steps break down (d2 <= 0): its
    # overflows are the control's result, not a fault of the reference
    with np.errstate(all="ignore") if precision == "bfloat16" else np.errstate(under="ignore"):
        return _run_episode(problem, policy, num_devices, seed, z_true,
                            warm_start, jitter, steps, precision)


def _run_episode(problem, policy, num_devices, seed, z_true, warm_start,
                 jitter, steps, precision):
    A = Arith(precision)
    r, rn = A.r, A.rn
    membership = np.asarray(problem["membership"], bool)
    N, m = _blocks(membership)
    n = N * m
    K = np.asarray(problem["K"], np.float64)
    Kb = [r(K[u * m:(u + 1) * m, u * m:(u + 1) * m].astype(F32)) for u in range(N)]
    kdiag = [np.diag(b).copy() for b in Kb]
    mu0 = r(np.asarray(problem["mu0"], np.float64).astype(F32).reshape(N, m))
    cost = np.asarray(problem["cost"], np.float64).astype(F32)
    cost_r = r(cost)
    z = np.asarray(z_true, F32)
    jit = r(F32(jitter))
    prior_sd = float(np.sqrt(np.clip(np.diag(K), 0, None).max()))
    floor = r(F32(float(np.min(problem["mu0"])) - FLOOR_SDS * max(prior_sd, 1e-3)))
    warm = [u * m + int(j) for u in range(N)
            for j in np.argsort(cost[u * m:(u + 1) * m], kind="stable")[:warm_start]]

    # per-tenant GP: Cholesky rows W (k, m) and alpha (k,)
    W = [np.zeros((0, m), F32) for _ in range(N)]
    alpha = [np.zeros(0, F32) for _ in range(N)]
    best_obs = np.full(N, NEG_INF, F32)
    ei = A.ei(mu0, rn(np.sqrt, np.maximum(np.stack(kdiag), F32(0))), floor)
    selected = np.zeros(n, bool)

    # devices: finish time, running model, launch sequence (ties)
    M = num_devices
    dev_end = [F32(0)] * M
    dev_model = [-1] * M
    dev_seq = [-1 - d for d in range(M)]
    counter = 0

    zb = z.astype(np.float64).reshape(N, m)
    z_star = zb.max(1)
    best_true = zb.min(1)
    gsum = float((z_star - best_true).sum())
    cum, t_prev = 0.0, F32(0)
    rr_ptr, pend, decisions = 0, 0, 0
    key = threefry.prng_key(seed)

    trials = []
    obs_model = np.full(steps, -1, np.int64)
    obs_time = np.zeros(steps, F32)
    inst = np.zeros(steps)
    cum_log = np.zeros(steps)

    def fold(u: int, i: int) -> None:
        Wu, au = W[u], alpha[u]
        l = Wu[:, i]
        lw = A.rowsum(r(l[:, None] * Wu)) if len(l) else np.zeros(m, F32)
        la = A.rowsum(r(l * au)[:, None])[0] if len(l) else F32(0)
        d2 = r(r(Kb[u][i, i] + jit) - lw[i])
        d = rn(np.sqrt, max(d2, jit))
        w_new = r((Kb[u][i] - lw) / d)
        a_new = r(r(r(z[u * m + i]) - mu0[u, i]) - la) / d
        W[u] = np.vstack([Wu, w_new[None]])
        alpha[u] = np.append(au, r(a_new)).astype(F32)
        mu = r(mu0[u] + A.rowsum(r(alpha[u][:, None] * W[u])))
        var = np.maximum(r(kdiag[u] - A.rowsum(r(W[u] * W[u]))), F32(0))
        best_obs[u] = max(best_obs[u], r(z[u * m + i]))
        ei[u] = A.ei(mu, rn(np.sqrt, var), best_obs[u])

    for step in range(steps):
        key, sub = threefry.split(key) if policy == "random" else (key, None)
        live = [d for d in range(M) if np.isfinite(dev_end[d])]
        if live:
            d = min(live, key=lambda j: (dev_end[j], dev_seq[j]))
            t, model = dev_end[d], dev_model[d]
            cum += gsum * (float(t) - float(t_prev))
        else:
            t, model = t_prev, -1
        t_prev = t
        if model >= 0:
            u = model // m
            fold(u, model - u * m)
            best_true[u] = max(best_true[u], float(z[model]))
            gsum = float((z_star - best_true).sum())
        obs_model[step], obs_time[step] = model, t
        inst[step], cum_log[step] = gsum / N, cum
        if not live:
            continue

        pending = pend < len(warm)
        decisions += not pending
        if selected.all():
            dev_end[d], dev_model[d], dev_seq[d] = F32(np.inf), -1, np.iinfo(np.int32).max
            continue
        if pending:
            pick, hint = warm[pend], -2
            pend += 1
        elif policy == "mdmt":
            scores = A.ftz(r(ei.reshape(n) / cost_r))
            pick, hint = int(np.argmax(np.where(selected, NEG_INF, scores))), -1
        else:
            free = ~selected.reshape(N, m)
            has_work = free.any(1)
            if policy == "round_robin":
                order = (rr_ptr + np.arange(N)) % N
                u = int(order[np.argmax(has_work[order])])
                rr_ptr = (u + 1) % N
            else:
                g = threefry.gumbel(threefry.random_bits(sub, N))
                u = int(np.argmax(np.where(has_work, g, NEG_INF)))
            pick = u * m + int(np.argmax(np.where(free[u], ei[u], NEG_INF)))
            hint = u
        t_end = F32(t + cost[pick])
        trials.append((pick, hint, d, t, t_end))
        selected[pick] = True
        dev_end[d], dev_model[d], dev_seq[d] = t_end, pick, counter
        counter += 1

    cols = list(zip(*trials)) if trials else [[]] * 5
    return Episode(
        trial_model=np.asarray(cols[0], np.int64), trial_user=np.asarray(cols[1], np.int64),
        trial_device=np.asarray(cols[2], np.int64), trial_start=np.asarray(cols[3], F32),
        trial_end=np.asarray(cols[4], F32), obs_model=obs_model, obs_time=obs_time,
        inst_regret=inst, cum_regret=cum_log, decisions=decisions, end_time=float(t_prev))


_WORKER_PROBLEM: dict = {}


def _init_worker(problem: dict) -> None:
    _WORKER_PROBLEM.update(problem)


def _worker(job: tuple) -> Episode:
    return run_episode(_WORKER_PROBLEM, *job)


def run_many(problem: dict, jobs: list[tuple], workers: int) -> list[Episode]:
    """``run_episode(problem, *job)`` for every job, over a pool of spawned
    processes (in this one for a single worker)."""
    if workers <= 1:
        return [run_episode(problem, *job) for job in jobs]
    pool = multiprocessing.get_context("spawn").Pool(workers, _init_worker, (problem,))
    try:
        return pool.map(_worker, jobs)
    finally:
        pool.close()
        pool.join()
