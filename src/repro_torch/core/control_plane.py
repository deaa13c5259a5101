"""The per-event decision core of Algorithm 1, closed-world form.

``ControlPlane`` owns the state Algorithm 1's loop body needs — the GP
posterior, the selected/observed masks, the per-tenant incumbents — and
exposes it as a stepping API:

  * ``record_start(x)`` / ``record_failure(x)`` / ``record_observation(x, z)``
    fold one scheduler event into the state;
  * ``choose_mdmt`` / ``choose_round_robin`` / ``choose_random`` score the
    unselected pool and return the next launch (the EIrate argmax of eq. 6
    for the paper's policy).

Only the closed-world construction (:meth:`ControlPlane.from_problem`,
every tenant known up front) is ported so far.  The one scorer is
``"ops"``: the EIrate pass through ``kernels.ops.eirate`` (the CUDA kernel
on the card, its plain version on the CPU), then the first argmax.

The masks, costs and incumbents are kept twice: as numpy arrays on the host
for the event bookkeeping and as tensors on ``device`` for scoring, with
the same float32 casts as the reference's device mirrors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..kernels import ops
from .ei import single_tenant_ei_scores
from .gp import DEFAULT_JITTER, make_gp
from .tenancy import Problem

SCORERS = ("ops", "sharded")

_FLOOR_SDS = 5.0  # "no observation yet" sits this many prior sds below mu0


def _check_scorer(scorer: str) -> None:
    if scorer == "sharded":
        raise NotImplementedError(
            "scorer='sharded' arrives with the sharded-scorer slice of the "
            "port (ROADMAP.md, slice 4)")
    if scorer not in SCORERS:
        raise ValueError(f"scorer must be one of {SCORERS}, got {scorer!r}")


def _fastest_models(problem: Problem, user: int, count: int) -> list[int]:
    idx = np.nonzero(problem.membership[user])[0]
    order = idx[np.argsort(problem.cost[idx], kind="stable")]
    return list(order[:count])


def no_obs_floor(problem: Problem) -> float:
    """Finite stand-in for "no observation yet": far below any plausible z,
    so unserved tenants dominate the EI sum."""
    prior_sd = float(np.sqrt(np.clip(np.diag(problem.K), 0, None).max()))
    return float(problem.mu0.min()) - _FLOOR_SDS * max(prior_sd, 1e-3)


def warm_start_queue(problem: Problem, warm_start: int) -> list[int]:
    """The initial launch queue: user-major, ``warm_start`` fastest models
    each, deduplicated keeping first occurrence (Section 6.1 protocol).
    ``warm_start=0`` yields Algorithm 1 line 1-2's prior-mean argmax per
    tenant instead."""
    pending: list[int] = []
    seen: set[int] = set()
    for u in range(problem.num_users):
        for m in _fastest_models(problem, u, warm_start):
            if m not in seen:
                seen.add(m)
                pending.append(m)
    if warm_start == 0:
        for u in range(problem.num_users):
            idx = np.nonzero(problem.membership[u])[0]
            m = int(idx[np.argmax(problem.mu0[idx])])
            if m not in seen:
                seen.add(m)
                pending.append(m)
    return pending


class ControlPlane:
    """GP update + EIrate pick, as a stepping API (module docstring)."""

    def __init__(self, gp, *, selected, observed, best, cost, membership,
                 rr_pointer: int, rng: np.random.Generator,
                 no_obs_floor: float, scorer: str = "ops", device=None):
        """Build a plane from its state; :meth:`from_problem` is the usual
        way in, ``convert.control_plane`` the way to carry a plane across."""
        _check_scorer(scorer)
        self.device = resolve(device)
        self.scorer = scorer
        self.gp = gp
        self.rng = rng
        self.rr_pointer = rr_pointer
        self._no_obs_floor = float(no_obs_floor)
        self.selected = np.array(selected, dtype=bool)
        self.observed = np.array(observed, dtype=bool)
        self.cost = np.array(cost, dtype=np.float64)
        self.membership = np.array(membership, dtype=bool)
        self.best = np.array(best, dtype=np.float64)
        dev = self.device
        self._membership_t = torch.tensor(self.membership, device=dev)
        self._cost_t = torch.tensor(self.cost.astype(np.float32), device=dev)
        self._selected_t = torch.tensor(self.selected, device=dev)
        self._best_t = torch.tensor(
            self.best_effective().astype(np.float32), device=dev)

    @classmethod
    def from_problem(cls, problem: Problem, rng: np.random.Generator | None = None,
                     *, jitter: float = DEFAULT_JITTER, scorer: str = "ops",
                     device=None) -> "ControlPlane":
        """Closed-world construction: all tenants at t=0, exact shapes.
        Overlapping candidate sets take the dense GP engine (``make_gp``)."""
        n, N = problem.num_models, problem.num_users
        _check_scorer(scorer)
        device = resolve(device)
        gp = make_gp(problem.K, problem.mu0, problem.membership, jitter,
                     device=device)
        return cls(gp, selected=np.zeros(n, bool), observed=np.zeros(n, bool),
                   best=np.full(N, -np.inf), cost=problem.cost,
                   membership=problem.membership, rr_pointer=0,
                   rng=rng or np.random.default_rng(0),
                   no_obs_floor=no_obs_floor(problem), scorer=scorer,
                   device=device)

    # ---- event steps -------------------------------------------------------

    def best_effective(self) -> np.ndarray:
        return np.where(np.isfinite(self.best), self.best, self._no_obs_floor)

    def record_start(self, model: int) -> None:
        self.selected[model] = True
        self._selected_t[model] = True

    def record_failure(self, model: int) -> None:
        # the model was never observed, so it simply returns to L \ L(t)
        self.selected[model] = False
        self._selected_t[model] = False

    def record_observation(self, model: int, z: float) -> bool:
        """Fold one observation; returns True when it improved at least one
        member tenant's incumbent.  Non-finite ``z`` is rejected: a NaN here
        corrupts the incremental Cholesky and every later decision."""
        if not np.isfinite(z):
            raise ValueError(f"non-finite observation {z!r} for model "
                             f"{model}; poisoned losses must not reach the "
                             f"GP (use record_failure)")
        self.observed[model] = True
        self.gp.observe(model, z)
        improved = False
        for u in np.nonzero(self.membership[:, model])[0]:
            if z > self.best[u] or not np.isfinite(self.best[u]):
                self.best[u] = max(z, self.best[u]) if np.isfinite(self.best[u]) else z
                self._best_t[u] = float(self.best[u])
                improved = True
        return improved

    # ---- policy decisions --------------------------------------------------

    def choose_mdmt(self, device_speed: float = 1.0) -> tuple[int, int] | None:
        if self.selected.all():
            return None
        mu, sd = self.gp.posterior_sd()
        cost = self._cost_t
        if device_speed != 1.0:
            # by a tensor: CUDA divides by a host scalar through its
            # reciprocal, which would round differently from the CPU
            cost = cost / torch.full_like(cost, device_speed)
        scores = ops.eirate(mu, sd, self._best_t, self._membership_t, cost,
                            self._selected_t)
        idx = int(torch.argmax(scores))    # first maximum, as jnp.argmax
        score = float(scores[idx])
        if not np.isfinite(score) or score <= -1e29:
            return None
        return idx, -1

    def _users_with_work(self) -> np.ndarray:
        has_work = (self.membership & ~self.selected[None, :]).any(axis=1)
        return np.nonzero(has_work)[0]

    def _own_gp_ei(self, user: int) -> int | None:
        mu, sd = self.gp.posterior_sd()
        best = self.best[user] if np.isfinite(self.best[user]) else self._no_obs_floor
        scores = single_tenant_ei_scores(
            mu, sd, torch.tensor(best, dtype=torch.float32, device=self.device),
            self._membership_t[user], self._selected_t)
        idx = int(torch.argmax(scores))
        if not np.isfinite(float(scores[idx])):
            return None
        return idx

    def choose_random(self, device_speed: float = 1.0) -> tuple[int, int] | None:
        users = self._users_with_work()
        if users.size == 0:
            return None
        u = int(self.rng.choice(users))
        m = self._own_gp_ei(u)
        return (m, u) if m is not None else None

    def choose_round_robin(self, device_speed: float = 1.0) -> tuple[int, int] | None:
        users = self._users_with_work()
        if users.size == 0:
            return None
        N = self.membership.shape[0]
        for step in range(N):
            u = (self.rr_pointer + step) % N
            if u in users:
                self.rr_pointer = (u + 1) % N
                m = self._own_gp_ei(u)
                if m is not None:
                    return m, u
        return None

    def chooser(self, policy: str):
        """The decision callable for a policy name (``POLICIES``)."""
        return {
            "mdmt": self.choose_mdmt,
            "random": self.choose_random,
            "round_robin": self.choose_round_robin,
        }[policy]
