"""Maximum Incremental Uncertainty (MIU) — Section 5.1 of the paper.

  MIU_s(K) = max_{S' subset S, |S|=s, |S'|=s-1} sqrt(det(K_S) / det(K_S'))

By the Schur-complement identity (Lemma 5), det(K_S)/det(K_S') is the
*conditional variance* of the element added to S' — so

  MIU_s(K) = max_{|S'| = s-1, x not in S'} Var(z_x | z_S')^{1/2}

which is how we compute it (an (s-1)-subset enumeration plus a rank-|S'|
solve, instead of an s-subset enumeration with two determinants — same value,
one fewer combinatorial level and numerically far stabler for near-singular
K_S').

Exact enumeration is exponential; it is intended for the test/analysis regime
(n <= ~14).  For larger matrices use :func:`miu_diag_upper_bound` (the bound
used in the paper's convergence discussion) or :func:`miu_greedy` (a lower
bound via greedy subset growth).
"""

from __future__ import annotations

import itertools

import numpy as np


def _cond_var(K: np.ndarray, x: int, subset: tuple[int, ...]) -> float:
    """Var(z_x | z_subset) with zero observation noise."""
    if not subset:
        return float(K[x, x])
    S = list(subset)
    Kss = K[np.ix_(S, S)]
    kxs = K[S, x]
    try:
        sol = np.linalg.solve(Kss, kxs)
    except np.linalg.LinAlgError:
        sol, *_ = np.linalg.lstsq(Kss, kxs, rcond=None)
    return float(max(K[x, x] - kxs @ sol, 0.0))


def miu_s_exact(K: np.ndarray, s: int) -> float:
    """MIU_s(K) by exhaustive enumeration.  1 <= s <= n."""
    K = np.asarray(K, dtype=np.float64)
    n = K.shape[0]
    if not 1 <= s <= n:
        raise ValueError(f"s must be in [1, {n}], got {s}")
    best = 0.0
    for subset in itertools.combinations(range(n), s - 1):
        in_subset = set(subset)
        for x in range(n):
            if x in in_subset:
                continue
            best = max(best, _cond_var(K, x, subset))
    return float(np.sqrt(best))


def miu_cumulative_exact(K: np.ndarray, num_observed: int) -> float:
    """MIU(T, K) = sum_{s=2}^{|L(t)|} MIU_s(K) (Theorem 2), exact."""
    return float(sum(miu_s_exact(K, s) for s in range(2, num_observed + 1)))


def miu_greedy(K: np.ndarray, s: int) -> float:
    """Greedy lower bound on MIU_s: grow S' by repeatedly keeping the subset
    that leaves the *largest* maximal conditional variance."""
    K = np.asarray(K, dtype=np.float64)
    n = K.shape[0]
    subset: tuple[int, ...] = ()
    for _ in range(s - 1):
        # add the element whose removal from the candidate pool hurts least:
        # heuristically, the element most predictable from the current subset.
        remaining = [x for x in range(n) if x not in subset]
        scores = [(_cond_var(K, x, subset), x) for x in remaining]
        subset = subset + (min(scores)[1],)
    remaining = [x for x in range(n) if x not in subset]
    if not remaining:
        return 0.0
    return float(np.sqrt(max(_cond_var(K, x, subset) for x in remaining)))


def miu_diag_paper_bound(K: np.ndarray, num_observed: int) -> float:
    """The bound as *stated* in the paper (Section 5.2):
    MIU(T,K) <= sum of the top |L(t)| values of sqrt(K_ii).

    NOTE (reproduction finding, see EXPERIMENTS.md §Findings): this claim is
    FALSE in general.  Counterexample: variances (1, eps, eps), all
    independent -> MIU_2 = MIU_3 = 1, so MIU(T) = 2, but the top-3 diagonal
    sum is 1 + 2*sqrt(eps) < 2 for small eps.  The issue is that the max in
    MIU_s may select the *same* high-variance variable for every s (any
    subset S' not containing it leaves its conditional variance untouched).
    Kept for reference; use :func:`miu_diag_upper_bound` for a bound that
    actually holds.
    """
    K = np.asarray(K, dtype=np.float64)
    d = np.sqrt(np.clip(np.diag(K), 0.0, None))
    top = np.sort(d)[::-1][:num_observed]
    return float(top.sum())


def miu_diag_upper_bound(K: np.ndarray, num_observed: int) -> float:
    """A correct diagonal bound: MIU_s(K) <= max_i sqrt(K_ii) for every s
    (conditioning cannot raise a marginal variance), hence
    MIU(T,K) = sum_{s=2}^{|L(t)|} MIU_s(K) <= (|L(t)|-1) * max_i sqrt(K_ii).

    All of the paper's convergence corollaries survive with this bound: it
    is O(T) in general (the "not converge" independent case is tight), and
    whenever MIU_s decays (correlated models) MIU(T,K) = o(T) and the
    average regret converges, exactly as discussed in Section 5.2.
    """
    K = np.asarray(K, dtype=np.float64)
    d = np.sqrt(np.clip(np.diag(K), 0.0, None))
    return float(max(num_observed - 1, 0) * d.max()) if d.size else 0.0
