"""The paper's DeepLearning workload (arXiv 1803.06561, Sec. 6.1): tenants
(datasets) x CNN architectures, an accuracy matrix with the published
per-tenant std, log-uniform training costs scaled per dataset, and a prior
(mean and across-architecture covariance) estimated from a held-out set of
prior-fitting tenants; every test tenant gets a copy of that block.

A copy of the generator of the program's ``core/tenancy.py``
(``_ease_ml_matrix``, ``_matrix_to_problem``), in NumPy, plus a vectorised
draw of fresh test-tenant accuracy rows for a sweep's many episodes: the
architectures' skills and the costs stay those of the deployment.
"""

from __future__ import annotations

import numpy as np
import torch


def build(cfg: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    k = len(cfg["models"])
    num_prior, N = cfg["num_prior_users"], cfg["num_test_users"]
    acc_std = cfg["acc_std"]
    lo, hi = cfg["base_accuracy"]
    c_lo, c_hi = cfg["cost_range"]
    difficulty = rng.uniform(lo, hi, size=num_prior + N)
    algo_cost = np.exp(rng.uniform(np.log(c_lo), np.log(c_hi), size=k))
    logc = np.log(algo_cost)
    logc = (logc - logc.mean()) / max(logc.std(), 1e-9)
    skill = 0.6 * acc_std * logc + rng.normal(0.0, acc_std * 0.7, size=k)
    interaction = rng.normal(0.0, acc_std * 0.7, size=(num_prior + N, k))
    acc = np.clip(difficulty[:, None] + skill[None, :] + interaction, *cfg["clip"])

    perm = rng.permutation(num_prior + N)
    prior_acc = acc[perm[:num_prior]]
    mu_algo = prior_acc.mean(axis=0)
    k_algo = np.cov(prior_acc, rowvar=False)
    k_algo += 1e-6 * np.trace(k_algo) / k * np.eye(k)
    size_factor = rng.uniform(*cfg["size_factor"], size=N)
    return dict(K=np.kron(np.eye(N), k_algo), mu0=np.tile(mu_algo, N),
                z_true=acc[perm[num_prior:]].reshape(-1),
                cost=(size_factor[:, None] * algo_cost[None, :]).reshape(-1),
                membership=np.kron(np.eye(N, dtype=bool), np.ones((1, k), bool)),
                skill=skill)


def draw_truth(cfg: dict, problem: dict, count: int, seed: int, device) -> np.ndarray:
    """(count, n) float32: each row N fresh test tenants' accuracies
    (difficulty + the deployment's skills + interaction, clipped)."""
    N, k = cfg["num_test_users"], len(cfg["models"])
    lo, hi = cfg["base_accuracy"]
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=torch.float64, generator=gen, device=device)
    difficulty = lo + (hi - lo) * torch.rand((count, N, 1), **kw)
    interaction = torch.randn((count, N, k), **kw) * (cfg["acc_std"] * 0.7)
    skill = torch.as_tensor(problem["skill"], dtype=torch.float64, device=device)
    acc = (difficulty + skill + interaction).clamp(*cfg["clip"])
    return acc.reshape(count, N * k).float().cpu().numpy()
