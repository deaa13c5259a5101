"""The paper's Fig. 5 synthetic deployment (arXiv 1803.06561, Sec. 6):
N tenants with m candidate models each, every tenant's qualities a sample
of a zero-mean Matern-5/2 GP on m points of [0, 1], shifted up to be
non-negative; unit costs.

A copy of the generator of the program's ``core/tenancy.py``
(``synthetic_matern_problem``), in NumPy, plus a vectorised draw of fresh
ground truths from the same prior for a sweep's many episodes.
"""

from __future__ import annotations

import numpy as np
import torch


def matern52(x: np.ndarray, length_scale: float, variance: float) -> np.ndarray:
    """Matern nu=5/2 kernel matrix of 1-D points ``x``."""
    r = np.abs(x[:, None] - x[None, :]) / length_scale
    s5 = np.sqrt(5.0) * r
    return variance * (1.0 + s5 + 5.0 * r * r / 3.0) * np.exp(-s5)


def block_prior(cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """(K_block, its Cholesky factor) of one tenant's m models."""
    m = cfg["num_models_per_user"]
    k = matern52(np.linspace(0.0, 1.0, m), cfg["length_scale"], cfg["kernel_variance"])
    k += 1e-10 * np.eye(m)
    return k, np.linalg.cholesky(k)


def build(cfg: dict, seed: int) -> dict:
    """The deployment: block-diagonal prior K (n, n), prior mean, costs,
    tenant-major membership, and one ground truth drawn from ``seed``."""
    N, m = cfg["num_users"], cfg["num_models_per_user"]
    n = N * m
    k_block, chol = block_prior(cfg)
    rng = np.random.default_rng(seed)
    K = np.kron(np.eye(N), k_block)
    samples = [chol @ rng.standard_normal(m) for _ in range(N)]
    z = np.concatenate([s - s.min() for s in samples])
    if cfg["cost"] != "uniform":
        raise ValueError(f"unknown cost model {cfg['cost']!r}")
    return dict(K=K, mu0=np.zeros(n), z_true=z, cost=np.ones(n),
                membership=np.kron(np.eye(N, dtype=bool), np.ones((1, m), bool)),
                chol=chol)


def draw_truth(cfg: dict, problem: dict, count: int, seed: int, device) -> np.ndarray:
    """(count, n) float32 fresh ground truths from the prior, blockwise,
    drawn on ``device`` from ``seed`` in one batched product."""
    N, m = cfg["num_users"], cfg["num_models_per_user"]
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn((count, N, m), dtype=torch.float64, generator=gen, device=device)
    chol = torch.as_tensor(problem["chol"], dtype=torch.float64, device=device)
    s = g @ chol.T
    z = s - s.amin(-1, keepdim=True)
    return z.reshape(count, N * m).float().cpu().numpy()
