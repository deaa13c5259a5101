"""Tenants, candidate sets, and problem instances (Section 3.1 + Section 6.1).

A :class:`Problem` is the full TSHB instance the scheduler consumes:

  * ``K``           (n, n) prior covariance over all models in L
  * ``mu0``         (n,)   prior mean
  * ``z_true``      (n,)   ground-truth performance (revealed on observation)
  * ``cost``        (n,)   run cost c(x) in (virtual) seconds
  * ``membership``  (N, n) bool — tenant i has model x in L_i

The paper's two real workloads (ease.ml traces) are not public, so
:func:`azure_problem` / :func:`deeplearning_problem` regenerate matrices
faithful to every statistic the paper publishes (tenant/model counts,
per-tenant accuracy std 0.12 / 0.04, 8 held-out prior-fitting tenants, two
fastest models as warm start) with fixed seeds.  :func:`synthetic_matern_problem`
reproduces the Fig-5 setup exactly as specified (50 tenants x 50 models,
Matérn nu=5/2, zero mean, samples shifted non-negative).

In the ease.ml setting a "model" is an (algorithm, dataset) pair — running
algorithm j for tenant i is its own arm with its own accuracy — so candidate
sets of distinct tenants are disjoint and K is block-diagonal across tenants,
with the within-tenant block estimated from the held-out tenants.  Cross-
tenant coupling in the scheduler comes from the shared device pool, exactly
as in the paper.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class Problem:
    K: np.ndarray
    mu0: np.ndarray
    z_true: np.ndarray
    cost: np.ndarray
    membership: np.ndarray  # (N, n) bool
    name: str = "problem"
    model_names: tuple[str, ...] = ()
    user_names: tuple[str, ...] = ()

    @property
    def num_users(self) -> int:
        return self.membership.shape[0]

    @property
    def num_models(self) -> int:
        return self.membership.shape[1]

    def best_per_user(self) -> np.ndarray:
        """z(x_i^*) for every tenant — ground-truth optima."""
        masked = np.where(self.membership, self.z_true[None, :], -np.inf)
        return masked.max(axis=1)

    def validate(self) -> None:
        n = self.num_models
        assert self.K.shape == (n, n)
        assert self.mu0.shape == (n,)
        assert self.z_true.shape == (n,)
        assert self.cost.shape == (n,)
        assert (self.cost > 0).all(), "costs must be positive"
        assert self.membership.any(axis=0).all(), "every model belongs to a tenant"
        assert self.membership.any(axis=1).all(), "every tenant has a model"
        # K must be symmetric PSD (up to tolerance).
        assert np.allclose(self.K, self.K.T, atol=1e-8)
        w = np.linalg.eigvalsh(self.K)
        assert w.min() > -1e-6, f"K not PSD: min eig {w.min()}"


# ---------------------------------------------------------------------------
# Matérn 5/2 kernel (Fig 5 synthetic setup)
# ---------------------------------------------------------------------------

def matern52(X: np.ndarray, Y: np.ndarray, length_scale: float = 0.2,
             variance: float = 1.0) -> np.ndarray:
    """Matérn nu=5/2 kernel on 1-D or d-dim inputs. X (a, d), Y (b, d)."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    if Y.ndim == 1:
        Y = Y[:, None]
    d2 = ((X[:, None, :] - Y[None, :, :]) ** 2).sum(-1)
    r = np.sqrt(np.maximum(d2, 0.0)) / length_scale
    s5 = np.sqrt(5.0) * r
    return variance * (1.0 + s5 + 5.0 * r * r / 3.0) * np.exp(-s5)


def _matern_block_chol(
    m: int, length_scale: float, kernel_variance: float
) -> tuple[np.ndarray, np.ndarray]:
    """(K_block, cholesky(K_block)) for one tenant's m-point Matérn prior."""
    xs = np.linspace(0.0, 1.0, m)[:, None]
    K_block = matern52(xs, xs, length_scale, kernel_variance)
    K_block += 1e-10 * np.eye(m)
    return K_block, np.linalg.cholesky(K_block)


def _matern_draw(rng: np.random.Generator, L: np.ndarray) -> np.ndarray:
    """One tenant's GP sample, "shifted upwards to be non-negative"."""
    sample = L @ rng.standard_normal(L.shape[0])
    return sample - sample.min()


def synthetic_matern_z(
    num_users: int = 50,
    num_models_per_user: int = 50,
    seed: int = 0,
    length_scale: float = 0.2,
    kernel_variance: float = 0.04,
) -> np.ndarray:
    """Just the (n,) ground-truth draw of :func:`synthetic_matern_problem`.

    Bit-identical to the z_true that ``synthetic_matern_problem`` produces
    for the same arguments (both go through ``_matern_draw`` with the same
    RNG stream), but skips the O(n^2) prior assembly — many-seed batched
    sweeps only need fresh samples over a shared prior
    (``EpisodeSpec(z_true=...)``).
    """
    rng = np.random.default_rng(seed)
    m = num_models_per_user
    _, L = _matern_block_chol(m, length_scale, kernel_variance)
    z = np.zeros(num_users * m)
    for i in range(num_users):
        z[i * m:(i + 1) * m] = _matern_draw(rng, L)
    return z


def synthetic_matern_problem(
    num_users: int = 50,
    num_models_per_user: int = 50,
    seed: int = 0,
    length_scale: float = 0.2,
    kernel_variance: float = 0.04,
    cost: str | np.ndarray = "uniform",
) -> Problem:
    """Fig-5 synthetic workload: per-tenant GP samples from a Matérn-5/2 prior,
    shifted upward to be non-negative, unit costs."""
    rng = np.random.default_rng(seed)
    m = num_models_per_user
    K_block, L = _matern_block_chol(m, length_scale, kernel_variance)

    n = num_users * m
    K = np.zeros((n, n))
    z = np.zeros(n)
    membership = np.zeros((num_users, n), dtype=bool)
    for i in range(num_users):
        sl = slice(i * m, (i + 1) * m)
        K[sl, sl] = K_block
        z[sl] = _matern_draw(rng, L)
        membership[i, sl] = True

    if isinstance(cost, str):
        if cost == "uniform":
            c = np.ones(n)
        elif cost == "lognormal":
            c = rng.lognormal(mean=0.0, sigma=0.5, size=n)
        else:
            raise ValueError(cost)
    else:
        c = np.asarray(cost, dtype=np.float64)

    return Problem(
        K=K, mu0=np.zeros(n), z_true=z, cost=c, membership=membership,
        name=f"synthetic-matern-{num_users}x{m}",
        model_names=tuple(f"u{i}/m{j}" for i in range(num_users) for j in range(m)),
        user_names=tuple(f"user{i}" for i in range(num_users)),
    )


# ---------------------------------------------------------------------------
# ease.ml-style workloads (Fig 2-4): Azure and DeepLearning
# ---------------------------------------------------------------------------

AZURE_MODELS = (
    "AveragedPerceptron", "BayesPointMachine", "BoostedDecisionTree",
    "DecisionForest", "DecisionJungle", "LogisticRegression",
    "NeuralNetwork", "SVM",
)
DEEPLEARNING_MODELS = (
    "NIN", "GoogLeNet", "ResNet-50", "AlexNet", "BNAlexNet", "ResNet-18",
    "VGG-16", "SqueezeNet",
)


def _ease_ml_matrix(
    rng: np.random.Generator,
    num_users: int,
    model_names: tuple[str, ...],
    acc_std: float,
    base_low: float,
    base_high: float,
    cost_range: tuple[float, float],
) -> tuple[np.ndarray, np.ndarray]:
    """Accuracy matrix (users x models) + per-(algorithm) cost vector.

    Generative model: each dataset has a difficulty level; each algorithm has
    a skill offset plus dataset-algorithm interaction.  The interaction std is
    calibrated so the *per-user across-model accuracy std* matches the
    figure the paper reports (0.12 Azure / 0.04 DeepLearning).
    """
    k = len(model_names)
    difficulty = rng.uniform(base_low, base_high, size=num_users)
    # Algorithm cost: log-uniform over the plausible range, shared across
    # datasets up to a per-dataset size factor.
    algo_cost = np.exp(rng.uniform(np.log(cost_range[0]), np.log(cost_range[1]), size=k))
    # Skill correlates mildly with cost (bigger/slower models tend to be
    # better) — matches the real zoos behind both ease.ml workloads and makes
    # the cheap-models warm start leave a genuine accuracy gap to search.
    logc = np.log(algo_cost)
    logc = (logc - logc.mean()) / max(logc.std(), 1e-9)
    skill = 0.6 * acc_std * logc + rng.normal(0.0, acc_std * 0.7, size=k)
    interaction = rng.normal(0.0, acc_std * 0.7, size=(num_users, k))
    acc = difficulty[:, None] + skill[None, :] + interaction
    acc = np.clip(acc, 0.02, 0.995)
    return acc, algo_cost


def _matrix_to_problem(
    acc: np.ndarray,
    algo_cost: np.ndarray,
    rng: np.random.Generator,
    name: str,
    model_names: tuple[str, ...],
    num_prior_users: int = 8,
) -> Problem:
    """Split users into prior-fitting and test sets, build block-diagonal K.

    Follows the paper's protocol: "randomly select 8 users which we will
    isolate and use to estimate the mean and the covariance matrix of the
    prior ... test using the remaining users."
    """
    num_users_total, k = acc.shape
    perm = rng.permutation(num_users_total)
    prior_users, test_users = perm[:num_prior_users], perm[num_prior_users:]
    prior_acc = acc[prior_users]  # (8, k)
    mu_algo = prior_acc.mean(axis=0)
    K_algo = np.cov(prior_acc, rowvar=False)  # (k, k) across-algorithm covariance
    K_algo += 1e-6 * np.trace(K_algo) / k * np.eye(k)

    N = len(test_users)
    n = N * k
    K = np.zeros((n, n))
    mu0 = np.zeros(n)
    z = np.zeros(n)
    cost = np.zeros(n)
    membership = np.zeros((N, n), dtype=bool)
    size_factor = rng.uniform(0.5, 2.0, size=N)  # per-dataset size scaling
    for i, u in enumerate(test_users):
        sl = slice(i * k, (i + 1) * k)
        K[sl, sl] = K_algo
        mu0[sl] = mu_algo
        z[sl] = acc[u]
        cost[sl] = algo_cost * size_factor[i]
        membership[i, sl] = True

    return Problem(
        K=K, mu0=mu0, z_true=z, cost=cost, membership=membership, name=name,
        model_names=tuple(f"u{i}/{m}" for i in range(N) for m in model_names),
        user_names=tuple(f"user{u}" for u in test_users),
    )


def azure_problem(seed: int = 0) -> Problem:
    """Azure workload: 17 tenants x 8 binary classifiers, per-tenant accuracy
    std 0.12, 8 prior-fitting tenants -> 9 test tenants."""
    rng = np.random.default_rng(1000 + seed)
    acc, cost = _ease_ml_matrix(
        rng, num_users=17, model_names=AZURE_MODELS, acc_std=0.12,
        base_low=0.55, base_high=0.9, cost_range=(30.0, 1200.0))
    return _matrix_to_problem(acc, cost, rng, f"azure-s{seed}", AZURE_MODELS)


def deeplearning_problem(seed: int = 0) -> Problem:
    """DeepLearning workload: 22 tenants x 8 CNN architectures, per-tenant
    accuracy std 0.04, 8 prior-fitting tenants -> 14 test tenants."""
    rng = np.random.default_rng(2000 + seed)
    acc, cost = _ease_ml_matrix(
        rng, num_users=22, model_names=DEEPLEARNING_MODELS, acc_std=0.04,
        base_low=0.6, base_high=0.92, cost_range=(600.0, 21600.0))
    return _matrix_to_problem(acc, cost, rng, f"deeplearning-s{seed}", DEEPLEARNING_MODELS)
