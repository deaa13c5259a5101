"""Expected improvement, multi-tenant EI aggregation, and EIrate.

Implements Lemma 1 and equations (3)-(6) of the paper:

  tau(u)        = u * Phi(u) + phi(u)
  EI_{i,t}(x)   = sigma_t(x) * tau((mu_t(x) - z(x_i*(t))) / sigma_t(x))
  EI_t(x)       = sum_i 1(x in L_i) * EI_{i,t}(x)
  EIrate_t(x)   = EI_t(x) / c(x)
  x_next        = argmax_{x not selected} EIrate_t(x)

Plain functions on tensors; ``membership`` is an (N, n) bool matrix (tenant
i "has" model x).  ``selected`` marks models that are observed *or
currently running* — both are excluded from the argmax.  The arithmetic
(Phi with an erfc tail, subnormals flushed) is the EIrate kernel's
(``kernels/csrc/ei_score.cu``, plain version in ``kernels/ref.py``), whose
entry point ``kernels.ops.eirate`` is what the decision core calls.  These
functions mask with -inf; the kernel path masks with -1e30.
"""

from __future__ import annotations

import torch

from ..kernels.ref import expected_improvement, ftz, tau, topk_first  # noqa: F401

NEG_INF = float("-inf")


def ei_matrix(mu, sigma, best_per_user, membership):
    """(N, n) matrix of 1(x in L_i) * EI_{i,t}(x)."""
    ei = expected_improvement(mu[None, :], sigma[None, :], best_per_user[:, None])
    return torch.where(membership, ei, torch.zeros_like(ei))


def ei_total(mu, sigma, best_per_user, membership):
    """(n,) total EI over tenants — eq. (4)."""
    return ei_matrix(mu, sigma, best_per_user, membership).sum(dim=0)


def eirate_scores(mu, sigma, best_per_user, membership, cost, selected):
    """(n,) EIrate with selected models masked to -inf — eqs. (5)-(6)."""
    scores = ftz(ei_total(mu, sigma, best_per_user, membership) / cost)
    return torch.where(selected, torch.full_like(scores, NEG_INF), scores)


def choose_next(mu, sigma, best_per_user, membership, cost, selected):
    """Returns (argmax index, its EIrate score) as 0-d tensors; the argmax
    takes the first of equal maxima, like ``jnp.argmax``."""
    scores = eirate_scores(mu, sigma, best_per_user, membership, cost, selected)
    idx = torch.argmax(scores)
    return idx, scores[idx]


def eirate_topk_fused(mu, sigma, best_per_user, membership, cost, selected,
                      *, k: int):
    """The same masked EIrate vector as :func:`choose_next`, reduced to its
    top ``min(k, n)`` as ``(values, ids)``, equal values in ascending id
    (``lax.top_k``'s order), so ``ids[0]`` is :func:`choose_next`'s argmax."""
    scores = eirate_scores(mu, sigma, best_per_user, membership, cost, selected)
    return topk_first(scores, min(k, scores.shape[0]))


def eirate_class_scores(mu, sigma, best_per_user, membership, cost_matrix,
                        selected):
    """(C, n) EIrate over (device class x model), the 2-D generalization of
    eqs. (5)-(6) the elastic device plane scores: the tenant EI sum once,
    divided by every class's cost row.  A non-finite cost (the registry's
    memory gate) is a hard exclusion (-inf), not the 0 a division by +inf
    would give; selected models score -inf."""
    total = ei_total(mu, sigma, best_per_user, membership)
    scores = torch.where(torch.isfinite(cost_matrix),
                         ftz(total[None, :] / cost_matrix), NEG_INF)
    return torch.where(selected[None, :], NEG_INF, scores)


def topk_rows_padded(scores, k: int):
    """Per-row top-k of a (C, n) score matrix as ``(values, ids)``, equal
    values in ascending id (one stable sort, ``topk_first``), padded with
    (-inf, id 0) when n < k so the shape is always (C, k)."""
    kk = min(k, scores.shape[1])
    v, i = topk_first(scores, kk)
    if kk < k:
        C, pad = scores.shape[0], k - kk
        v = torch.cat([v, torch.full((C, pad), NEG_INF, dtype=v.dtype,
                                     device=v.device)], dim=1)
        i = torch.cat([i, torch.zeros((C, pad), dtype=i.dtype,
                                      device=i.device)], dim=1)
    return v, i


def choose_topk_classes(mu, sigma, best_per_user, membership, cost_matrix,
                        selected, *, k: int):
    """Per-class EIrate top-k: ``(values (C, k), ids (C, k))``.  Row c's
    order is the sequential argmax-with-masking order (lowest id at equal
    value), which the batched == sequential contract leans on."""
    scores = eirate_class_scores(mu, sigma, best_per_user, membership,
                                 cost_matrix, selected)
    return topk_rows_padded(scores, k)


def single_tenant_ei_scores(mu, sigma, best, member_row, selected):
    """Per-tenant plain GP-EI scores (baselines: each user runs own GP-EI).

    ``best`` is the scalar best-observed value for this tenant; models outside
    the tenant's candidate set or already selected score -inf.
    """
    ei = expected_improvement(mu, sigma, best)
    return torch.where(member_row & ~selected, ei, torch.full_like(ei, NEG_INF))
