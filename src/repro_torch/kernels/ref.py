"""Plain PyTorch versions of the port's kernels.

Each is the simplest formulation that does the kernel's arithmetic step for
step: the same operations in the same order, each rounded on its own (the
kernels are built without multiply-add contraction), and the elementary
functions evaluated in float64 and rounded once (:func:`rn`).  The sums
over tenants and over rows of W run in ascending order, as the kernels'
loops do.  They run on any device: the CPU path of ``ops`` takes them, and
``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

import torch

NEG_LARGE = -1e30
HALF_SQRT2 = 0.7071067811865476
LOG_2PI = 1.8378770664093453
FLT_MIN = torch.finfo(torch.float32).tiny


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush subnormal values to zero.  The reference runs on XLA, which
    flushes subnormal float32 results (CPU and TPU alike); flushing at the
    same steps makes an EI that underflows there underflow here too, so
    ties among exhausted candidates go to the same first index."""
    return torch.where(x.abs() < FLT_MIN, torch.zeros_like(x), x)


def rn(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of float32 ``x``, evaluated in float64 and rounded once to
    float32.  The float32 erf, erfc, exp and sqrt of the CPU and of the
    card differ in the last bit; the rounded float64 value is the same on
    both (and in the kernels), so a decision taken on one device is taken
    on the other."""
    return fn(x.double()).float()


def ndtr(u: torch.Tensor) -> torch.Tensor:
    """Phi(u), with erfc in the tails (Cephes' form, as jax.scipy's ndtr):
    accurate far below the mean, where 0.5 * (1 + erf) is zero."""
    w = u * HALF_SQRT2
    z = w.abs()
    y = torch.where(z < HALF_SQRT2, 1.0 + rn(torch.erf, w),
                    torch.where(w > 0, 2.0 - rn(torch.erfc, z),
                                rn(torch.erfc, z)))
    return ftz(0.5 * y)


def tau(u: torch.Tensor) -> torch.Tensor:
    """tau(u) = u * Phi(u) + phi(u), the EI shape function of Lemma 1."""
    pdf = ftz(rn(torch.exp, (LOG_2PI + u * u) / -2.0))
    return ftz(ftz(u * ndtr(u)) + pdf)


def expected_improvement(mu, sigma, best):
    """E[max(X - best, 0)] for X ~ N(mu, sigma^2), elementwise; exactly
    max(mu - best, 0) where sigma == 0.  Shapes broadcast."""
    positive = sigma > 0
    safe = torch.where(positive, sigma, torch.ones_like(sigma))
    diff = mu - best
    return torch.where(positive, ftz(safe * tau(diff / safe)),
                       torch.clamp_min(diff, 0.0))


def eirate_ref(mu, sigma, best, membership, cost, selected) -> torch.Tensor:
    """(n,) EIrate scores; -1e30 at selected models (the kernel's epilogue)."""
    mu = mu.float()
    ei = expected_improvement(mu[None, :], sigma.float()[None, :],
                              best.float()[:, None])
    ei = torch.where(membership.bool(), ei, torch.zeros_like(ei))
    total = torch.zeros_like(mu)
    for i in range(ei.shape[0]):          # ascending tenants, as the kernel
        total = total + ei[i]
    scores = ftz(total / cost.float())
    return torch.where(selected.bool(), torch.full_like(scores, NEG_LARGE),
                       scores)


def gp_readout_ref(W, alpha, mu0, k_diag, *, emit_sd: bool = False):
    """(mu, var) over the k rows of W, or (mu, sd) with ``emit_sd``.  Rows
    are folded in ascending order, the order ``IncrementalGP`` sums its
    running ``diag_acc`` in."""
    W = W.float()
    alpha = alpha.float()
    dot = torch.zeros(W.shape[1], dtype=torch.float32, device=W.device)
    sq = torch.zeros_like(dot)
    for r in range(W.shape[0]):
        dot = dot + alpha[r] * W[r]
        sq = sq + W[r] * W[r]
    mu = mu0.float() + dot
    var = torch.clamp_min(k_diag.float() - sq, 0.0)
    return (mu, rn(torch.sqrt, var)) if emit_sd else (mu, var)
