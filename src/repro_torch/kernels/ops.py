"""Public entry points of the port's kernels.

Dispatch goes by the tensors' device and nothing else: a CPU tensor takes
the plain PyTorch version (``ref``), a CUDA tensor the hand-written kernel,
which launches or raises -- there is no fallback between them.
"""

from __future__ import annotations

from . import ei_score, gp_readout as _gp_readout, ref


def eirate(mu, sigma, best, membership, cost, selected):
    """(n,) EIrate scores, -1e30 at selected models."""
    if mu.device.type == "cpu":
        return ref.eirate_ref(mu, sigma, best, membership, cost, selected)
    return ei_score.eirate(mu, sigma, best, membership, cost, selected)


def eirate_topk(mu, sigma, best, membership, cost, selected, *, k: int = 4):
    """(values (k,), indices (k,)) of the EIrate top-k, equal values in
    ascending index; short vectors pad with (-1e30, 0)."""
    if mu.device.type == "cpu":
        return ref.eirate_topk_ref(mu, sigma, best, membership, cost,
                                   selected, k=k)
    return ei_score.eirate_topk(mu, sigma, best, membership, cost, selected,
                                k=k)


def eirate_classes(mu, sigma, best, membership, cost_matrix, selected):
    """(C, n) class-axis EIrate scores (``cost_matrix`` is (C, n)): the
    tenant EI sum once, divided by every class's cost row; -1e30 at selected
    models and non-finite costs."""
    if mu.device.type == "cpu":
        return ref.eirate_classes_ref(mu, sigma, best, membership,
                                      cost_matrix, selected)
    return ei_score.eirate_classes(mu, sigma, best, membership, cost_matrix,
                                   selected)


def gp_readout(W, alpha, mu0, k_diag, *, emit_sd=False):
    """(mu, var) over the k rows of W (k, n), or (mu, sd) with ``emit_sd``."""
    if W.device.type == "cpu":
        return ref.gp_readout_ref(W, alpha, mu0, k_diag, emit_sd=emit_sd)
    return _gp_readout.gp_readout(W, alpha, mu0, k_diag, emit_sd=emit_sd)
