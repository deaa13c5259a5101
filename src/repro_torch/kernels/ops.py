"""Public entry points of the port's kernels.

Dispatch goes by the tensors' device and nothing else: a CPU tensor takes
the plain PyTorch version (``ref``), a CUDA tensor the hand-written kernel,
which launches or raises -- there is no fallback between them.

The flash attention and SSD kernels have no backward pass: on the card
they are ``ctypes`` launches that autograd cannot see.  So both entry
points raise, on either device, when autograd would record them (grad
mode on and an input that requires grad); training takes the models'
plain route (``use_pallas=False``), as the reference's does.  They take
local tensors: handed a DTensor (a sharded model), they raise, since the
sharded route is the plain one, as the reference's dry run is.
"""

from __future__ import annotations

import torch

from . import ei_score, flash_attention as _flash, gp_readout as _gp_readout, ref
from . import ssd as _ssd


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


def _no_dtensor(name: str, *tensors) -> None:
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            f"{name}: the kernel takes local tensors, and an input is a "
            "DTensor; sharded models run the plain route (use_pallas=False)")


def _forward_only(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward pass, and an input requires "
            "grad; train on the plain route (use_pallas=False), or call it "
            "under torch.no_grad()")


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """(B, S, Hq, D) causal GQA attention over q (B, S, Hq, D) and k, v
    (B, S, Hkv, D), in q's dtype; ``window`` keeps keys k > q - window."""
    _no_dtensor("flash_attention", q, k, v)
    _forward_only("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def ssd_mix(x, dt, log_a, b, c, *, chunk: int = 256):
    """The Mamba2 SSD mix y (B, S, H, P) float32, without the D * x term.
    The kernel scans chunks of ``chunk`` steps; the plain version steps the
    recurrence, so ``chunk`` changes only the rounding."""
    _no_dtensor("ssd_mix", x, dt, log_a, b, c)
    _forward_only("ssd_mix", x, dt, log_a, b, c)
    if x.device.type == "cpu":
        return ref.ssd_ref(x, dt, log_a, b, c)
    return _ssd.ssd_mix(x, dt, log_a, b, c, chunk=chunk)
