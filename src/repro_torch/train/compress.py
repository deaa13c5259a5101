"""Gradient compression with error feedback (distributed-optimization trick).

The port's copy of ``repro.train.compress``.  Where the wire between
groups of cards is much slower than the links inside one, the groups
exchange int8-quantized gradients.  Per-tensor symmetric quantization with
an error-feedback accumulator (Seide et al. / EF-SGD style): the
quantization residual is carried into the next step, so the scheme is
unbiased in the long run and training quality is preserved.

Usage inside a data-parallel step (pseudo):

    q, scale, err = quantize_ef(grad, err)
    torch.distributed.all_reduce(q.to(torch.int32))
    grad = dequantize(q_sum, scale_sum) / num_groups

The codes are the reference's: divide by the scale, round half to even
(``torch.round``, as ``jnp.round``), then clip to [-127, 127].
"""

from __future__ import annotations

import torch

from ..models.spec import tree_leaves, tree_map


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def quantize(x: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor quantization. Returns (int8 codes, float32 scale)."""
    if bits != 8:
        raise ValueError(f"int8 only, got bits={bits}")
    amax = torch.max(torch.abs(x)).to(torch.float32)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantize_ef(x: torch.Tensor, err: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback quantization: returns (codes, scale, new_err).

    new_err = (x + err) - dequantize(codes), carried into the next step.
    """
    comp = x.to(torch.float32) + err
    q, scale = quantize(comp)
    new_err = comp - dequantize(q, scale)
    return q, scale, new_err


def compress_tree(grads, errs):
    """quantize_ef over the tree; returns (codes_tree, scales_tree, new_errs)."""
    flat_g, flat_e = tree_leaves(grads, _is_tensor), tree_leaves(errs, _is_tensor)
    if len(flat_g) != len(flat_e):
        raise ValueError(f"{len(flat_g)} gradient leaves, {len(flat_e)} error leaves")
    out = {id(g): quantize_ef(g, e) for g, e in zip(flat_g, flat_e)}
    return tuple(tree_map(lambda g: out[id(g)][i], grads, _is_tensor) for i in range(3))


def decompress_tree(codes, scales):
    flat_s = tree_leaves(scales, _is_tensor)
    deq = {id(q): dequantize(q, s) for q, s in zip(tree_leaves(codes, _is_tensor), flat_s)}
    return tree_map(lambda q: deq[id(q)], codes, _is_tensor)


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params, _is_tensor)


def wire_bytes_saved(params) -> tuple[int, int]:
    """(float32 bytes, int8 bytes) for one gradient exchange: the 4x win."""
    leaves = tree_leaves(params, _is_tensor)
    n = sum(p.numel() for p in leaves)
    return 4 * n, n + 4 * len(leaves)
