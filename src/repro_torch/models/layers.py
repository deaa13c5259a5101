"""Shared neural-net building blocks of the data plane.

Counterpart of ``repro.models.layers``, in the same functional style: every
component is a pair of functions, ``*_specs(cfg)`` -> a tree of
:class:`~repro_torch.models.spec.ParamSpec` and ``*_apply(p, x)`` ->
activations, and parameters are plain nested dicts of tensors.  Norms,
rotary embeddings and the loss compute in float32 where the reference does.
``rules`` (an ``AxisRules`` or None) places the reference's sharding
constraints (``repro_torch.sharding.with_logical_constraint``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding.rules import embedding, on_shards, with_logical_constraint
from .spec import ParamSpec

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_specs(dim: int, *, axis_name: str = "embed") -> dict:
    return {"scale": ParamSpec((dim,), (axis_name,), init="ones")}


def rmsnorm(p: dict | None, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32; with p=None no scale is applied."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    if p is not None:
        y = y * p["scale"].float()
    return y.to(x.dtype)


def nonparametric_layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo: LayerNorm without elementwise affine (arXiv:2402.00838)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(kind: str, p: dict | None, x: torch.Tensor) -> torch.Tensor:
    if kind == "rms":
        return rmsnorm(p, x)
    if kind == "nonparametric":
        return nonparametric_layernorm(x)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Embedding / output head
# ---------------------------------------------------------------------------


def embed_specs(vocab: int, dim: int) -> dict:
    return {"table": ParamSpec((vocab, dim), ("vocab", "embed"), init="normal")}


def embed_lookup(p: dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Rows of the table in ``compute_dtype`` (gathered, then cast: the
    reference's cast-then-gather, without casting the whole table; on
    DTensors the vocab-parallel gather, ``sharding.embedding``)."""
    return embedding(p["table"], tokens.long()).to(compute_dtype)


def unembed_logits(table_or_w: torch.Tensor, x: torch.Tensor,
                   transpose: bool) -> torch.Tensor:
    """x (..., d) -> logits (..., V).  transpose=True for tied embeddings."""
    w = table_or_w.to(x.dtype)
    return x @ (w.T if transpose else w)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def mlp_specs(dim: int, hidden: int) -> dict:
    return {
        "wi_gate": ParamSpec((dim, hidden), ("embed", "mlp"), init="fan_in"),
        "wi_up": ParamSpec((dim, hidden), ("embed", "mlp"), init="fan_in"),
        "wo": ParamSpec((hidden, dim), ("mlp", "embed"), init="fan_in"),
    }


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


_ACTIVATIONS = {"silu": F.silu, "gelu": _gelu_tanh}


def mlp_apply(p: dict, x: torch.Tensor, rules=None,
              activation: str = "silu") -> torch.Tensor:
    dt = x.dtype
    gate = x @ p["wi_gate"].to(dt)
    up = x @ p["wi_up"].to(dt)
    h = _ACTIVATIONS[activation](gate) * up
    h = with_logical_constraint(h, ("batch", "seq", "mlp"), rules)
    return h @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Apply rotary embeddings.  x (..., S, H, D), positions (..., S)."""
    half = x.shape[-1] // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angle = positions[..., :, None, None].float() * freq     # (..., S, 1, half)
    cos, sin = torch.cos(angle), torch.sin(angle)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked softmax cross-entropy (never materialises full (B, S, V) logits)
# ---------------------------------------------------------------------------


def softmax_xent_chunked(
    x: torch.Tensor,            # (B, S, d) final hidden states
    head_w: torch.Tensor,       # (d, V) or (V, d) if tied
    labels: torch.Tensor,       # (B, S) int
    mask: torch.Tensor | None,  # (B, S) bool or None
    tied: bool,
    rules=None,
    chunk: int = 512,
) -> torch.Tensor:
    """Mean token cross-entropy with seq-chunked logits (O(B*chunk*V) peak)."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.bool, device=x.device)
    if pad:
        x = on_shards(F.pad, x, (1,), (0, 0, 0, pad))
        labels = on_shards(F.pad, labels, (1,), (0, pad))
        mask = on_shards(F.pad, mask, (1,), (0, pad))
    w = head_w.to(x.dtype)              # cast once, not per chunk
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, x.shape[1], chunk):
        xb, lb, mb = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk]
        logits = unembed_logits(w, xb, tied)                  # (B, c, V)
        logits = with_logical_constraint(logits, ("batch", "seq", "vocab"), rules)
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lb.long()[..., None])
        # on vocab-sharded logits the gather is a masked partial sum, which
        # DTensor reduces only at the gather's own shape: reduce it there
        gold = with_logical_constraint(gold, ("batch", "seq", None), rules)[..., 0]
        nll = (logz - gold) * mb
        loss_sum = loss_sum + nll.sum()
        count = count + mb.sum()
    return loss_sum / torch.clamp_min(count, 1.0)
