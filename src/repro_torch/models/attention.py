"""Grouped-query attention: the full-sequence forward, prefill with a KV
cache, and one decode step.

Counterpart of ``repro.models.attention``.  ``attention_train`` takes one
of the reference's two routes by ``AttnConfig.use_pallas``: True runs the
flash attention kernel through ``ops.flash_attention`` (on the CPU its
plain version), which has no backward pass and raises under autograd;
False (the default, and the route training differentiates) runs the
reference's plain path, ``_gqa_scores_and_mix`` over blocks of
``q_chunk`` queries.  Prefill always takes the plain path, because it also
emits the ring-buffer cache, and decode is one step against that cache.
Optional per-head RMS q/k-norm (Qwen3) and sliding-window masking
(H2O-Danube3).  ``rules`` places the reference's sharding constraints.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..sharding.rules import (einsum, is_dtensor, on_shards, splittable,
                              with_logical_constraint)
from .layers import rmsnorm, rope
from .spec import ParamSpec


class AttnConfig(NamedTuple):
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    sliding_window: int | None = None
    rope_theta: float = 10000.0
    q_chunk: int = 512
    causal: bool = True
    use_pallas: bool = False
    logits_fp32: bool = True


def attn_specs(cfg: AttnConfig) -> dict:
    d, H, Hkv, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, H, D), ("embed", "heads", "head_dim"), init="fan_in"),
        "wk": ParamSpec((d, Hkv, D), ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wv": ParamSpec((d, Hkv, D), ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wo": ParamSpec((H, D, d), ("heads", "head_dim", "embed"), init="fan_in"),
    }
    if cfg.qk_norm:
        specs["q_norm"] = {"scale": ParamSpec((D,), ("head_dim",), init="ones")}
        specs["k_norm"] = {"scale": ParamSpec((D,), ("head_dim",), init="ones")}
    return specs


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) @ w (d, H, D) -> (B, S, H, D); on DTensors the
    reference's einsum, partitioned by its labels."""
    if is_dtensor(x):
        return einsum("bsd,dhk->bshk", x, w.to(x.dtype))
    d, H, D = w.shape
    return (x @ w.to(x.dtype).reshape(d, H * D)).view(*x.shape[:-1], H, D)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """out (B, S, H, D) @ wo (H, D, d) -> (B, S, d); on DTensors the
    reference's einsum."""
    if is_dtensor(out):
        return einsum("bshk,hkd->bsd", out, wo.to(out.dtype))
    H, D, d = wo.shape
    return out.reshape(*out.shape[:-2], H * D) @ wo.to(out.dtype).reshape(H * D, d)


def _project_qkv(p: dict, x: torch.Tensor, cfg: AttnConfig, positions: torch.Tensor,
                 rules=None):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = with_logical_constraint(q, ("batch", "seq", "act_heads", None), rules)
    k = with_logical_constraint(k, ("batch", "kv_seq", "act_heads", None), rules)
    v = with_logical_constraint(v, ("batch", "kv_seq", "act_heads", None), rules)
    return q, k, v


def _acc_and_neg(cfg: AttnConfig, dtype):
    acc_t = torch.float32 if cfg.logits_fp32 else dtype
    return acc_t, (-1e30 if acc_t == torch.float32 else -3e38)


def _gqa_scores_and_mix(q_blk, k, v, cfg: AttnConfig, q_pos, k_pos, rules=None):
    """q_blk (B, Qb, H, D), k/v (B, S, Hkv, D) -> (B, Qb, H, D)."""
    B, Qb, H, D = q_blk.shape
    # "q_rows": shard the query rows of each chunk over the model axis,
    # for archs whose head counts do not divide it (QROWS_RULES)
    q_blk = with_logical_constraint(q_blk, ("batch", "q_rows", None, None), rules)
    Hkv = k.shape[2]
    qg = splittable(q_blk, 2, Hkv).reshape(B, Qb, Hkv, H // Hkv, D)
    acc_t, neg = _acc_and_neg(cfg, q_blk.dtype)
    scale = 1.0 / math.sqrt(D)
    logits = einsum("bqhgd,bshd->bhgqs", qg, k).to(acc_t) * scale
    mask = torch.ones((Qb, k.shape[1]), dtype=torch.bool, device=q_blk.device)
    if cfg.causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if cfg.sliding_window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - cfg.sliding_window
    logits = torch.where(mask, logits, neg)
    probs = torch.softmax(logits, dim=-1).to(q_blk.dtype)
    out = einsum("bhgqs,bshd->bqhgd", probs, v)
    return out.reshape(B, Qb, H, D)


def chunked_attention(q, k, v, cfg: AttnConfig, positions: torch.Tensor, rules=None):
    """The plain path: (B, S, H, D) attention, ``q_chunk`` query rows at a
    time against every key, so no (S, S) score matrix is materialised."""
    S = q.shape[1]
    Qb = min(cfg.q_chunk, S)
    if S % Qb:
        Qb = S              # irregular length: single query block
    return torch.cat([_gqa_scores_and_mix(q[:, i:i + Qb], k, v, cfg,
                                          positions[i:i + Qb], positions, rules)
                      for i in range(0, S, Qb)], dim=1)


def attention_train(p: dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg: AttnConfig, rules=None) -> torch.Tensor:
    """Full-sequence self-attention: through the flash attention kernel
    with ``cfg.use_pallas``, else the chunked plain path."""
    q, k, v = _project_qkv(p, x, cfg, positions, rules)
    if cfg.use_pallas:
        out = ops.flash_attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window)
    else:
        out = chunked_attention(q, k, v, cfg, positions, rules)
    out = with_logical_constraint(out, ("batch", "seq", "act_heads", None), rules)
    return _out_proj(out, p["wo"])


def attention_train_with_kv(p: dict, x: torch.Tensor, positions: torch.Tensor,
                            cfg: AttnConfig, max_len: int,
                            rules=None) -> tuple[torch.Tensor, dict]:
    """Prefill path: chunked-causal attention that also emits the decode cache.

    The cache is laid out ring-buffer style (position p at slot p % size)
    so that ``attention_decode`` writes continue seamlessly; with a sliding
    window, size == window and only the last window of keys is kept."""
    S = x.shape[1]
    q, k, v = _project_qkv(p, x, cfg, positions, rules)
    y = _out_proj(chunked_attention(q, k, v, cfg, positions, rules), p["wo"])

    size = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    if S >= size:
        # keep the last `size` positions, rotated so position p sits at slot p % size
        ring = lambda t: torch.roll(t[:, S - size:], S % size, dims=1)  # noqa: E731
    else:
        ring = lambda t: F.pad(t, (0, 0, 0, 0, 0, size - S))  # noqa: E731
    k_c, v_c = on_shards(ring, k, (1,)), on_shards(ring, v, (1,))
    length = torch.tensor(S, dtype=torch.int32, device=x.device)
    return y, {"k": k_c, "v": v_c, "length": length}


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_cache, Hkv, D), a ring buffer with a window
    v: torch.Tensor
    length: torch.Tensor     # scalar int32: total tokens written so far


def kv_cache_specs(cfg: AttnConfig, batch: int, max_len: int, dtype) -> KVCache:
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    return KVCache(
        k=ParamSpec(shape, axes, dtype=dtype, init="zeros"),
        v=ParamSpec(shape, axes, dtype=dtype, init="zeros"),
        length=ParamSpec((), (), dtype=torch.int32, init="zeros"),
    )


def attention_decode(p: dict, x: torch.Tensor, cache: KVCache, cfg: AttnConfig,
                     rules=None, write_back: bool = True) -> tuple[torch.Tensor, KVCache]:
    """One decode step, x (B, 1, d): write the new key and value at slot
    length % size of a copy of the cache, attend over the written slots.

    With ``write_back=False`` (the reference's cache-in-carry branch) the
    cache is not copied: the step attends over the stale cache with the
    slot masked out and folds the new token's logit in separately, and the
    returned cache carries only the new-token projections (k and v of shape
    (B, 1, Hkv, D)); the caller writes them into its own cache.  No caller
    in either package takes that branch."""
    B = x.shape[0]
    pos = cache.length
    q, k_new, v_new = _project_qkv(p, x, cfg, pos.reshape(1), rules)
    size = cache.k.shape[1]
    slot = (pos % size).reshape(1).long()
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qg = splittable(q, 2, Hkv).reshape(B, Hkv, H // Hkv, D)
    acc_t, neg = _acc_and_neg(cfg, cache.k.dtype)
    scale = 1.0 / math.sqrt(D)
    idx = torch.arange(size, device=x.device)
    if write_back:
        write = lambda c, new, at: c.index_copy(1, at, new.to(c.dtype))  # noqa: E731
        k = on_shards(write, cache.k, (1,), k_new, slot)
        v = on_shards(write, cache.v, (1,), v_new, slot)
        # pin the updated cache to its declared layout
        cache_axes = ("batch", "kv_seq", "kv_heads", "head_dim")
        k = with_logical_constraint(k, cache_axes, rules)
        v = with_logical_constraint(v, cache_axes, rules)
        logits = einsum("bhgd,bshd->bhgs", qg, k).to(acc_t) * scale
        written = torch.where(pos + 1 < size, idx <= slot,
                              torch.ones_like(idx, dtype=torch.bool))
        logits = torch.where(written, logits, neg)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = einsum("bhgs,bshd->bhgd", probs, v).reshape(B, 1, H, D)
        return _out_proj(out, p["wo"]), KVCache(k=k, v=v, length=pos + 1)

    # attend over the stale cache with the slot masked out (before the ring
    # wraps: the slots below it; after: all but it), the new token apart
    logits = einsum("bhgd,bshd->bhgs", qg, cache.k.to(qg.dtype)).to(acc_t) * scale
    written = torch.where(pos < size, idx < slot, idx != slot)
    logits = torch.where(written, logits, neg)
    logit_new = einsum("bhgd,bshd->bhgs", qg, k_new.to(qg.dtype)).to(acc_t) * scale
    probs = torch.softmax(torch.cat([logits, logit_new], dim=-1), dim=-1).to(x.dtype)
    out = einsum("bhgs,bshd->bhgd", probs[..., :-1], cache.v.to(x.dtype))
    out = out + einsum("bhgs,bshd->bhgd", probs[..., -1:], v_new.to(x.dtype))
    out = out.reshape(B, 1, H, D)
    return _out_proj(out, p["wo"]), KVCache(k=k_new, v=v_new, length=pos + 1)
