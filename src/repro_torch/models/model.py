"""The decoder-LM backbone of the data plane: training, scoring and serving.

Counterpart of ``repro.models.model`` for the families ported so far:

  dense   (qwen3-4b/8b, olmo-1b, h2o-danube-3-4b)   attn + MLP blocks
  ssm     (mamba2-1.3b)                             Mamba2 SSD blocks

``moe``, ``hybrid``, ``vlm`` and ``audio`` raise ``NotImplementedError``:
they wait for the data plane's next slice.  Parameters are the reference's
tree, nested dicts of tensors with its key paths, every block's leaves
stacked on a leading layer axis; the layer stack is a Python loop over
that axis (the reference's ``lax.scan``).

The full-sequence forward (``forward_logits_last``, ``forward_loss``)
takes the reference's two routes: with ``use_pallas`` (and, for the SSD
block, ``ssm.use_pallas``) the flash attention and SSD kernels, which are
forward only; by default the plain route, which autograd differentiates
(``train.make_train_step``).  Each block runs under the reference's remat
policy (``remat``: ``"full"`` recomputes the block in the backward pass,
``"dots"`` keeps the matmul outputs, ``"none"`` keeps everything).
``prefill`` and ``decode_step`` run the plain paths that build and use the
decode cache.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..device import resolve
from . import attention as attn_lib
from . import ssm as ssm_lib
from .attention import AttnConfig, KVCache
from .layers import (
    apply_norm,
    embed_lookup,
    embed_specs,
    mlp_apply,
    mlp_specs,
    rmsnorm_specs,
    softmax_xent_chunked,
    unembed_logits,
)
from .spec import ParamSpec, init_from_specs, tree_leaves, tree_map
from .ssm import SSMCache, SSMConfig

PORTED_FAMILIES = ("dense", "ssm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | ssm  (moe | hybrid | vlm | audio: not ported)
    num_layers: int
    d_model: int
    vocab_size: int
    # attention (unused for family == "ssm")
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    sliding_window: int | None = None
    rope_theta: float = 10000.0
    # mlp / moe
    d_ff: int = 0
    mlp_activation: str = "silu"
    moe: Any = None
    dense_residual: bool = False
    # ssm / hybrid
    ssm: SSMConfig | None = None
    hybrid_attn_every: int = 0
    # embeddings / heads
    norm: str = "rms"
    tie_embeddings: bool = False
    num_lm_heads: int = 1
    frontend: str | None = None
    frontend_dim: int = 0
    num_frontend_tokens: int = 0
    # execution
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: str = "full"           # none | full | dots
    q_chunk: int = 512
    xent_chunk: int = 512
    # the flash attention kernel (forward only); the SSD block has its own
    # switch, ``ssm.use_pallas``, as in the reference
    use_pallas: bool = False
    attn_logits_fp32: bool = True
    supports_long_context: bool = False

    @property
    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.head_dim,
            qk_norm=self.qk_norm, sliding_window=self.sliding_window,
            rope_theta=self.rope_theta, q_chunk=self.q_chunk,
            use_pallas=self.use_pallas, logits_fp32=self.attn_logits_fp32)

    def param_count(self) -> int:
        return sum(math.prod(s.shape) for s in tree_leaves(model_specs(self)))

    def active_param_count(self) -> int:
        """Parameters touched per token: all of them in the ported dense and
        ssm families (moe, which touches top_k of num_experts, is not
        ported)."""
        return self.param_count()


def _check_ported(cfg: ModelConfig) -> None:
    if (cfg.family not in PORTED_FAMILIES or cfg.moe is not None
            or cfg.frontend is not None or cfg.num_lm_heads != 1):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (frontend {cfg.frontend!r}) is "
            "not ported yet; moe, hybrid, vlm and audio wait for the data "
            "plane's next slice")


# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------

def _stack_specs(specs, n: int):
    """Add a leading layer dim of size n to every ParamSpec in a tree."""
    return tree_map(lambda s: ParamSpec((n, *s.shape), ("layers", *s.logical_axes),
                                        dtype=s.dtype, init=s.init,
                                        init_scale=s.init_scale), specs)


def _block_specs(cfg: ModelConfig) -> dict:
    """Specs for one repeated block (pre-stacking)."""
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"norm": rmsnorm_specs(d), "ssm": ssm_lib.ssm_specs(cfg.ssm)}
    return {
        "attn_norm": rmsnorm_specs(d) if cfg.norm == "rms" else {},
        "attn": attn_lib.attn_specs(cfg.attn_cfg),
        "mlp_norm": rmsnorm_specs(d) if cfg.norm == "rms" else {},
        "mlp": mlp_specs(d, cfg.d_ff),
    }


def model_specs(cfg: ModelConfig) -> dict:
    _check_ported(cfg)
    d = cfg.d_model
    specs: dict = {"embed": embed_specs(cfg.vocab_size, d),
                   "blocks": _stack_specs(_block_specs(cfg), cfg.num_layers)}
    if cfg.norm == "rms":
        specs["final_norm"] = rmsnorm_specs(d)
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((d, cfg.vocab_size), ("embed", "vocab"), init="fan_in")
    return specs


def _generator(key, device: torch.device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        if key.device.type != device.type:
            raise ValueError(f"the generator is on {key.device}, the parameters "
                             f"go to {device}")
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def init_params(cfg: ModelConfig, key: int | torch.Generator = 0, *, device=None):
    """Random parameters on ``device`` (None: the card), drawn from a
    ``torch.Generator`` or a seed; the reference's tree and distributions
    (its ``jax.random`` draws are not reproduced)."""
    dev = resolve(device)
    return init_from_specs(model_specs(cfg), _generator(key, dev), cfg.param_dtype, dev)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _layers(stacked):
    """The per-layer subtrees of a tree stacked on a leading layer axis.

    Each leaf is split by ``unbind``, whose backward stacks the layers'
    gradients once, where indexing layer by layer would add a full-size
    zero-padded gradient per layer."""
    n = tree_leaves(stacked, _is_tensor)[0].shape[0]
    parts = tree_map(lambda a: a.unbind(0), stacked, _is_tensor)
    is_parts = lambda x: isinstance(x, tuple) and len(x) == n and _is_tensor(x[0])
    return [tree_map(lambda t, i=i: t[i], parts, is_parts) for i in range(n)]


def _stack(trees: list[dict]) -> dict:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _norm_params(p: dict, key: str):
    return p.get(key) or None          # {} (non-parametric norm) -> None


def _transformer_block(p, x, positions, cfg: ModelConfig):
    h = apply_norm(cfg.norm, _norm_params(p, "attn_norm"), x)
    x = x + attn_lib.attention_train(p["attn"], h, positions, cfg.attn_cfg)
    h = apply_norm(cfg.norm, _norm_params(p, "mlp_norm"), x)
    return x + mlp_apply(p["mlp"], h, cfg.mlp_activation)


def _ssm_block(p, x, cfg: ModelConfig):
    h = apply_norm(cfg.norm, p["norm"], x)
    return x + ssm_lib.ssm_train(p["ssm"], h, cfg.ssm)


_MATMULS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default})


def _save_matmuls(ctx, op, *args, **kwargs):
    """jax.checkpoint_policies.dots_saveable: keep the matmul outputs,
    recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ModelConfig):
    """``fn`` under the config's remat policy (the reference's ``_remat``).
    The blocks draw no random numbers, so no RNG state is stashed."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_matmuls))
    raise ValueError(cfg.remat)


def _apply_blocks_train(params, x, positions, cfg: ModelConfig):
    """The stacked blocks, layer by layer, over the whole sequence, each
    block under the remat policy."""
    if cfg.family == "ssm":
        block = _remat(lambda p, h: _ssm_block(p, h, cfg), cfg)
    else:
        block = _remat(lambda p, h: _transformer_block(p, h, positions, cfg), cfg)
    for layer_p in _layers(params["blocks"]):
        x = block(layer_p, x)
    return x


# ---------------------------------------------------------------------------
# Full-sequence forward (evaluation loss, last-position logits)
# ---------------------------------------------------------------------------

def embed_inputs(params, batch: dict, cfg: ModelConfig):
    """Returns (x (B, S, d), positions (S,))."""
    _check_ported(cfg)
    x = embed_lookup(params["embed"], batch["tokens"], cfg.compute_dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return x, positions


def _head_weight(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"]["table"], True
    return params["head"], False


def forward_logits_last(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Logits (B, 1, V) at the final position of a full (non-cached)
    forward pass: what one ``decode_step`` after ``prefill`` of the same
    prefix must give."""
    x, positions = embed_inputs(params, batch, cfg)
    x = _apply_blocks_train(params, x, positions, cfg)
    x = apply_norm(cfg.norm, params.get("final_norm"), x)
    head_w, tied = _head_weight(params, cfg)
    return unembed_logits(head_w, x[:, -1:, :], tied)


def forward_loss(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mean-token cross entropy (float32 scalar) of ``batch["labels"]``;
    labels < 0 are masked out."""
    x, positions = embed_inputs(params, batch, cfg)
    x = _apply_blocks_train(params, x, positions, cfg)
    x = apply_norm(cfg.norm, params.get("final_norm"), x)
    labels = batch["labels"]
    mask = labels >= 0
    head_w, tied = _head_weight(params, cfg)
    return softmax_xent_chunked(x, head_w, torch.clamp_min(labels, 0), mask, tied,
                                cfg.xent_chunk)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def make_cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """ParamSpec tree of the decode cache (stacked over layers)."""
    _check_ported(cfg)
    cd = cfg.compute_dtype
    if cfg.family == "ssm":
        return {"ssm": _stack_specs(ssm_lib.ssm_cache_specs(cfg.ssm, batch, cd)._asdict(),
                                    cfg.num_layers)}
    return {"attn": _stack_specs(
        attn_lib.kv_cache_specs(cfg.attn_cfg, batch, max_len, cd)._asdict(),
        cfg.num_layers)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None):
    """An empty decode cache on ``device`` (None: the card)."""
    dev = resolve(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    make_cache_specs(cfg, batch, max_len))


def decode_step(params, batch: dict, cache, cfg: ModelConfig):
    """One new token for every sequence in the batch.

    batch: {"tokens": (B, 1)}; cache: from ``init_cache`` or ``prefill``.
    Returns (logits (B, 1, V), new_cache); the cache passed in is not
    modified."""
    _check_ported(cfg)
    x = embed_lookup(params["embed"], batch["tokens"], cfg.compute_dtype)
    if cfg.family == "ssm":
        new = []
        for layer_p, c in zip(_layers(params["blocks"]), _layers(cache["ssm"])):
            hn = apply_norm(cfg.norm, layer_p["norm"], x)
            y, c2 = ssm_lib.ssm_decode(layer_p["ssm"], hn, SSMCache(**c), cfg.ssm)
            x = x + y
            new.append(c2._asdict())
        new_cache = {"ssm": _stack(new)}
    else:
        new = []
        for layer_p, c in zip(_layers(params["blocks"]), _layers(cache["attn"])):
            hn = apply_norm(cfg.norm, _norm_params(layer_p, "attn_norm"), x)
            y, kv2 = attn_lib.attention_decode(layer_p["attn"], hn, KVCache(**c),
                                               cfg.attn_cfg)
            x = x + y
            m = apply_norm(cfg.norm, _norm_params(layer_p, "mlp_norm"), x)
            x = x + mlp_apply(layer_p["mlp"], m, cfg.mlp_activation)
            new.append(kv2._asdict())
        new_cache = {"attn": _stack(new)}

    x = apply_norm(cfg.norm, params.get("final_norm"), x)
    head_w, tied = _head_weight(params, cfg)
    return unembed_logits(head_w, x, tied), new_cache


def prefill(params, batch: dict, cfg: ModelConfig, max_len: int | None = None):
    """Score a full prompt and build the decode cache.

    The chunked plain forward plus per-layer cache capture.
    Returns (last_hidden (B, d), cache)."""
    x, positions = embed_inputs(params, batch, cfg)
    max_len = max_len or x.shape[1]
    caches = []
    for layer_p in _layers(params["blocks"]):
        if cfg.family == "ssm":
            hn = apply_norm(cfg.norm, layer_p["norm"], x)
            y, st = ssm_lib.ssm_train_with_state(layer_p["ssm"], hn, cfg.ssm)
            x = x + y
            caches.append(st)
        else:
            hn = apply_norm(cfg.norm, _norm_params(layer_p, "attn_norm"), x)
            y, kv = attn_lib.attention_train_with_kv(layer_p["attn"], hn, positions,
                                                     cfg.attn_cfg, max_len)
            x = x + y
            m = apply_norm(cfg.norm, _norm_params(layer_p, "mlp_norm"), x)
            x = x + mlp_apply(layer_p["mlp"], m, cfg.mlp_activation)
            caches.append(kv)
    cache = {"ssm" if cfg.family == "ssm" else "attn": _stack(caches)}
    x = apply_norm(cfg.norm, params.get("final_norm"), x)
    return x[:, -1, :], cache
