"""The decoder-LM backbone of the data plane: training, scoring and serving.

Counterpart of ``repro.models.model``, for all ten architectures:

  dense   (qwen3-4b/8b, olmo-1b, h2o-danube-3-4b)   attn + MLP blocks
  moe     (arctic-480b, qwen3-moe-235b-a22b)        attn + MoE (+dense residual)
  ssm     (mamba2-1.3b)                             Mamba2 SSD blocks
  hybrid  (zamba2-2.7b)                             Mamba2 + shared attn block
  vlm     (paligemma-3b)                            patch-embedding frontend stub
  audio   (musicgen-medium)                         frame-embedding frontend stub

Parameters are the reference's tree, nested dicts of tensors with its key
paths, every block's leaves stacked on a leading layer axis (the hybrid's
twice: groups, then the k Mamba2 layers of a group); the layer stack is a
Python loop over that axis (the reference's ``lax.scan``).

The full-sequence forward (``forward_logits_last``, ``forward_loss``)
takes the reference's two routes: with ``use_pallas`` (and, for the SSD
block, ``ssm.use_pallas``) the flash attention and SSD kernels, which are
forward only; by default the plain route, which autograd differentiates
(``train.make_train_step``).  Each block runs under the reference's remat
policy (``remat``: ``"full"`` recomputes the block in the backward pass,
``"dots"`` keeps the matmul outputs, ``"none"`` keeps everything); the
hybrid's shared block under a wrapper of its own.  ``prefill`` and
``decode_step`` run the plain paths that build and use the decode cache.

Every entry point takes the reference's ``rules`` (an
``repro_torch.sharding.AxisRules``, or None): with DTensor parameters and
inputs under ``sharding.mesh_context``, the blocks place the reference's
sharding constraints on their activations; with None, or on plain tensors,
nothing changes.
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
from ..sharding.rules import with_logical_constraint
from . import attention as attn_lib
from . import moe as moe_lib
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
from .moe import MoEConfig
from .spec import ParamSpec, init_from_specs, tree_leaves, tree_map
from .ssm import SSMCache, SSMConfig


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
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
    moe: MoEConfig | None = None
    dense_residual: bool = False  # Arctic: parallel dense MLP beside MoE
    # ssm / hybrid
    ssm: SSMConfig | None = None
    hybrid_attn_every: int = 0    # Zamba2: shared attn block every k layers
    # embeddings / heads
    norm: str = "rms"
    tie_embeddings: bool = False
    num_lm_heads: int = 1         # MusicGen: 4 codebook heads
    frontend: str | None = None   # None | "patches" | "frames"
    frontend_dim: int = 0
    num_frontend_tokens: int = 0  # VLM: image tokens prepended
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

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def num_attn_layers(self) -> int:
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            return self.num_layers // self.hybrid_attn_every
        return self.num_layers

    def param_count(self) -> int:
        return sum(math.prod(s.shape) for s in tree_leaves(model_specs(self)))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of num_experts of the
        expert weights, ``wi_gate``/``wi_up``/``wo`` under a ``moe`` key)."""
        if self.moe is None:
            return self.param_count()
        total = 0
        for path, spec in _spec_paths(model_specs(self)):
            n = math.prod(spec.shape)
            if "moe" in path and any(k in ("wi_gate", "wi_up", "wo") for k in path):
                n = n * self.moe.top_k // self.moe.num_experts
            total += n
        return total


def _spec_paths(tree, path: tuple = ()):
    """(key path, ParamSpec) of every leaf of a spec tree."""
    if isinstance(tree, ParamSpec):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_paths(tree[k], path + (k,))


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
    if cfg.family in ("ssm", "hybrid"):
        return {"norm": rmsnorm_specs(d), "ssm": ssm_lib.ssm_specs(cfg.ssm)}
    block: dict = {
        "attn_norm": rmsnorm_specs(d) if cfg.norm == "rms" else {},
        "attn": attn_lib.attn_specs(cfg.attn_cfg),
        "mlp_norm": rmsnorm_specs(d) if cfg.norm == "rms" else {},
    }
    if cfg.moe is not None:
        block["moe"] = moe_lib.moe_specs(cfg.moe)
        if cfg.dense_residual:
            block["mlp"] = mlp_specs(d, cfg.d_ff)
    else:
        block["mlp"] = mlp_specs(d, cfg.d_ff)
    return block


def model_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    specs: dict = {}
    if cfg.frontend in (None, "patches"):
        specs["embed"] = embed_specs(cfg.vocab_size, d)
    elif cfg.frontend != "frames":
        raise ValueError(cfg.frontend)
    if cfg.frontend in ("patches", "frames"):
        specs["frontend_proj"] = ParamSpec(
            (cfg.frontend_dim, d), ("embed_out", "embed"), init="fan_in")

    if cfg.family == "hybrid":
        k = cfg.hybrid_attn_every
        specs["blocks"] = _stack_specs(_stack_specs(_block_specs(cfg), k),
                                       cfg.num_layers // k)
        specs["shared_attn"] = {
            "attn_norm": rmsnorm_specs(d), "attn": attn_lib.attn_specs(cfg.attn_cfg),
            "mlp_norm": rmsnorm_specs(d), "mlp": mlp_specs(d, cfg.d_ff)}
    else:
        specs["blocks"] = _stack_specs(_block_specs(cfg), cfg.num_layers)

    if cfg.norm == "rms":
        specs["final_norm"] = rmsnorm_specs(d)
    if not cfg.tie_embeddings:
        if cfg.num_lm_heads == 1:
            specs["head"] = ParamSpec((d, cfg.vocab_size), ("embed", "vocab"), init="fan_in")
        else:
            specs["head"] = ParamSpec((cfg.num_lm_heads, d, cfg.vocab_size),
                                      (None, "embed", "vocab"), init="fan_in")
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
    """The per-layer subtrees of a tree stacked on a leading layer axis (a
    tree stacked twice gives its groups, each stacked once).

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


def _ffn(p, h, cfg: ModelConfig, rules=None, decode: bool = False):
    """The block's feed-forward half on the normed input h: the MLP, or the
    MoE (``moe_decode`` for one token; with Arctic's parallel dense MLP);
    (output, aux loss)."""
    if cfg.moe is None:
        return mlp_apply(p["mlp"], h, rules, cfg.mlp_activation), 0.0
    if decode:
        y, aux = moe_lib.moe_decode(p["moe"], h, cfg.moe, rules), 0.0
    else:
        y, aux = moe_lib.moe_apply(p["moe"], h, cfg.moe, rules)
    if cfg.dense_residual:
        y = y + mlp_apply(p["mlp"], h, rules, cfg.mlp_activation)
    return y, aux


def _transformer_block(p, x, positions, cfg: ModelConfig, rules=None):
    h = apply_norm(cfg.norm, _norm_params(p, "attn_norm"), x)
    x = x + attn_lib.attention_train(p["attn"], h, positions, cfg.attn_cfg, rules)
    h = apply_norm(cfg.norm, _norm_params(p, "mlp_norm"), x)
    y, aux = _ffn(p, h, cfg, rules)
    return x + y, aux


def _ssm_block(p, x, cfg: ModelConfig, rules=None):
    h = apply_norm(cfg.norm, p["norm"], x)
    return x + ssm_lib.ssm_train(p["ssm"], h, cfg.ssm, rules)


def _shared_block(shared, x, positions, cfg: ModelConfig, rules=None):
    """Zamba2's shared attention block (one weight copy for every group)."""
    a = apply_norm(cfg.norm, shared["attn_norm"], x)
    x = x + attn_lib.attention_train(shared["attn"], a, positions, cfg.attn_cfg, rules)
    m = apply_norm(cfg.norm, shared["mlp_norm"], x)
    return x + mlp_apply(shared["mlp"], m, rules, cfg.mlp_activation)


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


def _apply_blocks_train(params, x, positions, cfg: ModelConfig, rules=None):
    """The stacked blocks, layer by layer, over the whole sequence, each
    block under the remat policy; returns (x, the MoE's aux loss summed over
    the layers, 0.0 without one)."""
    aux_total = 0.0
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        block = _remat(lambda p, h: _transformer_block(p, h, positions, cfg, rules), cfg)
        for layer_p in _layers(params["blocks"]):
            x, aux = block(layer_p, x)
            aux_total = aux_total + aux
        return x, aux_total
    if cfg.family == "ssm":
        block = _remat(lambda p, h: _ssm_block(p, h, cfg, rules), cfg)
        for layer_p in _layers(params["blocks"]):
            x = block(layer_p, x)
        return x, aux_total
    if cfg.family == "hybrid":
        block = _remat(lambda p, h: _ssm_block(p, h, cfg, rules), cfg)
        shared = _remat(lambda p, h: _shared_block(p, h, positions, cfg, rules), cfg)
        for group_p in _layers(params["blocks"]):
            for layer_p in _layers(group_p):
                x = block(layer_p, x)
            x = shared(params["shared_attn"], x)
        return x, aux_total
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Full-sequence forward (evaluation loss, last-position logits)
# ---------------------------------------------------------------------------

def _frontend(inputs: torch.Tensor, w: torch.Tensor, cd) -> torch.Tensor:
    """Patch or frame embeddings (B, S, fd) projected to (B, S, d)."""
    return inputs.to(cd) @ w.to(cd)


def embed_inputs(params, batch: dict, cfg: ModelConfig, rules=None):
    """Returns (x (B, S, d), positions (S,)): the token embeddings; for
    ``patches`` the projected patches before them; for ``frames`` the
    projected frames alone."""
    cd = cfg.compute_dtype
    if cfg.frontend is None:
        x = embed_lookup(params["embed"], batch["tokens"], cd)
    elif cfg.frontend == "patches":
        proj = _frontend(batch["patches"], params["frontend_proj"], cd)
        text = embed_lookup(params["embed"], batch["tokens"], cd)
        x = torch.cat([proj, text], dim=1)
    elif cfg.frontend == "frames":
        x = _frontend(batch["frames"], params["frontend_proj"], cd)
    else:
        raise ValueError(cfg.frontend)
    x = with_logical_constraint(x, ("batch", "seq", "act_embed"), rules)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return x, positions


def _head_weight(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"]["table"], True
    return params["head"], False


def _logits(params, x, cfg: ModelConfig) -> torch.Tensor:
    """x (B, s, d) -> logits (B, s, V), or (B, s, heads, V) with several
    heads (MusicGen's codebooks)."""
    head_w, tied = _head_weight(params, cfg)
    if cfg.num_lm_heads == 1:
        return unembed_logits(head_w, x, tied)
    return torch.stack([unembed_logits(head_w[h], x, False)
                        for h in range(cfg.num_lm_heads)], dim=2)


def forward_logits_last(params, batch: dict, cfg: ModelConfig, rules=None) -> torch.Tensor:
    """Logits (B, 1, [heads,] V) at the final position of a full
    (non-cached) forward pass: what one ``decode_step`` after ``prefill``
    of the same prefix must give."""
    x, positions = embed_inputs(params, batch, cfg, rules)
    x, _ = _apply_blocks_train(params, x, positions, cfg, rules)
    x = apply_norm(cfg.norm, params.get("final_norm"), x)
    return _logits(params, x[:, -1:, :], cfg)


def forward_loss(params, batch: dict, cfg: ModelConfig, rules=None) -> torch.Tensor:
    """Mean-token cross entropy (float32 scalar) of ``batch["labels"]``
    (+ the MoE's aux loss); labels < 0 are masked out.  ``patches``: over
    the text suffix only; several heads: labels (B, S, heads), the mean of
    the heads' losses."""
    x, positions = embed_inputs(params, batch, cfg, rules)
    x, aux = _apply_blocks_train(params, x, positions, cfg, rules)
    x = apply_norm(cfg.norm, params.get("final_norm"), x)
    labels = batch["labels"]
    mask = labels >= 0
    labels = torch.clamp_min(labels, 0)
    head_w, tied = _head_weight(params, cfg)
    if cfg.num_lm_heads == 1:
        if cfg.frontend == "patches":
            x = x[:, -labels.shape[1]:, :]
        loss = softmax_xent_chunked(x, head_w, labels, mask, tied, rules,
                                    cfg.xent_chunk)
    else:
        loss = torch.stack([
            softmax_xent_chunked(x, head_w[h], labels[..., h], mask[..., h], False,
                                 rules, cfg.xent_chunk)
            for h in range(cfg.num_lm_heads)]).mean()
    return loss + aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def make_cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """ParamSpec tree of the decode cache (stacked over layers; the
    hybrid's SSM states over groups and layers, its shared block's KV over
    groups)."""
    cd = cfg.compute_dtype
    if cfg.family == "ssm":
        return {"ssm": _stack_specs(ssm_lib.ssm_cache_specs(cfg.ssm, batch, cd)._asdict(),
                                    cfg.num_layers)}
    kv = attn_lib.kv_cache_specs(cfg.attn_cfg, batch, max_len, cd)._asdict()
    if cfg.family == "hybrid":
        k = cfg.hybrid_attn_every
        groups = cfg.num_layers // k
        return {"ssm": _stack_specs(_stack_specs(
                    ssm_lib.ssm_cache_specs(cfg.ssm, batch, cd)._asdict(), k), groups),
                "attn": _stack_specs(kv, groups)}
    return {"attn": _stack_specs(kv, cfg.num_layers)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None):
    """An empty decode cache on ``device`` (None: the card)."""
    dev = resolve(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    make_cache_specs(cfg, batch, max_len))


def _ssm_decode_layers(blocks, caches, x, cfg: ModelConfig, rules=None):
    """The stacked Mamba2 layers, one token: (x, their new caches stacked)."""
    new = []
    for layer_p, c in zip(_layers(blocks), _layers(caches)):
        hn = apply_norm(cfg.norm, layer_p["norm"], x)
        y, c2 = ssm_lib.ssm_decode(layer_p["ssm"], hn, SSMCache(**c), cfg.ssm, rules)
        x = x + y
        new.append(c2._asdict())
    return x, _stack(new)


def decode_step(params, batch: dict, cache, cfg: ModelConfig, rules=None):
    """One new token for every sequence in the batch.

    batch: {"tokens": (B, 1)}, or {"frames": (B, 1, fd)} for ``frames``;
    cache: from ``init_cache`` or ``prefill``.  Returns (logits (B, 1,
    [heads,] V), new_cache); the cache passed in is not modified."""
    cd = cfg.compute_dtype
    if cfg.frontend == "frames":
        x = _frontend(batch["frames"], params["frontend_proj"], cd)
    else:
        x = embed_lookup(params["embed"], batch["tokens"], cd)
    if cfg.family == "ssm":
        x, new_ssm = _ssm_decode_layers(params["blocks"], cache["ssm"], x, cfg, rules)
        new_cache = {"ssm": new_ssm}
    elif cfg.family == "hybrid":
        shared = params["shared_attn"]
        new_ssm, new_attn = [], []
        for group_p, ssm_c, attn_c in zip(_layers(params["blocks"]),
                                          _layers(cache["ssm"]), _layers(cache["attn"])):
            x, ssm_c2 = _ssm_decode_layers(group_p, ssm_c, x, cfg, rules)
            a = apply_norm(cfg.norm, shared["attn_norm"], x)
            y, kv2 = attn_lib.attention_decode(shared["attn"], a, KVCache(**attn_c),
                                               cfg.attn_cfg, rules)
            x = x + y
            m = apply_norm(cfg.norm, shared["mlp_norm"], x)
            x = x + mlp_apply(shared["mlp"], m, rules, cfg.mlp_activation)
            new_ssm.append(ssm_c2)
            new_attn.append(kv2._asdict())
        new_cache = {"ssm": _stack(new_ssm), "attn": _stack(new_attn)}
    else:
        new = []
        for layer_p, c in zip(_layers(params["blocks"]), _layers(cache["attn"])):
            hn = apply_norm(cfg.norm, _norm_params(layer_p, "attn_norm"), x)
            y, kv2 = attn_lib.attention_decode(layer_p["attn"], hn, KVCache(**c),
                                               cfg.attn_cfg, rules)
            x = x + y
            m = apply_norm(cfg.norm, _norm_params(layer_p, "mlp_norm"), x)
            x = x + _ffn(layer_p, m, cfg, rules, decode=True)[0]
            new.append(kv2._asdict())
        new_cache = {"attn": _stack(new)}

    x = apply_norm(cfg.norm, params.get("final_norm"), x)
    return _logits(params, x, cfg), new_cache


def _ssm_prefill_layers(blocks, x, cfg: ModelConfig, rules=None):
    """The stacked Mamba2 layers over the prompt: (x, their caches stacked)."""
    states = []
    for layer_p in _layers(blocks):
        hn = apply_norm(cfg.norm, layer_p["norm"], x)
        y, st = ssm_lib.ssm_train_with_state(layer_p["ssm"], hn, cfg.ssm, rules)
        x = x + y
        states.append(st)
    return x, _stack(states)


def prefill(params, batch: dict, cfg: ModelConfig, rules=None,
            max_len: int | None = None):
    """Score a full prompt and build the decode cache.

    The chunked plain forward plus per-layer cache capture.
    Returns (last_hidden (B, d), cache)."""
    x, positions = embed_inputs(params, batch, cfg, rules)
    max_len = max_len or x.shape[1]
    if cfg.family == "ssm":
        x, states = _ssm_prefill_layers(params["blocks"], x, cfg, rules)
        cache = {"ssm": states}
    elif cfg.family == "hybrid":
        shared = params["shared_attn"]
        states, kvs = [], []
        for group_p in _layers(params["blocks"]):
            x, st = _ssm_prefill_layers(group_p, x, cfg, rules)
            a = apply_norm(cfg.norm, shared["attn_norm"], x)
            y, kv = attn_lib.attention_train_with_kv(shared["attn"], a, positions,
                                                     cfg.attn_cfg, max_len, rules)
            x = x + y
            m = apply_norm(cfg.norm, shared["mlp_norm"], x)
            x = x + mlp_apply(shared["mlp"], m, rules, cfg.mlp_activation)
            states.append(st)
            kvs.append(kv)
        cache = {"ssm": _stack(states), "attn": _stack(kvs)}
    else:
        kvs = []
        for layer_p in _layers(params["blocks"]):
            hn = apply_norm(cfg.norm, _norm_params(layer_p, "attn_norm"), x)
            y, kv = attn_lib.attention_train_with_kv(layer_p["attn"], hn, positions,
                                                     cfg.attn_cfg, max_len, rules)
            x = x + y
            m = apply_norm(cfg.norm, _norm_params(layer_p, "mlp_norm"), x)
            x = x + _ffn(layer_p, m, cfg, rules)[0]
            kvs.append(kv)
        cache = {"attn": _stack(kvs)}
    x = apply_norm(cfg.norm, params.get("final_norm"), x)
    return x[:, -1, :], cache
