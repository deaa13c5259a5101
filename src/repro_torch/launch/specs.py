"""Zero-allocation stand-ins and shardings for every (arch x shape) cell.

Counterpart of ``repro.launch.specs``.  Where the reference builds
``ShapeDtypeStruct``s and ``NamedSharding``s, the port builds tensors with
no storage (meta tensors, or fake tensors under a ``FakeTensorMode``) and
each leaf's ``(mesh, placements)``.  One function stages everything the
dry run (``repro_torch.launch.dryrun``) needs for a cell:

  build_cell(cfg, shape_name, mesh, rules) ->
      CellSpec(fn, args_sds, in_shardings, out_shardings, donate_argnums)

Step kinds per shape (see repro_torch.configs.SHAPES):
  train        train_step(state, batch)
  prefill      prefill(params, batch)
  decode       decode_step(params, batch, cache)
  long_decode  decode with a 500k-token context (SSM state / SWA window /
               sequence-sharded KV)

A cell that does not apply to an architecture (``configs.shape_applicable``)
is a result of the caller's, not an error here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..configs import SHAPES
from ..models.model import (
    ModelConfig,
    decode_step,
    make_cache_specs,
    model_specs,
    prefill,
)
from ..sharding.rules import (
    AxisRules,
    DEFAULT_RULES,
    ParamSpec,
    shardings_for_tree,
    shape_dtype_for_tree,
)
from ..train.optimizer import OptConfig
from ..train.train_step import make_train_step, train_state_specs

DECODE_MARGIN = 128  # decode cache capacity beyond the prefilled context


def batch_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """ParamSpec tree for the input batch of a given shape."""
    S, B, kind = SHAPES[shape_name]
    tok = lambda shape: ParamSpec(shape, ("batch", "seq"), dtype=torch.int32, init="zeros")
    if kind in ("train", "prefill"):
        if cfg.frontend == "patches":
            ni = cfg.num_frontend_tokens
            specs = {
                "patches": ParamSpec((B, ni, cfg.frontend_dim),
                                     ("batch", "seq", None), dtype=torch.float32),
                "tokens": tok((B, S - ni)),
            }
            if kind == "train":
                specs["labels"] = tok((B, S - ni))
            return specs
        if cfg.frontend == "frames":
            specs = {
                "frames": ParamSpec((B, S, cfg.frontend_dim),
                                    ("batch", "seq", None), dtype=torch.float32),
            }
            if kind == "train":
                specs["labels"] = ParamSpec((B, S, cfg.num_lm_heads),
                                            ("batch", "seq", None),
                                            dtype=torch.int32, init="zeros")
            return specs
        specs = {"tokens": tok((B, S))}
        if kind == "train":
            specs["labels"] = tok((B, S))
        return specs
    # decode kinds: one new token per sequence
    if cfg.frontend == "frames":
        return {"frames": ParamSpec((B, 1, cfg.frontend_dim),
                                    ("batch", "seq", None), dtype=torch.float32)}
    return {"tokens": tok((B, 1))}


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta tensors for the batch of one cell (no allocation)."""
    return shape_dtype_for_tree(batch_specs(cfg, shape_name))


def rules_for_shape(cfg: ModelConfig, shape_name: str, base: AxisRules) -> AxisRules:
    S, B, kind = SHAPES[shape_name]
    if kind == "long_decode":
        # batch=1 cannot shard; shard the KV sequence instead (SP).
        return base.override(batch=None, kv_seq="data")
    return base


@dataclass
class CellSpec:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args_sds: tuple          # trees of meta tensors: each argument's global leaves
    in_shardings: tuple      # trees of (mesh, placements), one per argument
    out_shardings: Any
    donate_argnums: tuple[int, ...]
    static_notes: dict


def build_cell(cfg: ModelConfig, shape_name: str, mesh, rules: AxisRules | None = None,
               opt_cfg: OptConfig | None = None) -> CellSpec:
    """The cell's step function, its arguments as meta tensors of their
    global shapes (the dry run turns each into a fake DTensor) and their
    shardings on ``mesh``."""
    rules = rules_for_shape(cfg, shape_name, rules or DEFAULT_RULES)
    S, B, kind = SHAPES[shape_name]
    opt_cfg = opt_cfg or OptConfig()

    b_specs = batch_specs(cfg, shape_name)
    b_sh = shardings_for_tree(b_specs, mesh, rules)

    if kind == "train":
        st_specs = train_state_specs(cfg, opt_cfg)
        st_sh = shardings_for_tree(st_specs, mesh, rules)
        fn = make_train_step(cfg, opt_cfg, rules)
        return CellSpec(
            arch=cfg.name, shape=shape_name, kind=kind, fn=fn,
            args_sds=(shape_dtype_for_tree(st_specs), shape_dtype_for_tree(b_specs)),
            in_shardings=(st_sh, b_sh),
            out_shardings=(st_sh, None),
            donate_argnums=(0,),
            static_notes={"seq": S, "batch": B})

    p_specs = model_specs(cfg)
    p_sh = shardings_for_tree(p_specs, mesh, rules)

    if kind == "prefill":
        fn = lambda params, batch: prefill(params, batch, cfg, rules, max_len=S + DECODE_MARGIN)
        return CellSpec(
            arch=cfg.name, shape=shape_name, kind=kind, fn=fn,
            args_sds=(shape_dtype_for_tree(p_specs), shape_dtype_for_tree(b_specs)),
            in_shardings=(p_sh, b_sh),
            out_shardings=None,
            donate_argnums=(),
            static_notes={"seq": S, "batch": B})

    # decode / long_decode: serve_step against an S-token context
    cache_specs = make_cache_specs(cfg, batch=B, max_len=S + DECODE_MARGIN)
    c_sh = shardings_for_tree(cache_specs, mesh, rules)
    fn = lambda params, batch, cache: decode_step(params, batch, cache, cfg, rules)
    return CellSpec(
        arch=cfg.name, shape=shape_name, kind=kind, fn=fn,
        args_sds=(shape_dtype_for_tree(p_specs), shape_dtype_for_tree(b_specs),
                  shape_dtype_for_tree(cache_specs)),
        in_shardings=(p_sh, b_sh, c_sh),
        out_shardings=(None, c_sh),
        donate_argnums=(2,),
        static_notes={"seq": S, "batch": B})
