"""Mixture-of-Experts layer: top-k router + GShard-style capacity dispatch.

Counterpart of ``repro.models.moe``.  Tokens are cut into groups of
``group_size``; each token's top-k experts take it into a slot of their
capacity buffer (``capacity`` slots an expert a group, in token order), and
a token past an expert's capacity is dropped there (its gate is zeroed, the
residual carries it).  Dispatch and combine are one-hot einsums over a
(groups, group_size, experts, capacity) tensor, and the expert products are
batched matmuls over the expert axis: plain large products, as in the
reference, which computes them outside any kernel.

Supports:
  * top-k routing with softmax-renormalised gates (Qwen3-MoE: k=8 of 128)
  * the dense residual branch beside it (Snowflake Arctic; in ``model.py``)
  * the Switch-style load-balance auxiliary loss, returned for the loss
  * capacity-factor token dropping
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..sharding.rules import einsum, with_logical_constraint
from .spec import ParamSpec


class MoEConfig(NamedTuple):
    d_model: int
    d_ff: int
    num_experts: int
    top_k: int
    group_size: int = 128
    capacity_factor: float = 2.0
    router_aux_weight: float = 0.01

    @property
    def capacity(self) -> int:
        c = self.group_size * self.top_k * self.capacity_factor / self.num_experts
        return max(int(math.ceil(c)), 1)


def moe_specs(cfg: MoEConfig) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamSpec((d, E), ("embed", "experts"), init="fan_in"),
        "wi_gate": ParamSpec((E, d, f), ("experts", "embed", "expert_mlp"), init="fan_in"),
        "wi_up": ParamSpec((E, d, f), ("experts", "embed", "expert_mlp"), init="fan_in"),
        "wo": ParamSpec((E, f, d), ("experts", "expert_mlp", "embed"), init="fan_in"),
    }


def _route(router_w: torch.Tensor, x: torch.Tensor, cfg: MoEConfig):
    """x (G, S, d) -> gates (G, S, k) float32, expert ids (G, S, k), aux
    loss scalar.  The top k by a stable descending sort: of equal
    probabilities the lower expert id comes first, as ``jax.lax.top_k``
    puts it."""
    logits = (x @ router_w.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = gate_vals[..., :cfg.top_k], expert_ids[..., :cfg.top_k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    # Switch-style load-balance auxiliary loss
    E = cfg.num_experts
    me = probs.mean(dim=(0, 1))                                       # (E,)
    ce = F.one_hot(expert_ids[..., 0], E).float().mean(dim=(0, 1))    # top-1 share
    aux = E * torch.sum(me * ce)
    return gate_vals, expert_ids, aux


def dispatch(ids: torch.Tensor, cfg: MoEConfig, C: int):
    """Each (token, k) pick's slot in its expert's buffer: ids (G, S, k) ->
    (pos (G, S, k), keep (G, S, k) bool).  Slots are taken in the order of
    the flattened (s, k) axis, s-major; a pick at slot >= C is dropped."""
    G, Sg, K = ids.shape
    flat = F.one_hot(ids, cfg.num_experts).to(torch.int32).reshape(G, Sg * K, -1)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat                  # (G, S*k, E)
    pos = (pos_in_expert * flat).sum(-1).reshape(G, Sg, K)
    return pos, pos < C


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig,
              rules=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (output (B, S, d), aux loss scalar float32).  The B S
    tokens are cut into groups of min(group_size, B S), which must divide
    them."""
    Bb, S, d = x.shape
    tokens = Bb * S
    Sg = min(cfg.group_size, tokens)
    if tokens % Sg:
        raise ValueError(f"tokens {tokens} must divide group size {Sg}")
    G = tokens // Sg
    E, C = cfg.num_experts, cfg.capacity
    dt = x.dtype

    xg = x.reshape(G, Sg, d)
    xg = with_logical_constraint(xg, ("batch", None, "act_embed"), rules)
    gates, ids, aux = _route(p["router"], xg, cfg)
    pos, keep = dispatch(ids, cfg, C)
    gates = torch.where(keep, gates, 0.0)

    # dispatch (G, S, E, C) in the compute dtype: disp[g, s, e, c] = 1 if
    # token s goes to slot c of expert e.  A dropped pick's slot is C, one
    # past the buffer: its one-hot row is cut off (zero)
    oh_e = F.one_hot(ids, E).to(dt)                                   # (G, S, k, E)
    oh_c = F.one_hot(torch.where(keep, pos, C), C + 1)[..., :C].to(dt)  # (G, S, k, C)
    disp = einsum("gske,gskc->gsec", oh_e, oh_c)
    comb = einsum("gske,gskc,gsk->gsec", oh_e, oh_c, gates.to(dt))

    xe = einsum("gsd,gsec->gecd", xg, disp)                    # (G, E, C, d)
    xe = with_logical_constraint(xe, ("batch", "experts", None, "act_embed"), rules)
    h = F.silu(einsum("gecd,edf->gecf", xe, p["wi_gate"].to(dt)))
    h = h * einsum("gecd,edf->gecf", xe, p["wi_up"].to(dt))
    h = with_logical_constraint(h, ("batch", "experts", None, "expert_mlp"), rules)
    ye = einsum("gecf,efd->gecd", h, p["wo"].to(dt))
    ye = with_logical_constraint(ye, ("batch", "experts", None, "act_embed"), rules)
    y = einsum("gecd,gsec->gsd", ye, comb)                     # (G, S, d)
    y = with_logical_constraint(y, ("batch", None, "act_embed"), rules)
    return y.reshape(Bb, S, d), cfg.router_aux_weight * aux


def moe_decode(p: dict, x: torch.Tensor, cfg: MoEConfig, rules=None) -> torch.Tensor:
    """Decode-path MoE (B tokens, S=1): the same dispatch over one group,
    its capacity recomputed from group_size = min(group_size, B S)."""
    y, _ = moe_apply(p, x, cfg._replace(
        group_size=min(cfg.group_size, x.shape[0] * x.shape[1])), rules)
    return y


def one_group(model_cfg, tokens: int):
    """A model config whose moe takes ``tokens`` tokens as one group with a
    slot for every token (group_size ``tokens``, capacity_factor
    num_experts / top_k): no token is dropped, so each token's output is
    its own in a forward of S positions, a prefill of S - 1 and the decode
    step after it.  (A group must divide the tokens, and S and S - 1 share
    no group size above 1; at a config's own capacity a full expert may
    drop the forward's last token, which decode keeps.)  A config with no
    moe as it is.  The port's own, for checks of decode after prefill."""
    if model_cfg.moe is None:
        return model_cfg
    m = model_cfg.moe
    return dataclasses.replace(model_cfg, moe=m._replace(
        group_size=tokens, capacity_factor=m.num_experts / m.top_k))
