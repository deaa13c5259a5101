"""AdamW + clipping + warmup-cosine schedule, in PyTorch.

The port's copy of ``repro.train.optimizer``.  Every step keeps the
reference's float32 arithmetic, op for op and in its order (g x scale,
then the moments, then m_hat / (sqrt(v_hat) + eps) + wd p, then the cast to
the parameter's dtype), on the parameters' device.  Moments may be stored
in bf16 (``moment_dtype``) for the very large configs.  Updates return new
tensors, as the reference does; nothing is updated in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..models.spec import ParamSpec, tree_leaves, tree_map


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: Any = torch.float32


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_ratio * lr``
    (float32, on ``step``'s device)."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    frac = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def adamw_init(params, cfg: OptConfig):
    """Zero moments in ``moment_dtype`` beside each parameter, and ``step``
    a 0-d int32 tensor on the parameters' device."""
    leaves = tree_leaves(params, _is_tensor)
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    return {
        "mu": tree_map(zeros, params, _is_tensor),
        "nu": tree_map(zeros, params, _is_tensor),
        "step": torch.zeros((), dtype=torch.int32,
                            device=leaves[0].device if leaves else None),
    }


def adamw_state_specs(param_specs, cfg: OptConfig):
    """ParamSpec tree for the optimizer state (moments shaped like params)."""
    mom = lambda s: ParamSpec(s.shape, s.logical_axes, dtype=cfg.moment_dtype, init="zeros")
    return {
        "mu": tree_map(mom, param_specs),
        "nu": tree_map(mom, param_specs),
        "step": ParamSpec((), (), dtype=torch.int32, init="zeros"),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in sorted key order) of each leaf's sum
    of squares in float32."""
    leaves = tree_leaves(tree, _is_tensor)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32))) for l in leaves))


def adamw_update(params, grads, state, cfg: OptConfig):
    """Returns (new_params, new_state, metrics)."""
    return _update(params, grads, state, cfg, global_norm(grads))


def _update(params, grads, state, cfg: OptConfig, gnorm: torch.Tensor):
    """:func:`adamw_update` with the gradients' global norm given."""
    step = state["step"] + 1
    scale = torch.div(cfg.clip_norm, torch.clamp(gnorm, min=1e-12)).clamp(max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        mu32 = mu.to(torch.float32) * b1 + (1 - b1) * g
        nu32 = nu.to(torch.float32) * b2 + (1 - b2) * g * g
        mhat = mu32 / bc1
        vhat = nu32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        newp = (p.to(torch.float32) - lr * delta).to(p.dtype)
        return newp, mu32.to(cfg.moment_dtype), nu32.to(cfg.moment_dtype)

    flat = [tree_leaves(t, _is_tensor) for t in (params, grads, state["mu"], state["nu"])]
    if len({len(f) for f in flat}) != 1:
        raise ValueError("params, grads and the moments must have one structure; "
                         f"leaves {[len(f) for f in flat]}")
    out = {id(p): upd(p, g, m, n) for p, g, m, n in zip(*flat)}
    part = lambda i: tree_map(lambda p: out[id(p)][i], params, _is_tensor)
    new_state = {"mu": part(1), "nu": part(2), "step": step}
    return part(0), new_state, {"grad_norm": gnorm, "lr": lr}
