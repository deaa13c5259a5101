"""The training step: loss -> gradients (autograd) -> clip -> AdamW.

Counterpart of ``repro.train.train_step``.  The reference takes
``jax.value_and_grad`` of ``forward_loss``; here autograd differentiates the
same function on the models' plain route (``use_pallas=False``, the
configs' default; the kernel route has no backward pass and raises), and
each block is recomputed in the backward pass as ``cfg.remat`` says.

``rules`` (an ``repro_torch.sharding.AxisRules``) reaches the models' sharding
constraints: with the state and the batch as DTensors (placed by
``sharding.shardings_for_tree``) and a mesh current
(``sharding.mesh_context``), one call is one SPMD step on every rank of the
mesh, its data and tensor parallelism the rules' own.  With None it is the
one-device step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.model import ModelConfig, forward_loss, model_specs
from ..models.spec import tree_leaves, tree_map
from ..sharding.rules import placed_like
from .optimizer import OptConfig, adamw_state_specs, adamw_update


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


class TrainState(NamedTuple):
    params: dict
    opt: dict


def train_state_specs(cfg: ModelConfig, opt_cfg: OptConfig) -> TrainState:
    ps = model_specs(cfg)
    return TrainState(params=ps, opt=adamw_state_specs(ps, opt_cfg))


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, rules=None):
    """Returns ``train_step(state, batch) -> (new_state, metrics)``, metrics
    ``{grad_norm, lr, loss}`` as 0-d tensors.  ``batch`` holds ``tokens``
    and ``labels`` on the parameters' device.  The state passed in is not
    modified."""

    def train_step(state: TrainState, batch: dict):
        params = tree_map(lambda p: p.detach().requires_grad_(), state.params,
                          _is_tensor)
        leaves = tree_leaves(params, _is_tensor)
        loss = forward_loss(params, batch, cfg, rules)
        grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        grads = tree_map(lambda p: grads[id(p)], params, _is_tensor)
        with torch.no_grad():
            new_params, new_opt, metrics = adamw_update(params, grads,
                                                        state.opt, opt_cfg)
            new_state = TrainState(params=new_params, opt=new_opt)
            if rules is not None:
                # the state keeps its placements (the reference's
                # out_shardings); a no-op on plain tensors
                new_state = placed_like(new_state, state)
        return new_state, dict(metrics, loss=loss.detach())

    return train_step
