"""Carries GP, control-plane and model state across into the port.

Each function takes plain numpy arrays and Python values — what a caller
reads off a reference object with ``np.asarray`` — and builds the port's
counterpart on a given device, so that two implementations can be put in
the same mid-episode state and asked for the same next decision.  An
open-world plane's ``state_snapshot()`` already is such arrays and values:
:func:`control_plane_from_snapshot` loads one.  :func:`model_params` and
:func:`model_config` carry a model's parameters and configuration, so that
both packages run the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.control_plane import ControlPlane
from .core.gp import DEFAULT_JITTER, BlockIncrementalGP, IncrementalGP
from .models.model import ModelConfig
from .models.moe import MoEConfig
from .models.spec import tree_map
from .models.ssm import SSMConfig


def incremental_gp(*, W, alpha, diag_acc, k, K, mu0, observed, z,
                   jitter: float = DEFAULT_JITTER, device=None) -> IncrementalGP:
    """An :class:`IncrementalGP` holding the given buffers: ``W`` (n, n),
    ``alpha`` and ``diag_acc`` (n,), ``k`` observations, the prior ``K``
    and ``mu0``, and the observed model indices with their values ``z``."""
    gp = IncrementalGP(K, mu0, jitter, device=device)
    for buf, src in ((gp._W, W), (gp._alpha, alpha), (gp._diag_acc, diag_acc)):
        src = np.array(src, np.float32)          # a writable copy
        if src.shape != tuple(buf.shape):
            raise ValueError(f"buffer of shape {src.shape}, expected "
                             f"{tuple(buf.shape)}")
        buf.copy_(torch.from_numpy(src))
    observed = [int(i) for i in observed]
    if len(observed) != int(k):
        raise ValueError(f"{len(observed)} observed indices for k = {k}")
    gp._k = int(k)
    gp.observed = observed
    gp._z = {i: float(v) for i, v in zip(observed, z)}
    return gp


def block_gp(*, blocks, engines, mu, var, dirty, observed, z,
             jitter: float = DEFAULT_JITTER, device=None) -> BlockIncrementalGP:
    """A :class:`BlockIncrementalGP` from its blocks in block-id order:
    ``blocks[b]`` the global model indices of block b, ``engines[b]`` the
    keyword arguments of :func:`incremental_gp` for its engine (block-local
    indices); ``mu`` and ``var`` the host readout cache, ``dirty`` the ids of
    blocks folded since the last readout, ``observed``/``z`` the global
    observation log."""
    gp = BlockIncrementalGP(jitter=jitter, device=device)
    for b, eng in zip(blocks, engines):
        bid = gp.add_block(b, eng["K"], eng["mu0"])
        gp._engines[bid] = incremental_gp(**eng, jitter=jitter, device=device)
    gp._mu = np.array(mu, dtype=np.float32)
    gp._var = np.array(var, dtype=np.float32)
    gp.n = len(gp._mu)
    gp._dirty = {int(b) for b in dirty}
    gp.observed = [int(i) for i in observed]
    gp._z = {int(i): float(v) for i, v in zip(observed, z)}
    return gp


def control_plane(gp, *, selected, observed, best, cost, membership,
                  rr_pointer, rng_state, no_obs_floor,
                  device=None) -> ControlPlane:
    """A closed-world :class:`ControlPlane` around ``gp`` (built by one of
    the functions above) with the given masks, incumbents (``best``, -inf
    where a tenant has no observation), costs, membership, round-robin
    pointer and numpy ``bit_generator.state``."""
    return ControlPlane.closed(gp, selected=selected, observed=observed,
                               best=best, cost=cost, membership=membership,
                               rr_pointer=int(rr_pointer),
                               rng=_generator(rng_state),
                               no_obs_floor=no_obs_floor, device=device)


def control_plane_from_snapshot(arrays: dict, meta: dict, *,
                                jitter: float = DEFAULT_JITTER,
                                scorer: str = "ops",
                                num_shards: int | None = None,
                                shard_topk: int = 4,
                                score_kernel: str = "eirate_topk",
                                device=None) -> ControlPlane:
    """An open-world :class:`ControlPlane` in the state of a reference
    plane's ``state_snapshot()`` (numpy arrays and a JSON-able dict, the
    format both packages write).  With ``num_shards=None`` the layout's
    shard count is the snapshot's.  The plane rebuilds each tenant's GP by
    replaying its observations and keeps the snapshot's readout cache, so
    from here it decides as the plane that wrote the snapshot."""
    if num_shards is None:
        num_shards = meta["layout"]["num_shards"]
    cp = ControlPlane(_generator(meta["rng_state"]), jitter=jitter,
                      scorer=scorer, num_shards=num_shards,
                      shard_topk=shard_topk, score_kernel=score_kernel,
                      device=device)
    cp.load_state(arrays, meta)
    return cp


def _generator(rng_state: dict) -> np.random.Generator:
    """A numpy Generator in the given ``bit_generator.state``."""
    bitgen = getattr(np.random, rng_state["bit_generator"])()
    bitgen.state = rng_state
    return np.random.Generator(bitgen)


def tensor(a, device=None) -> torch.Tensor:
    """A numpy array (bfloat16 included) or scalar as a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes: numpy has no bfloat16 of its own
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def model_params(tree, device=None):
    """The reference's parameter (or cache) tree with each leaf, a numpy
    array, as a tensor on ``device``: the same nested dicts and key paths,
    NamedTuples kept."""
    return tree_map(lambda a: tensor(a, device), tree)


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}
# the reference's knobs that have no meaning in the port: its lax.scan
# unrolls (the port's layer stack and SSD scan are Python loops)
_NOT_PORTED_FIELDS = ("unroll_layers", "unroll")


def _torch_dtype(d) -> torch.dtype:
    return d if isinstance(d, torch.dtype) else _TORCH_DTYPES[np.dtype(d).name]


def model_config(fields: dict) -> ModelConfig:
    """The port's :class:`ModelConfig` from the fields of a reference
    ``ModelConfig`` (``{f.name: getattr(cfg, f.name)}``): dtypes mapped to
    torch's, the ``ssm`` and ``moe`` NamedTuples to the port's, the
    ``use_pallas`` switches and ``remat`` kept, and the reference's
    ``lax.scan`` unrolls dropped."""
    f = {k: v for k, v in fields.items() if k not in _NOT_PORTED_FIELDS}
    f["compute_dtype"] = _torch_dtype(f.get("compute_dtype", torch.bfloat16))
    f["param_dtype"] = _torch_dtype(f.get("param_dtype", torch.float32))
    if f.get("ssm") is not None:
        s = f["ssm"]
        s = s._asdict() if hasattr(s, "_asdict") else dict(s)
        f["ssm"] = SSMConfig(**{k: v for k, v in s.items()
                                if k not in _NOT_PORTED_FIELDS})
    if f.get("moe") is not None:
        m = f["moe"]
        f["moe"] = MoEConfig(**(m._asdict() if hasattr(m, "_asdict") else dict(m)))
    return ModelConfig(**f)
