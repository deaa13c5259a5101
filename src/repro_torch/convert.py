"""Carries GP and control-plane state across into the port.

Each function takes plain numpy arrays and Python values — what a caller
reads off a reference object with ``np.asarray`` — and builds the port's
counterpart on a given device, so that two implementations can be put in
the same mid-episode state and asked for the same next decision.  An
open-world plane's ``state_snapshot()`` already is such arrays and values:
:func:`control_plane_from_snapshot` loads one.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.control_plane import ControlPlane
from .core.gp import DEFAULT_JITTER, BlockIncrementalGP, IncrementalGP


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
