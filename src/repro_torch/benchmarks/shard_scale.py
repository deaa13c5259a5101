"""Sharded scoring plane at scale: decision latency vs |L| and shard count.

The port of the JAX package's ``benchmarks/shard_scale.py``.  Three
measurements:

* ``shard_decide_L{n}_S{s}`` — one full decision (readout -> EIrate ->
  global pick) over |L| live models split into s shards, through
  ``ShardedScorer.readout_decide_topk``: each shard runs the GP readout
  (kernel 1) on its column slice of the (k_obs, n) W buffer, scores it
  with the EIrate top-k kernel (kernel 3), and the S x k candidates are
  gathered for the global pick.  Strong scaling: fixed |L|, growing s.

* ``shard_weak_L{n}_S{s}`` — weak scaling: |L| = per_shard * s, so each
  shard's slice stays constant; ``eff`` is t(S=1)/t(S) (1.0 = perfect).

* ``shard_compaction_L{n}`` — index-space compaction pause: a churned
  control plane (half the tenants retired, skewed spans) timed through one
  full ``compact()`` rebalance + mirror refresh.

One controller, one card.  The reference clips {1, 2, 4, 8} to the visible
JAX devices (its committed rows used 8 forced host devices sharing one
CPU).  The port's scoring mesh with an explicit device puts every logical
shard on it (``launch.mesh.make_scoring_mesh``), so here S runs over all of
(1, 2, 4, 8) and every shard is a slice on the same card: the rows measure
a single controller walking S shard slices in turn on one H100, not an
S-card mesh.  As in the reference, the W buffer and the per-model vectors
are placed on the card before the clock starts (the service's hot loop
keeps them there), so the scorer's per-shard tensors are views of them,
and alpha and the incumbents come from the host each call; each call is
waited for.

|L| = 1M is gated behind BENCH_SHARD_1M=1 (the W buffer alone is
k_obs * 1M * 4 bytes).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import ControlPlane
from ..core.tenancy import _matern_block_chol
from ..device import resolve
from ..shardgp import ShardedScorer
from . import common
from .common import emit, time_us, timed

K_OBS = 64          # observed-set rows of the synthetic W readout buffer
TOPK = 4


def _mesh_sizes() -> list[int]:
    """Shard counts of the sweep: all of them, every shard on one device."""
    return [1, 2, 4, 8]


def _sizes() -> list[int]:
    if common.FAST:
        return [2048]
    sizes = [10_000, 100_000]
    if os.environ.get("BENCH_SHARD_1M", "0") == "1":
        sizes.append(1_000_000)
    return sizes


def _synthetic_state(n: int, num_tenants: int, rng: np.random.Generator):
    """A service-scale scoring state with a plausible posterior: W rows are
    damped random directions (so var = kdiag - sum W^2 stays positive),
    one owner per model (the dynamic plane's invariant)."""
    W = (rng.standard_normal((K_OBS, n)) * 0.05).astype(np.float32)
    alpha = rng.standard_normal(K_OBS).astype(np.float32)
    mu0 = np.zeros(n, dtype=np.float32)
    kdiag = (0.04 + (W * W).sum(axis=0)).astype(np.float32)
    best = rng.uniform(-0.5, 0.5, num_tenants).astype(np.float32)
    owner = rng.integers(0, num_tenants, size=n)
    member = np.zeros((num_tenants, n), dtype=bool)
    member[owner, np.arange(n)] = True
    cost = rng.uniform(0.5, 2.0, n).astype(np.float32)
    selected = rng.random(n) < 0.1
    return W, alpha, mu0, kdiag, best, member, cost, selected


def _placed(W, alpha, mu0, kdiag, best, selected, device):
    """The decision's arguments as the reference passes them: W and the
    per-model vectors (mu0, kdiag, selected) already on ``device``, as the
    service's hot loop keeps them; alpha (k_obs) and the tenants' incumbents
    from the host, uploaded by each call."""
    def put(x):
        return torch.from_numpy(x).to(device)
    return (put(W), torch.from_numpy(alpha), put(mu0), put(kdiag), best,
            put(selected))


def _setup(n: int, shards: int, device=None):
    """The scoring state at |L| = n on a ``shards``-way mesh of one device:
    ``(scorer, (W, alpha, mu0, kdiag, best, selected))`` as
    :func:`_placed` places them, so a timing measures the decision, not
    the uploads of the (k_obs, n) buffer and the vectors."""
    dev = resolve(device)
    rng = np.random.default_rng(0)
    num_tenants = max(8, min(256, n // 64))
    cap = ((n + shards - 1) // shards) * shards
    W, alpha, mu0, kdiag, best, member, cost, selected = _synthetic_state(
        cap, num_tenants, rng)
    sc = ShardedScorer(shards, topk=TOPK, device=dev)
    sc.refresh(member, cost)
    return sc, _placed(W, alpha, mu0, kdiag, best, selected, dev)


def _bench_decide(n: int, shards: int, iters: int, device=None) -> float:
    """µs per readout -> score -> pick decision at |L| = n on ``shards``."""
    sc, args = _setup(n, shards, device)
    return time_us(sc.readout_decide_topk, *args, iters=iters, warmup=2,
                   sync=True)


def bench_strong_and_weak_scaling(device=None) -> None:
    iters = 5 if common.FAST else 20
    meshes = _mesh_sizes()
    base_weak: dict[int, float] = {}

    for n in _sizes():
        base = None
        for s in meshes:
            us = _bench_decide(n, s, iters, device)
            if base is None:
                base = us
            emit(f"shard_decide_L{n}_S{s}", us, live_models=n, shards=s,
                 k_obs=K_OBS, topk=TOPK, speedup=f"{base / us:.2f}")

    per_shard = 2048 if common.FAST else 25_000
    for s in meshes:
        n = per_shard * s
        us = _bench_decide(n, s, iters, device)
        if s == 1:
            base_weak[per_shard] = us
        eff = base_weak[per_shard] / us
        emit(f"shard_weak_L{n}_S{s}", us, live_models=n, shards=s,
             per_shard=per_shard, eff=f"{eff:.2f}")


def bench_compaction_pause(device=None) -> None:
    """Wall-clock of one compact() rebalance on a churned control plane."""
    dev = resolve(device)
    tenants = 16 if common.FAST else 128
    m = 16
    shards = max(_mesh_sizes())
    K_block, _ = _matern_block_chol(m, 0.2, 0.04)
    cp = ControlPlane(np.random.default_rng(0), model_capacity=tenants * m,
                      tenant_capacity=tenants, num_shards=shards, device=dev)
    handles = [cp.add_tenant(K_block, np.zeros(m), np.ones(m))
               for _ in range(tenants)]
    rng = np.random.default_rng(1)
    # one observation per tenant (the layout spreads blocks across spans,
    # so tenant t's ids come from its handle, not t*m arithmetic)
    for h in handles:
        g = int(h.models[rng.integers(m)])
        cp.record_start(g)
        cp.record_observation(g, float(rng.uniform()))
    # retire every other tenant -> skewed spans, lots of movable blocks
    for t in range(0, tenants, 2):
        cp.retire_tenant(t)
    pause_s, remap = timed(cp.compact, 1.05)
    emit(f"shard_compaction_L{tenants * m}", pause_s * 1e6,
         tenants_live=tenants // 2, moves=len(remap), shards=shards,
         imbalance_after=f"{cp._layout.imbalance():.2f}")


def main(device=None) -> None:
    bench_strong_and_weak_scaling(device)
    bench_compaction_pause(device)


if __name__ == "__main__":
    common.run_standalone("torch_shard_scale", main, __doc__)
