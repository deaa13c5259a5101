"""Gaussian-process posterior over a finite model set.

The paper (Supplemental A) conditions a GP prior ``GP(mu(x), k(x, x'))`` on
noise-free observations of a growing set of models.  Two engines:

* :func:`posterior_masked` — one-shot posterior over *all* models given an
  observation mask.  O(n^3); the oracle for the incremental engine.

* :class:`IncrementalGP` — the event-driven engine the scheduler uses.  It
  keeps ``W = L^{-1} K[obs, :]`` and ``alpha = L^{-1} (z_obs - mu0_obs)``
  in float32 buffers preallocated at size n, updated in place, so that
  appending one observation costs O(k * n) and the posterior over all n
  models is one readout pass (``kernels.ops.gp_readout``: the CUDA kernel
  on the card, its plain version on the CPU).

The fold sums over the k observed rows in ascending order, one rounded
product and one rounded sum at a time, with a correctly rounded square
root, so the buffers come out bit-equal on the CPU and on the card.  Observation noise is zero in the paper's
setting; ``jitter`` keeps the Cholesky numerically PSD.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve
from ..kernels import ops
from ..kernels.ref import rn

DEFAULT_JITTER = 1e-6


def posterior_masked(K, mu0, z, mask, jitter: float = DEFAULT_JITTER):
    """Posterior mean/variance over all n models given masked observations.

    Unobserved rows/cols are replaced by identity rows, so the Cholesky of
    the padded matrix holds the Cholesky of ``K[obs, obs]`` in the observed
    rows and the identity rows are inert (their RHS entries are zeroed).
    Returns (mu_post, var_post), each (n,).
    """
    n = K.shape[0]
    m = mask.to(K.dtype)
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    A = K * (m[:, None] * m[None, :]) + eye * (1.0 - m) + eye * (jitter * m)
    L = torch.linalg.cholesky(A)
    rhs = m * (z - mu0)
    alpha = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    V = m[:, None] * K  # column x holds K[obs, x] with unobserved rows zeroed
    W = torch.linalg.solve_triangular(L, V, upper=False)
    mu_post = mu0 + V.T @ alpha
    var_post = torch.diagonal(K) - torch.sum(W * W, dim=0)
    return mu_post, torch.clamp_min(var_post, 0.0)


def _append_step(W, alpha, diag_acc, K_row, idx: int, z_val, mu0_val, k: int,
                 jitter):
    """One incremental Cholesky/posterior update, in place on the buffers.

    W:        (n, n) buffer; rows [0, k) hold L^{-1} K[obs, :].
    alpha:    (n,) buffer; entries [0, k) hold L^{-1} (z_obs - mu0_obs).
    diag_acc: (n,) running sum of W^2 over observed rows.
    Returns the pivot ``d2`` (the Schur complement of the new row), a 0-d
    tensor left on the device.
    """
    # l = L^{-1} K[obs, new] is exactly column idx of W[:k]
    l = W[:k, idx]
    lw = torch.zeros_like(K_row)        # l @ W[:k], folded row by row
    la = torch.zeros_like(K_row[0])     # l . alpha[:k]
    for r in range(k):
        lw = lw + l[r] * W[r]
        la = la + l[r] * alpha[r]
    d2 = K_row[idx] + jitter - lw[idx]  # lw[idx] = l . l
    d = rn(torch.sqrt, torch.maximum(d2, jitter))
    w_new = (K_row - lw) / d
    W[k] = w_new
    alpha[k] = (z_val - mu0_val - la) / d
    diag_acc += w_new * w_new
    return d2


class IncrementalGP:
    """Incremental zero-noise GP posterior over a fixed finite model set."""

    def __init__(self, K, mu0, jitter: float = DEFAULT_JITTER, *, device=None):
        dev = resolve(device)
        self.device = dev
        # float32 at the boundary, as the reference's jnp.asarray (x64 off)
        self.K = torch.from_numpy(np.array(K, dtype=np.float32)).to(dev)
        self.mu0 = torch.from_numpy(np.array(mu0, dtype=np.float32)).to(dev)
        n = self.K.shape[0]
        if self.K.shape != (n, n):
            raise ValueError(f"K must be square, got {tuple(self.K.shape)}")
        if self.mu0.shape != (n,):
            raise ValueError(f"mu0 must be ({n},), got {tuple(self.mu0.shape)}")
        self.n = n
        self.jitter = torch.tensor(jitter, dtype=torch.float32, device=dev)
        self._W = torch.zeros((n, n), dtype=torch.float32, device=dev)
        self._alpha = torch.zeros(n, dtype=torch.float32, device=dev)
        self._diag_acc = torch.zeros(n, dtype=torch.float32, device=dev)
        self._kdiag = torch.diagonal(self.K).contiguous()
        self._k = 0
        self.observed: list[int] = []
        self._z: dict[int, float] = {}
        # pivot d² of the most recent fold, left on the device
        self.last_d2 = None

    def observe(self, idx: int, z_val: float) -> None:
        """Condition on z(model idx) = z_val.  O(k * n)."""
        if idx in self._z:
            raise ValueError(f"model {idx} already observed")
        if not math.isfinite(z_val):
            # a NaN/±inf fold would corrupt every later posterior readout
            raise ValueError(f"non-finite observation {z_val!r} for "
                             f"model {idx}")
        z = torch.full((), z_val, dtype=torch.float32, device=self.device)
        self.last_d2 = _append_step(
            self._W, self._alpha, self._diag_acc, self.K[idx], idx, z,
            self.mu0[idx], self._k, self.jitter)
        self._k += 1
        self.observed.append(idx)
        self._z[idx] = float(z_val)

    @property
    def num_observed(self) -> int:
        return self._k

    def resource_stats(self) -> dict:
        """Analytic byte/observation accounting of this engine's buffers:
        ``alloc_bytes`` is the preallocated footprint (W and K (n, n), alpha,
        diag_acc and mu0 (n,)), ``active_bytes`` the Cholesky-occupied share
        (rows [0, k) of W and k entries of alpha).  Host arithmetic only."""
        item = self.K.element_size()
        n, k = self.n, self._k
        return {
            "models": n,
            "obs": k,
            "alloc_bytes": (2 * n * n + 3 * n) * item,
            "active_bytes": (k * n + k) * item,
            "dtype_bytes": item,
        }

    def _readout(self, emit_sd: bool):
        k = self._k
        return ops.gp_readout(self._W[:k], self._alpha[:k], self.mu0,
                              self._kdiag, emit_sd=emit_sd)

    def posterior(self):
        """(mu, var) over all n models: one readout pass over W[:k]."""
        return self._readout(emit_sd=False)

    def posterior_sd(self):
        """(mu, sd): the square root rides the readout's epilogue."""
        return self._readout(emit_sd=True)


class BlockIncrementalGP:
    """Incremental GP specialized to block-diagonal priors.

    Each "model" of the paper's workloads is an (algorithm, dataset) pair,
    so tenants' candidate sets are disjoint and K is block diagonal:
    observations for one tenant never move another tenant's posterior.
    Each block owns an :class:`IncrementalGP`; a host float32 readout cache
    holds the posterior of every model, and only blocks that folded an
    observation since the last readout ("dirty") are read again.

    Blocks are also the unit of tenant churn: a block is appended
    (:meth:`add_block`), retired (:meth:`retire_block`) or moved to other
    global indices (:meth:`relocate_block`) without touching any other
    block.  Retired entries keep their last values in the readout cache
    (callers mask them); relocation zeroes the vacated entries.  Both
    follow the reference, because a state snapshot stores those bytes.
    """

    def __init__(self, K=None, mu0=None, blocks: list | None = None,
                 jitter: float = DEFAULT_JITTER, *, device=None):
        """With ``K``, one block per entry of ``blocks`` (a partition of the
        models); without, an empty engine that :meth:`add_block` fills."""
        self.device = resolve(device)
        self._jitter = jitter
        self.n = 0
        self._blocks: dict[int, np.ndarray] = {}
        self._engines: dict[int, IncrementalGP] = {}
        self._next_block_id = 0
        self._local: dict[int, tuple[int, int]] = {}
        self._mu = np.zeros(0, np.float32)
        self._var = np.zeros(0, np.float32)
        self._dirty: set[int] = set()
        self.observed: list[int] = []
        self._z: dict[int, float] = {}
        self.last_d2 = None     # pivot d² of the most recent fold
        if K is None:
            return
        K = np.asarray(K)
        mu0 = np.asarray(mu0, dtype=K.dtype)
        n = K.shape[0]
        if blocks is None:
            raise ValueError("static construction requires blocks")
        idx = [np.asarray(b, dtype=np.int64) for b in blocks]
        seen = np.concatenate(idx)
        if len(seen) != n or len(set(seen.tolist())) != n:
            raise ValueError("blocks must partition the model set")
        for b in idx:
            self.add_block(b, K[np.ix_(b, b)], mu0[b])

    @classmethod
    def empty(cls, jitter: float = DEFAULT_JITTER, *,
              device=None) -> "BlockIncrementalGP":
        """An instance with no tenants yet (the open-world control plane)."""
        return cls(jitter=jitter, device=device)

    def ensure_capacity(self, n_cap: int) -> None:
        """Grow the cached readout to ``n_cap`` entries (padding: mu 0, var 0)."""
        if n_cap <= self.n:
            return
        grow = n_cap - self.n
        self._mu = np.concatenate([self._mu, np.zeros(grow, np.float32)])
        self._var = np.concatenate([self._var, np.zeros(grow, np.float32)])
        self.n = n_cap

    def add_block(self, indices, K_block, mu0_block) -> int:
        """Register one tenant's covariance block at the given global model
        indices; no other block is touched.  Returns the block id."""
        b = np.asarray(indices, dtype=np.int64)
        K_block = np.asarray(K_block)
        mu0_block = np.asarray(mu0_block, dtype=K_block.dtype)
        m = len(b)
        if K_block.shape != (m, m) or mu0_block.shape != (m,):
            raise ValueError("block shapes disagree")
        clash = [int(g) for g in b if int(g) in self._local]
        if clash:
            raise ValueError(f"indices already owned by a block: {clash}")
        bid = self._next_block_id
        self._next_block_id += 1
        self.ensure_capacity(int(b.max()) + 1)
        self._blocks[bid] = b
        self._engines[bid] = IncrementalGP(K_block, mu0_block, self._jitter,
                                           device=self.device)
        for li, g in enumerate(b.tolist()):
            self._local[int(g)] = (bid, li)
        self._mu[b] = mu0_block.astype(np.float32)
        self._var[b] = np.clip(np.diag(K_block), 0, None).astype(np.float32)
        self._dirty.discard(bid)
        return bid

    def retire_block(self, block_id: int) -> None:
        """Drop one block: its engine is freed and its models stop accepting
        observations.  Its cached readout entries go stale (callers mask
        them)."""
        b = self._blocks.pop(block_id)
        self._engines.pop(block_id)
        self._dirty.discard(block_id)
        for g in b.tolist():
            del self._local[int(g)]

    def relocate_block(self, block_id: int, new_indices) -> None:
        """Move a live block to new global indices (index-space compaction).
        The engine works in block-local coordinates, so this is bookkeeping:
        remap global -> local, move the cached readout values, and zero the
        vacated entries (mu 0, var 0, the padding convention)."""
        old = self._blocks[block_id]
        new = np.asarray(new_indices, dtype=np.int64)
        if new.shape != old.shape:
            raise ValueError("relocation must preserve the block size")
        own = set(old.tolist())
        clash = [int(g) for g in new
                 if int(g) in self._local and int(g) not in own]
        if clash:
            raise ValueError(f"target indices owned by a block: {clash}")
        self.ensure_capacity(int(new.max()) + 1)
        for g in old.tolist():
            del self._local[int(g)]
        for li, g in enumerate(new.tolist()):
            self._local[int(g)] = (block_id, li)
        mu_b, var_b = self._mu[old].copy(), self._var[old].copy()
        self._mu[old] = 0.0
        self._var[old] = 0.0
        self._mu[new] = mu_b
        self._var[new] = var_b
        self._blocks[block_id] = new

    @staticmethod
    def blocks_from_membership(K, membership, atol: float = 0.0) -> list | None:
        """Tenant partition if candidate sets are disjoint and K has no
        cross-block mass; None if the structure doesn't hold."""
        membership = np.asarray(membership, bool)
        if (membership.sum(axis=0) != 1).any():
            return None
        blocks = [np.nonzero(membership[i])[0] for i in range(membership.shape[0])]
        K = np.asarray(K)
        mask = np.zeros_like(K, dtype=bool)
        for b in blocks:
            mask[np.ix_(b, b)] = True
        if np.abs(K[~mask]).max(initial=0.0) > atol:
            return None
        return blocks

    def observe(self, idx: int, z_val: float) -> None:
        if not math.isfinite(z_val):
            raise ValueError(f"non-finite observation {z_val!r} for "
                             f"model {idx}")
        if idx not in self._local:
            raise KeyError(f"model {idx} belongs to no block")
        bi, li = self._local[idx]
        self._engines[bi].observe(li, z_val)
        self.last_d2 = self._engines[bi].last_d2
        self._dirty.add(bi)
        self.observed.append(idx)
        self._z[idx] = float(z_val)

    @property
    def num_observed(self) -> int:
        return len(self.observed)

    def resource_stats(self) -> dict:
        """Per-block and aggregate accounting: ``blocks`` maps block id to
        its engine's :meth:`IncrementalGP.resource_stats`; the aggregate adds
        the host readout cache (float32 mu and var over the capacity)."""
        blocks = {bid: eng.resource_stats()
                  for bid, eng in sorted(self._engines.items())}
        return {
            "blocks": blocks,
            "num_blocks": len(blocks),
            "capacity": self.n,
            "obs_total": sum(b["obs"] for b in blocks.values()),
            "alloc_bytes": sum(b["alloc_bytes"] for b in blocks.values()),
            "active_bytes": sum(b["active_bytes"] for b in blocks.values()),
            "readout_bytes": 2 * self.n * 4,
        }

    def _flush(self) -> None:
        # one readout and one device-to-host copy per dirty block
        for bi in self._dirty:
            mu_b, var_b = self._engines[bi].posterior()
            b = self._blocks[bi]
            self._mu[b] = mu_b.cpu().numpy()
            self._var[b] = var_b.cpu().numpy()
        self._dirty.clear()

    def posterior(self):
        self._flush()
        return (torch.tensor(self._mu, device=self.device),
                torch.tensor(self._var, device=self.device))

    def posterior_host(self):
        """(mu, var) as the engine's own host float32 buffers (read-only by
        convention).  The sharded scorer takes these and ``np.sqrt`` of var
        (correctly rounded, as ``rn(torch.sqrt, .)`` is) without a round
        trip through the device."""
        self._flush()
        return self._mu, self._var

    def posterior_sd(self):
        mu, var = self.posterior()
        return mu, rn(torch.sqrt, var)


def make_gp(K, mu0, membership=None, jitter: float = DEFAULT_JITTER, *,
            device=None):
    """Pick the block engine when the tenant structure allows it."""
    if membership is not None:
        blocks = BlockIncrementalGP.blocks_from_membership(K, membership)
        if blocks is not None and len(blocks) > 1:
            return BlockIncrementalGP(K, mu0, blocks, jitter, device=device)
    return IncrementalGP(K, mu0, jitter, device=device)
