"""The per-event decision core of Algorithm 1.

``ControlPlane`` owns the state Algorithm 1's loop body needs — the GP
posterior, the selected/observed masks, the per-tenant incumbents — and
exposes it as a stepping API:

  * ``record_start(x)`` / ``record_failure(x)`` / ``record_observation(x, z)``
    fold one scheduler event into the state;
  * ``choose_mdmt`` / ``choose_round_robin`` / ``choose_random`` score the
    unselected pool and return the next launch (the EIrate argmax of eq. 6
    for the paper's policy).

Two construction modes, one implementation, as in the reference
(``repro.core.control_plane``):

  * :meth:`ControlPlane.from_problem` — the closed world of the offline
    simulator: every tenant known up front, exact shapes.
  * ``ControlPlane(...)`` — the open world of a long-running service:
    tenants arrive and depart (:meth:`add_tenant` / :meth:`retire_tenant`).
    Buffers are capacity-allocated (doubling growth); model and tenant
    slots are recycled through the shard layout (``repro_torch.shardgp``),
    and :meth:`compact` relocates idle tenant blocks between shard spans to
    keep the load imbalance bounded.  :meth:`state_snapshot` /
    :meth:`load_state` carry the whole state, and :meth:`reshard` moves it
    onto another shard count through them.

Scorers:

  * ``"ops"`` — the EIrate pass through ``kernels.ops.eirate`` (the CUDA
    kernel on the card, its plain version on the CPU), then the first
    argmax.  The counterpart of the reference's ``"fused"`` and ``"ops"``.
  * ``"sharded"`` — the model axis split over a mesh of shards
    (``shardgp.score.ShardedScorer``): each shard scores its slice and keeps
    a local top-k, and a global pick with the lowest-id tie-break gives the
    ``"ops"`` decision exactly, provided both planes run the same
    ``num_shards`` (the layout of the index space is part of the tie-break
    order).  ``score_kernel`` picks its route (``"eirate_topk"``, the
    default, or ``"eirate"``).

The masks, costs and incumbents are kept twice: as numpy arrays on the host
for the event bookkeeping and as tensors on ``device`` for scoring, with
the same float32 casts as the reference's device mirrors.
:meth:`choose_mdmt_batch` is the elastic device plane's scoring pass: one
class-axis EIrate launch (``kernels.ops.eirate_classes``) and a stable
per-class top-k.  A ``repro_torch.obs.Tracer`` (:meth:`set_tracer`) opens
the reference's spans, and a ``repro_torch.obs.ForensicsRecorder``
(:meth:`set_forensics`) records each decision's top candidates, taken from
the scores the decision already computed: no extra scoring launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from heapq import heappop, heappush

import numpy as np
import torch

from ..device import resolve
from ..kernels import ops
from ..kernels.ref import topk_first
from ..obs import NULL_TRACER
from ..shardgp import compact as _compact
from ..shardgp.layout import BlockPlacement, ShardLayout
from ..shardgp.score import ShardedScorer
from .ei import single_tenant_ei_scores, topk_rows_padded
from .gp import DEFAULT_JITTER, BlockIncrementalGP, make_gp
from .tenancy import Problem

SCORERS = ("ops", "sharded")

#: candidates kept per forensics record on the ops path (the sharded path
#: keeps its scorer's own top-k)
FORENSICS_TOPK = 4

_FLOOR_SDS = 5.0  # "no observation yet" sits this many prior sds below mu0


def _host(x) -> np.ndarray:
    """A tensor's values on the host (a copy, and a sync, from the card);
    host arrays pass through."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_scorer(scorer: str) -> None:
    if scorer not in SCORERS:
        raise ValueError(f"scorer must be one of {SCORERS}, got {scorer!r}")


def _fastest_models(problem: Problem, user: int, count: int) -> list[int]:
    idx = np.nonzero(problem.membership[user])[0]
    order = idx[np.argsort(problem.cost[idx], kind="stable")]
    return list(order[:count])


def no_obs_floor(problem: Problem) -> float:
    """Finite stand-in for "no observation yet": far below any plausible z,
    so unserved tenants dominate the EI sum."""
    prior_sd = float(np.sqrt(np.clip(np.diag(problem.K), 0, None).max()))
    return float(problem.mu0.min()) - _FLOOR_SDS * max(prior_sd, 1e-3)


def warm_start_queue(problem: Problem, warm_start: int) -> list[int]:
    """The initial launch queue: user-major, ``warm_start`` fastest models
    each, deduplicated keeping first occurrence (Section 6.1 protocol).
    ``warm_start=0`` yields Algorithm 1 line 1-2's prior-mean argmax per
    tenant instead."""
    pending: list[int] = []
    seen: set[int] = set()
    for u in range(problem.num_users):
        for m in _fastest_models(problem, u, warm_start):
            if m not in seen:
                seen.add(m)
                pending.append(m)
    if warm_start == 0:
        for u in range(problem.num_users):
            idx = np.nonzero(problem.membership[u])[0]
            m = int(idx[np.argmax(problem.mu0[idx])])
            if m not in seen:
                seen.add(m)
                pending.append(m)
    return pending


def tenant_warm_models(cost_block: np.ndarray, mu0_block: np.ndarray,
                       warm_start: int) -> list[int]:
    """Per-tenant warm-start picks (local indices): the ``warm_start``
    cheapest models, or the prior-mean argmax when ``warm_start == 0``.
    Concatenated tenant-major over disjoint candidate sets they give
    :func:`warm_start_queue` exactly."""
    if warm_start > 0:
        order = np.argsort(np.asarray(cost_block), kind="stable")
        return [int(i) for i in order[:warm_start]]
    return [int(np.argmax(np.asarray(mu0_block)))]


@dataclass(frozen=True)
class TenantHandle:
    """What :meth:`ControlPlane.add_tenant` returns: the tenant's slot and
    the global model ids its block occupies."""
    tenant_id: int
    models: np.ndarray  # (m,) global model indices


def _layout_meta(lay: ShardLayout) -> dict:
    return {
        "num_shards": lay.num_shards,
        "shard_capacity": lay.shard_capacity,
        "alloc_capacity": lay.alloc.capacity,
        "free": [[s, l] for s, l in lay.alloc._free],
        "blocks": {str(k): [pl.start, pl.length]
                   for k, pl in lay.blocks.items()},
    }


class ControlPlane:
    """GP update + EIrate pick, as a stepping API (module docstring)."""

    def __init__(self, rng: np.random.Generator | None = None, *,
                 jitter: float = DEFAULT_JITTER, scorer: str = "ops",
                 model_capacity: int = 64, tenant_capacity: int = 8,
                 num_shards: int | None = None, shard_topk: int = 4,
                 score_kernel: str = "eirate_topk", device=None):
        """An open-world plane with no tenant yet.  ``num_shards`` splits
        the index space into shard spans (and, with ``scorer="sharded"``,
        the scoring over a mesh); ``device`` holds the GP and the mirrors,
        and is passed through to the mesh: ``device=None`` needs one card
        per shard, an explicit device takes every shard."""
        _check_scorer(scorer)
        self.device = resolve(device)
        self.rng = rng or np.random.default_rng(0)
        self.scorer = scorer
        self._jitter = jitter
        self._dynamic = True
        self._num_models = 0        # count of LIVE models
        self._num_tenants = 0       # high-water mark of tenant slots
        self._free_tenant_slots: list[int] = []   # min-heap of retired slots
        self._mesh_device = device
        self._sharded = (ShardedScorer(num_shards, topk=shard_topk,
                                       kernel=score_kernel, device=device)
                         if scorer == "sharded" else None)
        shards = (self._sharded.num_shards if self._sharded is not None
                  else (num_shards or 1))
        cap_n = max(1, model_capacity)
        # every tenant block lives inside one shard span
        self._layout = ShardLayout(
            num_shards=shards, shard_capacity=-(-cap_n // shards))
        cap_n = self._layout.capacity
        cap_N = max(1, tenant_capacity)
        # padding entries are born selected so every chooser masks them
        self.selected = np.ones(cap_n, dtype=bool)
        self.observed = np.zeros(cap_n, dtype=bool)
        self.cost = np.ones(cap_n, dtype=np.float64)
        self.membership = np.zeros((cap_N, cap_n), dtype=bool)
        self.best = np.full(cap_N, -np.inf)
        self.tenant_live = np.zeros(cap_N, dtype=bool)
        self.model_live = np.zeros(cap_n, dtype=bool)
        self._tenant_floor_stats: dict[int, tuple[float, float]] = {}
        self._block_ids: dict[int, int] = {}
        self._no_obs_floor = 0.0
        self.gp = BlockIncrementalGP.empty(jitter, device=self.device)
        self.gp.ensure_capacity(cap_n)
        self.rr_pointer = 0
        self.tracer = NULL_TRACER
        self._forensics = None
        self._rebuild_mirrors()

    @classmethod
    def from_problem(cls, problem: Problem,
                     rng: np.random.Generator | None = None, *,
                     jitter: float = DEFAULT_JITTER, scorer: str = "ops",
                     num_shards: int | None = None, shard_topk: int = 4,
                     score_kernel: str = "eirate_topk",
                     device=None) -> "ControlPlane":
        """Closed-world construction: all tenants at t=0, exact shapes.
        Overlapping candidate sets take the dense GP engine (``make_gp``).
        Churn methods are disabled."""
        n, N = problem.num_models, problem.num_users
        _check_scorer(scorer)
        dev = resolve(device)
        gp = make_gp(problem.K, problem.mu0, problem.membership, jitter,
                     device=dev)
        return cls.closed(
            gp, selected=np.zeros(n, bool), observed=np.zeros(n, bool),
            best=np.full(N, -np.inf), cost=problem.cost,
            membership=problem.membership, rr_pointer=0,
            rng=rng or np.random.default_rng(0),
            no_obs_floor=no_obs_floor(problem), scorer=scorer,
            num_shards=num_shards, shard_topk=shard_topk,
            score_kernel=score_kernel, device=device, jitter=jitter)

    @classmethod
    def closed(cls, gp, *, selected, observed, best, cost, membership,
               rr_pointer: int, rng: np.random.Generator, no_obs_floor: float,
               scorer: str = "ops", num_shards: int | None = None,
               shard_topk: int = 4, score_kernel: str = "eirate_topk",
               device=None, jitter: float = DEFAULT_JITTER) -> "ControlPlane":
        """A closed-world plane from its state (``gp`` a GP engine on
        ``device``); :meth:`from_problem` and ``convert.control_plane``
        build theirs this way."""
        _check_scorer(scorer)
        cp = cls.__new__(cls)
        cp.device = resolve(device)
        cp.rng = rng
        cp.scorer = scorer
        cp._jitter = jitter
        cp._dynamic = False
        cp._layout = None           # closed world: no churn, no reuse
        cp._mesh_device = device
        # pads n to a shard multiple internally
        cp._sharded = (ShardedScorer(num_shards, topk=shard_topk,
                                     kernel=score_kernel, device=device)
                       if scorer == "sharded" else None)
        cp._free_tenant_slots = []
        cp.selected = np.array(selected, dtype=bool)
        cp.observed = np.array(observed, dtype=bool)
        cp.cost = np.array(cost, dtype=np.float64)
        cp.membership = np.array(membership, dtype=bool)
        cp.best = np.array(best, dtype=np.float64)
        cp._num_tenants, cp._num_models = cp.membership.shape
        cp.tenant_live = np.ones(cp._num_tenants, dtype=bool)
        cp.model_live = np.ones(cp._num_models, dtype=bool)
        cp._tenant_floor_stats = {}
        cp._block_ids = {}
        cp._no_obs_floor = float(no_obs_floor)
        cp.gp = gp
        cp.rr_pointer = rr_pointer
        cp.tracer = NULL_TRACER
        cp._forensics = None
        cp._rebuild_mirrors()
        return cp

    # ---- capacity + device-resident mirrors -------------------------------

    @property
    def num_models(self) -> int:
        """Live models (the open world recycles slots, so this counts the
        current pool, not an allocation high-water mark)."""
        return self._num_models

    @property
    def num_tenants(self) -> int:
        return self._num_tenants

    @property
    def capacity(self) -> int:
        return len(self.selected)

    def _rebuild_mirrors(self) -> None:
        """Full host -> device refresh; at construction and on churn events
        (rare next to decisions, which update the mirrors entry by entry)."""
        dev = self.device
        self._membership_t = torch.tensor(self.membership, device=dev)
        self._cost_t = torch.tensor(self.cost.astype(np.float32), device=dev)
        self._selected_t = torch.tensor(self.selected, device=dev)
        self._best_t = torch.tensor(
            self.best_effective().astype(np.float32), device=dev)
        if self._sharded is not None:
            self._sharded.refresh(self.membership, self.cost)

    def _require_dynamic(self, what: str) -> None:
        if not self._dynamic:
            raise RuntimeError(f"{what} is only supported on open-world "
                               f"ControlPlanes (not from_problem)")

    def _grow(self, need_models: int, need_tenants: int) -> None:
        cap_n, cap_N = self.capacity, self.membership.shape[0]
        new_n = cap_n
        while new_n < need_models:
            new_n *= 2
        new_N = cap_N
        while new_N < need_tenants:
            new_N *= 2
        if new_n == cap_n and new_N == cap_N:
            return
        pad_n, pad_N = new_n - cap_n, new_N - cap_N
        self.selected = np.concatenate([self.selected, np.ones(pad_n, bool)])
        self.observed = np.concatenate([self.observed, np.zeros(pad_n, bool)])
        self.cost = np.concatenate([self.cost, np.ones(pad_n)])
        self.model_live = np.concatenate([self.model_live, np.zeros(pad_n, bool)])
        grown = np.zeros((new_N, new_n), dtype=bool)
        grown[:cap_N, :cap_n] = self.membership
        self.membership = grown
        self.best = np.concatenate([self.best, np.full(pad_N, -np.inf)])
        self.tenant_live = np.concatenate(
            [self.tenant_live, np.zeros(pad_N, bool)])
        self.gp.ensure_capacity(new_n)

    def _recompute_floor(self) -> None:
        stats = [self._tenant_floor_stats[t]
                 for t in np.nonzero(self.tenant_live)[0]
                 if t in self._tenant_floor_stats]
        if not stats:
            self._no_obs_floor = 0.0
            return
        mu_min = min(s[0] for s in stats)
        sd_max = max(s[1] for s in stats)
        self._no_obs_floor = mu_min - _FLOOR_SDS * max(sd_max, 1e-3)

    # ---- tenant churn ------------------------------------------------------

    def add_tenant(self, K_block, mu0_block, cost_block) -> TenantHandle:
        """Admit one tenant: its GP block, candidate models and tenant slot
        come from the free pools when churn left any, else extend the space.
        No other tenant's GP state is touched.  The block always lands
        inside one shard span of the layout."""
        self._require_dynamic("churn")
        K_block = np.asarray(K_block, dtype=np.float64)
        mu0_block = np.asarray(mu0_block, dtype=np.float64)
        cost_block = np.asarray(cost_block, dtype=np.float64)
        m = len(mu0_block)
        if K_block.shape != (m, m) or cost_block.shape != (m,):
            raise ValueError("block shapes disagree")
        if (cost_block <= 0).any():
            raise ValueError("costs must be positive")
        tid = (heappop(self._free_tenant_slots) if self._free_tenant_slots
               else self._num_tenants)
        start = self._layout.place(tid, m)
        self._grow(self._layout.capacity, tid + 1)
        self._num_tenants = max(self._num_tenants, tid + 1)
        self._num_models += m
        ids = np.arange(start, start + m, dtype=np.int64)
        self._block_ids[tid] = self.gp.add_block(ids, K_block, mu0_block)
        self.selected[ids] = False
        self.observed[ids] = False
        self.cost[ids] = cost_block
        self.model_live[ids] = True
        self.membership[tid, ids] = True
        self.best[tid] = -np.inf
        self.tenant_live[tid] = True
        self._tenant_floor_stats[tid] = (
            float(mu0_block.min()),
            float(np.sqrt(np.clip(np.diag(K_block), 0, None).max())))
        self._recompute_floor()
        self._rebuild_mirrors()
        return TenantHandle(tenant_id=tid, models=ids)

    def retire_tenant(self, tenant_id: int) -> None:
        """Depart one tenant: its GP block is freed, its models leave the
        pool (masked selected) and their slots return to the free pool, its
        tenant slot likewise.  In-flight models of the tenant stay selected;
        their completions cannot be folded (the block is gone)."""
        self._require_dynamic("churn")
        if not self.tenant_live[tenant_id]:
            raise ValueError(f"tenant {tenant_id} is not live")
        ids = np.nonzero(self.membership[tenant_id])[0]
        self.gp.retire_block(self._block_ids.pop(tenant_id))
        self.membership[tenant_id, :] = False
        self.selected[ids] = True
        self.observed[ids] = False
        self.cost[ids] = 1.0
        self.model_live[ids] = False
        self.tenant_live[tenant_id] = False
        self.best[tenant_id] = -np.inf
        del self._tenant_floor_stats[tenant_id]
        self._layout.release(tenant_id)
        heappush(self._free_tenant_slots, tenant_id)
        self._num_models -= len(ids)
        self._recompute_floor()
        self._rebuild_mirrors()

    def in_flight_mask(self) -> np.ndarray:
        """Models launched but not yet observed (their global ids are held
        by pending completions, so compaction must not move them)."""
        return self.selected & ~self.observed & self.model_live

    def compact(self, max_imbalance: float | None = None,
                max_moves: int | None = None) -> dict[int, tuple]:
        """Rebalance live tenant blocks across shard spans until the load
        imbalance is within ``max_imbalance`` (``shardgp.compact``).  Tenants
        with in-flight trials are pinned.  ``max_moves`` bounds the
        relocations of one call.  Returns ``{tenant_id: (old_ids, new_ids)}``
        for callers that hold global model ids.  A no-op with one shard."""
        self._require_dynamic("compaction")
        if max_imbalance is None:
            max_imbalance = _compact.DEFAULT_MAX_IMBALANCE
        in_flight = self.in_flight_mask()
        movable = {
            int(t) for t in np.nonzero(self.tenant_live)[0]
            if not in_flight[self.membership[t]].any()}
        moves = _compact.plan_moves(self._layout, movable, max_imbalance,
                                    max_moves)
        first_old: dict[int, np.ndarray] = {}
        for tid, old_start, new_start in moves:
            m = self._layout.blocks[tid].length
            old_ids = np.arange(old_start, old_start + m, dtype=np.int64)
            new_ids = np.arange(new_start, new_start + m, dtype=np.int64)
            self.gp.relocate_block(self._block_ids[tid], new_ids)
            for arr, fill in ((self.selected, True), (self.observed, False),
                              (self.cost, 1.0), (self.model_live, False)):
                vals = arr[old_ids].copy()
                arr[old_ids] = fill
                arr[new_ids] = vals
            self.membership[tid, old_ids] = False
            self.membership[tid, new_ids] = True
            first_old.setdefault(tid, old_ids)
        if moves:
            self._rebuild_mirrors()
        # a block can move more than once in one pass; callers hold the
        # ORIGINAL ids, so map them to the final placement
        remap: dict[int, tuple] = {}
        for tid, old_ids in first_old.items():
            pl = self._layout.blocks[tid]
            remap[tid] = (old_ids,
                          np.arange(pl.start, pl.stop, dtype=np.int64))
        return remap

    # ---- snapshot / restore ------------------------------------------------

    def state_snapshot(self) -> tuple[dict, dict]:
        """The whole open-world state as ``(arrays, meta)``: numpy arrays
        and a JSON-able dict, the reference's format.

        The GP is stored by its recipe: per live tenant its prior block and
        its block-local observation sequence (replaying them rebuilds the
        engine exactly).  The float32 readout cache is stored verbatim with
        the dirty set, stale entries of retired blocks included."""
        self._require_dynamic("state_snapshot")
        arrays = {
            "cp/selected": self.selected.copy(),
            "cp/observed": self.observed.copy(),
            "cp/cost": self.cost.copy(),
            "cp/membership": self.membership.copy(),
            "cp/best": self.best.copy(),
            "cp/tenant_live": self.tenant_live.copy(),
            "cp/model_live": self.model_live.copy(),
            "cp/gp_mu": self.gp._mu.copy(),
            "cp/gp_var": self.gp._var.copy(),
        }
        bid_to_tid = {bid: tid for tid, bid in self._block_ids.items()}
        for tid, bid in self._block_ids.items():
            eng = self.gp._engines[bid]
            arrays[f"gp/{tid}/K"] = eng.K.cpu().numpy()
            arrays[f"gp/{tid}/mu0"] = eng.mu0.cpu().numpy()
            arrays[f"gp/{tid}/obs_idx"] = np.asarray(eng.observed, np.int64)
            arrays[f"gp/{tid}/obs_z"] = np.asarray(
                [eng._z[li] for li in eng.observed], np.float64)
        meta = {
            "num_models": self._num_models,
            "num_tenants": self._num_tenants,
            "free_tenant_slots": list(self._free_tenant_slots),
            "rr_pointer": self.rr_pointer,
            "no_obs_floor": self._no_obs_floor,
            "floor_stats": {str(t): [mn, sd] for t, (mn, sd)
                            in self._tenant_floor_stats.items()},
            "rng_state": self.rng.bit_generator.state,
            "layout": _layout_meta(self._layout),
            "gp_dirty": sorted(bid_to_tid[b] for b in self.gp._dirty),
            "gp_n": self.gp.n,
        }
        return arrays, meta

    def load_state(self, arrays: dict, meta: dict) -> None:
        """Overwrite this open-world plane with :meth:`state_snapshot`
        output (its own or the reference's), in place."""
        self._require_dynamic("load_state")
        self.selected = np.array(arrays["cp/selected"], dtype=bool)
        self.observed = np.array(arrays["cp/observed"], dtype=bool)
        self.cost = np.array(arrays["cp/cost"], dtype=np.float64)
        self.membership = np.array(arrays["cp/membership"], dtype=bool)
        self.best = np.array(arrays["cp/best"], dtype=np.float64)
        self.tenant_live = np.array(arrays["cp/tenant_live"], dtype=bool)
        self.model_live = np.array(arrays["cp/model_live"], dtype=bool)
        self._num_models = meta["num_models"]
        self._num_tenants = meta["num_tenants"]
        self._free_tenant_slots = list(meta["free_tenant_slots"])
        self.rr_pointer = meta["rr_pointer"]
        self._no_obs_floor = meta["no_obs_floor"]
        self._tenant_floor_stats = {int(t): (mn, sd) for t, (mn, sd)
                                    in meta["floor_stats"].items()}
        self.rng.bit_generator.state = meta["rng_state"]

        ml = meta["layout"]
        lay = ShardLayout(num_shards=ml["num_shards"], shard_capacity=1)
        lay.shard_capacity = ml["shard_capacity"]
        lay.alloc.capacity = ml["alloc_capacity"]
        lay.alloc._free = [(s, l) for s, l in ml["free"]]
        lay.blocks = {int(k): BlockPlacement(start, length)
                      for k, (start, length) in ml["blocks"].items()}
        self._layout = lay

        self.gp = BlockIncrementalGP.empty(self._jitter, device=self.device)
        self._block_ids = {}
        for k in ml["blocks"]:          # serialized insertion order
            tid = int(k)
            pl = lay.blocks[tid]
            ids = np.arange(pl.start, pl.stop, dtype=np.int64)
            bid = self.gp.add_block(ids, arrays[f"gp/{tid}/K"],
                                    arrays[f"gp/{tid}/mu0"])
            self._block_ids[tid] = bid
            for li, z in zip(arrays[f"gp/{tid}/obs_idx"].tolist(),
                             arrays[f"gp/{tid}/obs_z"].tolist()):
                self.gp.observe(int(ids[li]), float(z))
        self.gp.ensure_capacity(meta["gp_n"])
        # the exact cache bytes (stale entries of retired blocks included)
        # and the dirty set as of the snapshot: the next flush recomputes
        # what the uninterrupted run would have
        self.gp._mu = np.array(arrays["cp/gp_mu"], dtype=np.float32)
        self.gp._var = np.array(arrays["cp/gp_var"], dtype=np.float32)
        self.gp._dirty = {self._block_ids[t] for t in meta["gp_dirty"]}
        self._rebuild_mirrors()

    # ---- mesh shrink / regrow ----------------------------------------------

    def reshard(self, num_shards: int) -> dict[int, int]:
        """Move every resident posterior block onto a ``num_shards`` layout
        through the snapshot path: snapshot, repartition the layout
        (``ShardLayout.repartition``), scatter the per-slot arrays through
        the slot remap, and :meth:`load_state`.  Stale cache entries of
        retired blocks are dropped.

        A sharded plane rebuilds its scorer for the new mesh; at one shard
        it falls back to ``"ops"``, which decides exactly as ``"sharded"``
        does.  Returns ``{old_global_model_id: new_global_model_id}`` over
        every live block slot (empty: no-op), for callers that hold ids."""
        self._require_dynamic("reshard")
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if num_shards == self._layout.num_shards:
            return {}
        arrays, meta = self.state_snapshot()
        lay, remap = ShardLayout.repartition(self._layout.blocks, num_shards)
        new_cap = lay.capacity
        cap_N = self.membership.shape[0]
        old = np.fromiter(remap.keys(), np.int64, len(remap))
        new = np.fromiter(remap.values(), np.int64, len(remap))

        def scatter(src, fill, dtype):
            out = np.full(new_cap, fill, dtype=dtype)
            if len(old):
                out[new] = src[old]
            return out

        # padding as at construction: born selected, unobserved, unit cost,
        # not live, zeroed readout cache
        arrays["cp/selected"] = scatter(arrays["cp/selected"], True, bool)
        arrays["cp/observed"] = scatter(arrays["cp/observed"], False, bool)
        arrays["cp/cost"] = scatter(arrays["cp/cost"], 1.0, np.float64)
        arrays["cp/model_live"] = scatter(arrays["cp/model_live"], False,
                                          bool)
        arrays["cp/gp_mu"] = scatter(arrays["cp/gp_mu"], 0.0, np.float32)
        arrays["cp/gp_var"] = scatter(arrays["cp/gp_var"], 0.0, np.float32)
        mem = np.zeros((cap_N, new_cap), dtype=bool)
        if len(old):
            mem[:, new] = arrays["cp/membership"][:, old]
        arrays["cp/membership"] = mem
        # registry insertion order is kept: load_state rebuilds in it
        meta["layout"] = _layout_meta(lay)
        meta["gp_n"] = new_cap
        if self.scorer == "sharded":
            if num_shards == 1:
                self.scorer = "ops"
                self._sharded = None
            elif num_shards != self._sharded.num_shards:
                self._sharded = ShardedScorer(
                    num_shards, topk=self._sharded.topk,
                    kernel=self._sharded.kernel, device=self._mesh_device)
                self._sharded.tracer = self.tracer
        self.load_state(arrays, meta)
        return remap

    def set_tracer(self, tracer) -> None:
        """Install a ``repro_torch.obs.Tracer`` on the decision path (and on
        the sharded scorer, which opens its own pad/dispatch spans).
        Tracing is observation-only: spans never change a decision and never
        enter :meth:`state_snapshot`."""
        self.tracer = tracer
        if self._sharded is not None:
            self._sharded.tracer = tracer

    def capacity_stats(self) -> dict:
        """Host-side accounting of the posterior and the index space: GP
        stats (``resource_stats``) keyed by tenant slot, and the layout's
        per-shard occupancy.  A closed-world plane has no layout (None)."""
        gp_stats = self.gp.resource_stats()
        if "blocks" in gp_stats:
            bid_to_tid = {bid: tid for tid, bid in self._block_ids.items()}
            # closed-world blocks have no tenant slot: keep the block id
            gp_stats["tenants"] = {
                bid_to_tid.get(bid, bid): stats
                for bid, stats in gp_stats.pop("blocks").items()}
        layout = (self._layout.occupancy()
                  if self._layout is not None else None)
        return {"gp": gp_stats, "layout": layout}

    def set_forensics(self, recorder) -> None:
        """Install a ``repro_torch.obs.ForensicsRecorder`` on the decision
        path.  Observation-only: the sharded path keeps the top-k the
        decision already computes (``decide()`` is the head of
        ``decide_topk()``), and the ops path takes the top
        ``FORENSICS_TOPK`` of the EIrate vector its decision scored, by a
        stable descending sort, so the head is the decision's first argmax.
        Either way the record's copies to the host are the only work added,
        and only while a recorder is installed."""
        self._forensics = recorder

    def _base_cost(self, g: int) -> float:
        """Host-side cost of one candidate, valid across the sharded
        scorer's padded capacity (padding cost is 1.0 by convention)."""
        if self._sharded is not None and self._sharded._cost_host is not None:
            ch = self._sharded._cost_host
            if g < len(ch):
                return float(ch[g])
        return float(self.cost[g]) if g < len(self.cost) else 1.0

    def _record_forensics(self, values, gids, mu, sd, *,
                          speed: float = 1.0, overhead: float = 0.0,
                          device_class: str | None = None) -> None:
        """Feed one top-k into the forensics recorder, with the host-side
        mu/sd/cost decomposition aligned to the candidates."""
        values, gids, mu, sd = (_host(x) for x in (values, gids, mu, sd))
        n = mu.shape[0]
        eff, mu_k, sd_k = [], [], []
        for gi in gids:
            gi = int(gi)
            eff.append(self._base_cost(gi) / speed + overhead)
            mu_k.append(float(mu[gi]) if gi < n else 0.0)
            sd_k.append(float(sd[gi]) if gi < n else 0.0)
        self._forensics.on_decision(
            scorer=self.scorer, values=values, gids=gids, eff_costs=eff,
            mu=mu_k, sd=sd_k, speed=speed, device_class=device_class)

    def _record_batch_forensics(self, v, g, mu, sd, rates, overheads,
                                class_names) -> None:
        """One forensics record per class row of a batched decision (the
        (C, k) top-k the greedy assignment consumes)."""
        if self._forensics is None:
            return
        rates = np.asarray(rates, dtype=np.float64)
        overheads = np.asarray(overheads, dtype=np.float64)
        mu, sd = _host(mu), _host(sd)
        for c in range(v.shape[0]):
            name = (str(class_names[c]) if class_names is not None
                    else f"class{c}")
            self._record_forensics(v[c], g[c], mu, sd,
                                   speed=float(rates[c]),
                                   overhead=float(overheads[c]),
                                   device_class=name)

    # ---- event steps -------------------------------------------------------

    def best_effective(self) -> np.ndarray:
        return np.where(np.isfinite(self.best), self.best, self._no_obs_floor)

    def record_start(self, model: int) -> None:
        self.selected[model] = True
        self._selected_t[model] = True

    def record_failure(self, model: int) -> None:
        # the model was never observed, so it simply returns to L \ L(t)
        self.selected[model] = False
        self._selected_t[model] = False

    def record_observation(self, model: int, z: float) -> bool:
        """Fold one observation; returns True when it improved at least one
        member tenant's incumbent.  Non-finite ``z`` is rejected: a NaN here
        corrupts the incremental Cholesky and every later decision."""
        if not np.isfinite(z):
            raise ValueError(f"non-finite observation {z!r} for model "
                             f"{model}; poisoned losses must not reach the "
                             f"GP (use record_failure)")
        self.observed[model] = True
        with self.tracer.span("gp_fold", model=model):
            self.gp.observe(model, z)
        improved = False
        for u in np.nonzero(self.membership[:, model])[0]:
            if z > self.best[u] or not np.isfinite(self.best[u]):
                self.best[u] = max(z, self.best[u]) if np.isfinite(self.best[u]) else z
                self._best_t[u] = float(self.best[u])
                improved = True
        return improved

    # ---- policy decisions --------------------------------------------------

    def _posterior_host(self):
        """(mu, sd) on the host for the sharded scorer: the block engine's
        cache is there, and float32 sqrt is correctly rounded there as on
        the device, so no round trip."""
        if hasattr(self.gp, "posterior_host"):
            mu, var = self.gp.posterior_host()
            return mu, np.sqrt(var)
        return self.tracer.sync(self.gp.posterior_sd())

    def choose_mdmt(self, device_speed: float = 1.0) -> tuple[int, int] | None:
        if self.selected.all():
            return None
        tr = self.tracer
        # a disabled tracer costs one test a decision and opens no span
        traced = tr.enabled
        if self.scorer == "sharded":
            if traced:
                with tr.span("posterior", scorer="sharded"):
                    mu, sd = self._posterior_host()
                with tr.span("score", scorer="sharded"):
                    idx, score = self._score_sharded(mu, sd, device_speed)
            else:
                mu, sd = self._posterior_host()
                idx, score = self._score_sharded(mu, sd, device_speed)
            if not np.isfinite(score) or score <= -1e29:
                return None
            return idx, -1
        if traced:
            with tr.span("posterior", scorer=self.scorer):
                mu, sd = tr.sync(self.gp.posterior_sd())
        else:
            mu, sd = self.gp.posterior_sd()
        cost = self._cost_t
        if device_speed != 1.0:
            # by a tensor: CUDA divides by a host scalar through its
            # reciprocal, which would round differently from the CPU
            cost = cost / torch.full_like(cost, device_speed)
        if traced:
            with tr.span("score", scorer=self.scorer):
                scores, idx, score = self._score_ops(mu, sd, cost)
        else:
            scores, idx, score = self._score_ops(mu, sd, cost)
        if self._forensics is not None:
            # the top of the same scores, equal values in ascending id: its
            # head is the argmax above, and no scoring pass is added
            v, g = topk_first(scores, min(FORENSICS_TOPK, scores.shape[0]))
            self._record_forensics(v, g, mu, sd, speed=device_speed)
        if not np.isfinite(score) or score <= -1e29:
            return None
        return idx, -1

    def _score_sharded(self, mu, sd, device_speed: float):
        """(the sharded scorer's pick, its score); with a forensics recorder
        the decision's top-k is recorded."""
        if self._forensics is None:
            return self._sharded.decide(mu, sd, self._best_t, self.selected,
                                        device_speed)
        # decide() is the head of decide_topk(): keeping the k candidates
        # changes no decision
        v, g = (_host(x) for x in self._sharded.decide_topk(
            mu, sd, self._best_t, self.selected, device_speed))
        self._record_forensics(v, g, mu, sd, speed=device_speed)
        return int(g[0]), float(v[0])

    def _score_ops(self, mu, sd, cost):
        """(the EIrate scores, their first argmax, its score)."""
        scores = ops.eirate(mu, sd, self._best_t, self._membership_t,
                            cost, self._selected_t)
        idx = int(torch.argmax(scores))    # first maximum, as jnp.argmax
        return scores, idx, float(scores[idx])

    def choose_mdmt_batch(self, rates, overheads, k: int, *,
                          class_names=None) -> tuple[np.ndarray, np.ndarray]:
        """One scoring pass for a k-device joint assignment (DESIGN.md §11).

        ``rates``/``overheads`` carry one entry per device class present in
        the batch; class c's cost row is ``cost / rates[c] + overheads[c]``
        in float32.  Returns per-class EIrate top-k over the unselected pool
        as numpy ``(values (C, k), global ids (C, k))``, equal values in
        ascending id; the greedy device<->model solver
        (``devplane.assign``) consumes them.  With a single class at rate 1
        and overhead 0, row 0's head is bit-identical to
        :meth:`choose_mdmt`'s pick (the ``/ 1`` and ``+ 0`` are IEEE
        identities, and the class kernel shares the EIrate kernel's tenant
        sum): the batched == sequential contract.

        ``"ops"``: one launch of the class-axis EIrate kernel
        (``ops.eirate_classes``; -1e30 at selected models) and a stable
        per-row top-k.  ``"sharded"``: ``ShardedScorer.decide_topk_classes``.
        ``class_names`` (optional, len C) labels the per-class forensics
        records when a recorder is installed; it never affects scoring."""
        rates_in, overheads_in = rates, overheads
        rates = np.asarray(rates, np.float32)
        overheads = np.asarray(overheads, np.float32)
        if self.selected.all():
            # same early-out as choose_mdmt: an empty pool must not pay a
            # scoring pass (dry passes dominate idle stretches)
            return (np.full((rates.shape[0], k), -np.inf, np.float32),
                    np.zeros((rates.shape[0], k), np.int64))
        tr = self.tracer
        forensics = (rates_in, overheads_in, class_names)
        # a disabled tracer costs one test a decision and opens no span
        traced = tr.enabled
        if self.scorer == "sharded":
            if not traced:
                mu, sd = self._posterior_host()
                return self._score_topk_sharded(mu, sd, rates, overheads, k, forensics)
            with tr.span("posterior", scorer="sharded"):
                mu, sd = self._posterior_host()
            with tr.span("score_topk", scorer="sharded", k=k):
                return self._score_topk_sharded(mu, sd, rates, overheads, k, forensics)
        if traced:
            with tr.span("posterior", scorer=self.scorer):
                mu, sd = tr.sync(self.gp.posterior_sd())
        else:
            mu, sd = self.gp.posterior_sd()
        dev = self.device
        # by tensors: CUDA divides by a host scalar through its reciprocal
        rates_t = torch.from_numpy(rates).to(dev)
        over_t = torch.from_numpy(overheads).to(dev)
        cm = self._cost_t[None, :] / rates_t[:, None] + over_t[:, None]
        if not traced:
            return self._score_topk_ops(mu, sd, cm, k, forensics)
        with tr.span("score_topk", scorer=self.scorer, k=k):
            return self._score_topk_ops(mu, sd, cm, k, forensics)

    def _score_topk_sharded(self, mu, sd, rates, overheads, k: int, forensics):
        v, g = self._sharded.decide_topk_classes(
            mu, sd, self._best_t, self.selected, rates, overheads, k=k)
        v, g = v.cpu().numpy(), g.cpu().numpy()
        self._record_batch_forensics(v, g, mu, sd, *forensics)
        return v, g

    def _score_topk_ops(self, mu, sd, cm, k: int, forensics):
        scores = ops.eirate_classes(mu, sd, self._best_t, self._membership_t,
                                    cm, self._selected_t)
        v, i = topk_rows_padded(scores, k)
        v, i = v.cpu().numpy(), i.cpu().numpy()
        self._record_batch_forensics(v, i, mu, sd, *forensics)
        return v, i

    def _users_with_work(self) -> np.ndarray:
        has_work = (self.membership & ~self.selected[None, :]).any(axis=1)
        return np.nonzero(has_work)[0]

    def _own_gp_ei(self, user: int) -> int | None:
        mu, sd = self.gp.posterior_sd()
        best = self.best[user] if np.isfinite(self.best[user]) else self._no_obs_floor
        scores = single_tenant_ei_scores(
            mu, sd, torch.tensor(best, dtype=torch.float32, device=self.device),
            self._membership_t[user], self._selected_t)
        idx = int(torch.argmax(scores))
        if not np.isfinite(float(scores[idx])):
            return None
        return idx

    def choose_random(self, device_speed: float = 1.0) -> tuple[int, int] | None:
        users = self._users_with_work()
        if users.size == 0:
            return None
        u = int(self.rng.choice(users))
        m = self._own_gp_ei(u)
        return (m, u) if m is not None else None

    def choose_round_robin(self, device_speed: float = 1.0) -> tuple[int, int] | None:
        users = self._users_with_work()
        if users.size == 0:
            return None
        N = self._num_tenants
        for step in range(N):
            u = (self.rr_pointer + step) % N
            if u in users:
                self.rr_pointer = (u + 1) % N
                m = self._own_gp_ei(u)
                if m is not None:
                    return m, u
        return None

    def chooser(self, policy: str):
        """The decision callable for a policy name (``POLICIES``)."""
        return {
            "mdmt": self.choose_mdmt,
            "random": self.choose_random,
            "round_robin": self.choose_round_robin,
        }[policy]
