"""The sharded scoring plane: GP-EI decisions with the model axis split
over a mesh of devices.

Counterpart of ``repro.shardgp.score``.  One decision is the batched
EIrate over every live model and the argmax over the unselected pool.  The
model axis is split into ``S`` equal contiguous slices, one per shard of
the mesh (``repro_torch.launch.mesh.make_scoring_mesh``):

  1. each shard scores its slice and reduces it to a local top-k (values
     and global ids) on its own device;
  2. the S*k candidates are copied to ``mesh[0]`` and concatenated in shard
     order;
  3. the global pick: the top-k of the candidates, the lowest global id
     winning among equal values.

JAX runs this as one ``shard_map`` program; the port keeps a single
controller that launches each shard's work in turn, with no collective and
no ``torch.distributed``.  Several shards may share a device (an explicit
``device=`` puts them all on it), which is how the CPU tests and a
one-card run drive S = 4.

Exactness: a score depends only on its own column, so splitting changes no
value; each local top-k and the global pick order equal values by ascending
position (``kernels.ref.topk_first``, a stable sort, never ``torch.topk``),
and the gathered list is in (shard, rank) order, ascending in global id at
equal value.  So the pick is the first argmax of the unsharded score
vector, tie-break included.  Both planes must see the same index space
(``layout.py``).

Per-shard state (membership columns, costs) is device-resident and
refreshed only on churn (:meth:`ShardedScorer.refresh`); per-decision
inputs (mu, sd, selected) are padded to the capacity on the host and
uploaded each call.  Padding is born selected with unit cost.

Two score routes, each a hand-written CUDA kernel on the card and its plain
version on the CPU (``kernels.ops``):

  ``"eirate_topk"``  the EIrate top-k kernel (``csrc/ei_topk.cu``), the
                     counterpart of the reference's ``"pallas_topk"``; the
                     default;
  ``"eirate"``       the EIrate kernel (``csrc/ei_score.cu``), then the local
                     top-k in PyTorch; the counterpart of ``"pallas"``.

The reference's ``"xla"`` route has no counterpart: on the card every
route is a kernel.

:meth:`ShardedScorer.readout_decide_topk` runs readout -> score -> pick
over an explicit W in three phases (each shard's GP readout kernel, each
shard's score route, the gather and pick);
:meth:`~ShardedScorer.readout_decide_topk_phased` runs the same phases with
a tracer span and a synchronize around each, and
:meth:`~ShardedScorer.phase_times` times each phase alone: the reference's
phase-split programs, for attributing a decision's time.

The elastic device plane's per-class decision
(:meth:`ShardedScorer.decide_topk_classes`) takes the class-axis EIrate
kernel (``csrc/ei_classes.cu``) on each shard's slice, whatever the route:
the reference has no fused classes + top-k kernel either.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ref import topk_first
from ..launch.mesh import make_scoring_mesh
from ..obs import NULL_TRACER

SCORE_KERNELS = ("eirate_topk", "eirate")

#: how each logical axis of the scoring state maps onto the mesh: the model
#: axis is split over the shards; tenants (N ~ 10^2-10^3, small next to
#: |L| ~ 10^5-10^6) and the observation axis of the readout's W are
#: replicated, so the readout needs no cross-shard reduction
SCORING_RULES = {"models": "shard", "tenants": None, "obs": None}

_NEG_INF = float("-inf")


def _global_pick(allv: torch.Tensor, allg: torch.Tensor, k: int):
    """Top-k of the gathered (..., S*k) candidates (per row for classes),
    whose order is (shard, rank)-major, ascending global id at equal value:
    the lowest global id wins ties, as the unsharded argmax."""
    v, pos = topk_first(allv, k)
    return v, allg.gather(-1, pos)


def _local_topk(scores: torch.Tensor, k: int, base: int):
    """Top-k along the last axis of one shard's scores (a vector, or one row
    per class) as (values, global ids).  A slice smaller than k yields what
    it has, padded with (-inf, 0)."""
    kk = min(k, scores.shape[-1])
    v, li = topk_first(scores, kk)
    g = li + base
    if kk < k:
        pad = scores.shape[:-1] + (k - kk,)
        v = torch.cat([v, torch.full(pad, _NEG_INF, dtype=v.dtype,
                                     device=v.device)], dim=-1)
        g = torch.cat([g, torch.zeros(pad, dtype=g.dtype, device=g.device)],
                      dim=-1)
    return v, g


def _score_local(mu, sd, best, member, cost, selected, kernel: str, k: int,
                 base: int):
    """One shard's slice -> (k,) local best values and global ids."""
    if kernel == "eirate_topk":
        v, li = ops.eirate_topk(mu, sd, best, member, cost, selected, k=k)
        return v, li.long() + base
    scores = ops.eirate(mu, sd, best, member, cost, selected)
    return _local_topk(scores, k, base)


class ShardedScorer:
    """Device-resident per-shard mirrors and the decision entry points.

    ``num_shards`` and ``device`` go to :func:`make_scoring_mesh`:
    ``device=None`` needs one card per shard, an explicit ``device`` puts
    every shard on it."""

    def __init__(self, num_shards: int | None = None, *, topk: int = 4,
                 kernel: str = "eirate_topk", device=None):
        if kernel not in SCORE_KERNELS:
            raise ValueError(
                f"kernel must be one of the port's routes {SCORE_KERNELS}, "
                f"got {kernel!r}")
        self.mesh = make_scoring_mesh(num_shards, device)
        self.num_shards = len(self.mesh)
        self.topk = max(1, topk)
        self.kernel = kernel
        self.tracer = NULL_TRACER   # installed by ControlPlane.set_tracer
        self._member: list[torch.Tensor] | None = None   # (N_cap, C) per shard
        self._cost: list[torch.Tensor] | None = None     # (C,) per shard
        self._cost_host = None  # (cap,) host twin: forensics recovers
        #                         EI = score x cost without a device sync
        self._cap = 0

    # ---- per-shard mirrors -------------------------------------------------

    def _padded_cap(self, n: int) -> int:
        s = self.num_shards
        return ((n + s - 1) // s) * s

    def _span(self, s: int) -> slice:
        c = self._cap // self.num_shards
        return slice(s * c, (s + 1) * c)

    def refresh(self, membership: np.ndarray, cost: np.ndarray) -> None:
        """Full host -> device refresh of the churn-rate state (membership
        columns and costs), padded to a shard multiple."""
        n = cost.shape[0]
        cap = self._padded_cap(n)
        mem = np.zeros((membership.shape[0], cap), dtype=bool)
        mem[:, :n] = membership
        c = np.ones(cap, dtype=np.float32)
        c[:n] = cost
        self._cap = cap
        self._member = [torch.from_numpy(np.ascontiguousarray(mem[:, self._span(s)]))
                        .to(dev) for s, dev in enumerate(self.mesh)]
        self._cost = [torch.from_numpy(c[self._span(s)].copy()).to(dev)
                      for s, dev in enumerate(self.mesh)]
        self._cost_host = c

    def _pad(self, x, fill, dtype) -> np.ndarray:
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        x = np.asarray(x)
        if x.shape[0] == self._cap:
            return x.astype(dtype, copy=False)
        out = np.full(self._cap, fill, dtype=dtype)
        out[:x.shape[0]] = x
        return out

    def _per_shard(self, x) -> list[torch.Tensor]:
        """Shard s's slice of a (cap,) host array or tensor on ``mesh[s]``.
        Shards that share a device share one upload."""
        full: dict[torch.device, torch.Tensor] = {}
        out = []
        for s, dev in enumerate(self.mesh):
            if dev not in full:
                t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                full[dev] = t.to(dev)
            out.append(full[dev][self._span(s)])
        return out

    def _replicated(self, x) -> list[torch.Tensor]:
        t = torch.as_tensor(x, dtype=torch.float32)
        full = {dev: t.to(dev) for dev in set(self.mesh)}
        return [full[dev] for dev in self.mesh]

    def _costs(self, speed: float) -> list[torch.Tensor]:
        if speed == 1.0:
            return self._cost
        # by a tensor: CUDA divides by a host scalar through its reciprocal
        return [c / torch.full_like(c, speed) for c in self._cost]

    def _gather_pick(self, cands, k: int):
        home = self.mesh[0]
        allv = torch.cat([v.to(home) for v, _ in cands], dim=-1)
        allg = torch.cat([g.to(home) for _, g in cands], dim=-1)
        return _global_pick(allv, allg, k)

    def _require_refresh(self) -> None:
        if self._member is None:
            raise RuntimeError("refresh() must run before a decision")

    # ---- decisions ---------------------------------------------------------

    def decide_topk(self, mu, sd, best, selected, speed: float = 1.0):
        """(values (k,), global ids (k,)) of the global EIrate top-k, as
        tensors on ``mesh[0]``."""
        self._require_refresh()
        tr = self.tracer
        # a disabled tracer costs one test and opens no span
        if not tr.enabled:
            return self._decide_staged(self._stage(mu, sd, best, selected), speed)
        with tr.span("pad_upload"):
            staged = self._stage(mu, sd, best, selected)
        with tr.span("shard_decide", shards=self.num_shards,
                     kernel=self.kernel, k=self.topk):
            return tr.sync(self._decide_staged(staged, speed))

    def _stage(self, mu, sd, best, selected):
        """The decision's inputs on the shards' devices: (mus, sds, sels,
        bests)."""
        return (*self._upload(mu, sd, selected), self._replicated(best))

    def _decide_staged(self, staged, speed: float):
        mus, sds, sels, bests = staged
        costs = self._costs(speed)
        c = self._cap // self.num_shards
        cands = [_score_local(mus[s], sds[s], bests[s], self._member[s],
                              costs[s], sels[s], self.kernel, self.topk, s * c)
                 for s in range(self.num_shards)]
        return self._gather_pick(cands, self.topk)

    def _upload(self, mu, sd, selected):
        """The per-decision inputs padded to the capacity, one slice per
        shard on its device."""
        return (self._per_shard(self._pad(mu, 0.0, np.float32)),
                self._per_shard(self._pad(sd, 0.0, np.float32)),
                self._per_shard(self._pad(selected, True, bool)))

    def decide(self, mu, sd, best, selected,
               speed: float = 1.0) -> tuple[int, float]:
        """The decision the control plane takes: the global argmax (lowest
        id among equal scores) and its score, read in one copy."""
        v, g = self.decide_topk(mu, sd, best, selected, speed)
        v0, g0 = torch.stack((v[0].double(), g[0].double())).tolist()
        return int(g0), float(v0)

    def decide_topk_classes(self, mu, sd, best, selected, rates, overheads,
                            k: int | None = None):
        """Per-device-class global EIrate top-k for the joint batched
        assignment: ``(values (C, k), global ids (C, k))`` as tensors on
        ``mesh[0]``, one row per class in ``rates``/``overheads`` (cost row
        c = cost / rate_c + overhead_c, float32).  ``k`` defaults to
        ``self.topk``; a k-device batch passes k = batch size.

        Per shard: the cost matrix of its slice, one class-axis EIrate
        launch (``ops.eirate_classes``) and a stable local top-k per row.
        The S*k candidates of each class are copied to ``mesh[0]`` in
        (shard, rank) order and a stable sort per row picks the lowest
        global id among equal values, as the unsharded per-row top-k."""
        self._require_refresh()
        k = self.topk if k is None else max(1, k)
        tr = self.tracer
        # a disabled tracer costs one test and opens no span
        if not tr.enabled:
            return self._decide_classes_staged(
                self._stage_classes(mu, sd, best, selected, rates, overheads), k)
        with tr.span("pad_upload"):
            staged = self._stage_classes(mu, sd, best, selected, rates, overheads)
        with tr.span("shard_decide", shards=self.num_shards,
                     kernel="eirate_classes", k=k):
            return tr.sync(self._decide_classes_staged(staged, k))

    def _stage_classes(self, mu, sd, best, selected, rates, overheads):
        return (*self._stage(mu, sd, best, selected),
                self._replicated(np.asarray(rates, np.float32)),
                self._replicated(np.asarray(overheads, np.float32)))

    def _decide_classes_staged(self, staged, k: int):
        mus, sds, sels, bests, rates, overs = staged
        c = self._cap // self.num_shards
        cands = []
        for s in range(self.num_shards):
            # by tensors: CUDA divides by a host scalar through its reciprocal
            cm = (self._cost[s][None, :] / rates[s][:, None] + overs[s][:, None])
            scores = ops.eirate_classes(mus[s], sds[s], bests[s],
                                        self._member[s], cm, sels[s])
            cands.append(_local_topk(scores, k, s * c))
        return self._gather_pick(cands, k)

    def readout_decide_topk(self, W, alpha, mu0, kdiag, best, selected,
                            speed: float = 1.0):
        """Readout, score and pick over an explicit (k_obs, cap) W: each
        shard runs the GP readout kernel on its column slice of W (a strided
        view where W lies on the shard's device, no copy), then scores and
        reduces it.  The length of ``mu0``, ``kdiag`` and ``selected`` must
        be the refreshed capacity (pad upstream).  Every input is on its
        device before the first launch: a host upload after it would wait
        for the card."""
        ins = self._readout_inputs(W, alpha, mu0, kdiag)
        rest = self._score_inputs(best, selected, speed)
        posts = self._readout_phase(*ins)
        return self._gather_pick(self._score_phase(posts, *rest), self.topk)

    def readout_decide_topk_phased(self, W, alpha, mu0, kdiag, best,
                                   selected, speed: float = 1.0):
        """The same pipeline as :meth:`readout_decide_topk` and the same
        launches, run as three phases — readout (the GP readout kernel a
        shard), local score and top-k (the score route a shard), and the
        copy of the candidates to ``mesh[0]`` with the global pick — each
        closed under a ``tracer.span`` with a synchronize (when the tracer
        is enabled), so the tracer attributes the decision's wall time
        phase by phase.  The pick is :meth:`readout_decide_topk`'s: both
        are the same three phases, this one with the syncs between them.
        Each phase's span also holds the per-shard slicing of its own
        inputs, which the reference's phase programs do inside
        ``shard_map``."""
        tr = self.tracer
        with tr.span("readout", shards=self.num_shards):
            posts = self._readout_phase(*self._readout_inputs(W, alpha, mu0, kdiag))
            tr.sync([t for p in posts for t in p])
        with tr.span("score_topk", shards=self.num_shards, k=self.topk):
            cands = self._score_phase(posts, *self._score_inputs(best, selected, speed))
            tr.sync([t for c in cands for t in c])
        with tr.span("gather_pick", shards=self.num_shards, k=self.topk):
            return tr.sync(self._gather_pick(cands, self.topk))

    def phase_times(self, W, alpha, mu0, kdiag, best, selected,
                    speed: float = 1.0, *, iters: int = 10,
                    warmup: int = 2) -> dict:
        """Mean wall µs per phase of the phased pipeline, each phase timed
        alone (``obs.profile.time_us_blocked``: a synchronize after every
        call) on inputs the phase before computed once, outside the timed
        region, so no phase hides inside another's launches."""
        from ..obs.profile import time_us_blocked
        W, alphas, mu0s, kds = self._readout_inputs(W, alpha, mu0, kdiag)
        rest = self._score_inputs(best, selected, speed)
        posts = self._readout_phase(W, alphas, mu0s, kds)
        cands = self._score_phase(posts, *rest)
        return {
            "readout_us": time_us_blocked(
                lambda: [t for p in self._readout_phase(W, alphas, mu0s, kds)
                         for t in p], iters=iters, warmup=warmup),
            "score_us": time_us_blocked(
                lambda: [t for c in self._score_phase(posts, *rest)
                         for t in c], iters=iters, warmup=warmup),
            "gather_us": time_us_blocked(
                lambda: self._gather_pick(cands, self.topk),
                iters=iters, warmup=warmup),
        }

    def _readout_inputs(self, W, alpha, mu0, kdiag):
        """The readout phase's inputs: (W, alpha per shard, mu0 slices,
        kdiag slices).  alpha is uploaded once per device, as
        :meth:`_replicated` does."""
        self._require_refresh()
        if W.shape[1] != self._cap:
            raise ValueError(f"W has {W.shape[1]} columns, the scorer's "
                             f"capacity is {self._cap}")
        full = {dev: alpha.to(dev) for dev in set(self.mesh)}
        return (W, [full[dev] for dev in self.mesh], self._per_shard(mu0),
                self._per_shard(kdiag))

    def _score_inputs(self, best, selected, speed):
        """The score phase's inputs past the posterior: (best, costs,
        selected), one per shard."""
        return (self._replicated(best), self._costs(speed),
                self._per_shard(torch.as_tensor(selected)))

    def _readout_phase(self, W, alphas, mu0s, kds):
        """(mu, sd) of each shard's slice: the GP readout kernel on its
        column slice of W, on the shard's device."""
        return [ops.gp_readout(W[:, self._span(s)].to(dev), alphas[s],
                               mu0s[s], kds[s], emit_sd=True)
                for s, dev in enumerate(self.mesh)]

    def _score_phase(self, posts, bests, costs, sels):
        """Each shard's local top-k candidates from its posterior slice."""
        c = self._cap // self.num_shards
        return [_score_local(mu, sd, bests[s], self._member[s], costs[s],
                             sels[s], self.kernel, self.topk, s * c)
                for s, (mu, sd) in enumerate(posts)]
