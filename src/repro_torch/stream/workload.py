"""Churn traces: the external event streams the streaming engine replays.

The port's copy of ``repro.stream.workload`` (numpy only): equal seeds give
equal events in both packages.

A :class:`ChurnTrace` is a time-sorted tuple of external events:

  * :class:`TenantArrive` — a tenant session starts; the event carries the
    tenant's whole TSHB block (prior covariance, prior mean, costs, and the
    ground-truth ``z`` the simulation reveals on observation);
  * :class:`TenantDepart` — the session ends (the engine retires the
    tenant's GP block and returns its unobserved models to nowhere);
  * :class:`SliceFail`   — a device slice dies for ``downtime`` seconds,
    killing its in-flight trial (the model returns to the unselected pool).

:func:`poisson_churn_trace` generates the service-provider workload the
Ease.ml setting motivates: Poisson arrivals, heavy-tailed (Pareto) session
lengths, Zipf-skewed candidate-set sizes, per-tenant Matérn-5/2 priors —
everything seeded, so traces replay bit-identically.
:func:`trace_from_problem` freezes an offline :class:`~repro_torch.core.tenancy.Problem`
into a churn-free trace (all tenants at t=0, nobody departs) — the
equivalence bridge to ``scheduler.simulate``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.tenancy import Problem, _matern_block_chol, _matern_draw


@dataclass(frozen=True)
class TenantArrive:
    at: float
    tenant_key: int
    K_block: np.ndarray      # (m, m) prior covariance over the candidate set
    mu0: np.ndarray          # (m,) prior mean
    cost: np.ndarray         # (m,) c(x), virtual seconds
    z_true: np.ndarray       # (m,) ground truth, revealed on observation

    @property
    def num_models(self) -> int:
        return len(self.mu0)


@dataclass(frozen=True)
class TenantDepart:
    at: float
    tenant_key: int


@dataclass(frozen=True)
class SliceFail:
    at: float
    slice_id: int
    downtime: float


@dataclass(frozen=True)
class DeviceJoin:
    """A new device slice arrives at runtime (scale-up / spot grant).  The
    engine appends it to the fleet — slice ids are append-only, so the
    trace generator can predict the id of the k-th join as
    ``initial_slices + k``."""
    at: float
    chips: int = 16
    speed: float = 1.0
    cls: str = "base"


@dataclass(frozen=True)
class DeviceLeave:
    """Permanent decommission of a slice: the in-flight trial dies exactly
    like a slice failure (its model returns to the unselected pool), but
    the slice never recovers."""
    at: float
    slice_id: int


@dataclass(frozen=True)
class DevicePreempt:
    """Spot-market / priority eviction: the in-flight trial is killed and
    re-queued like a slice failure, but the slice stays healthy and is
    immediately schedulable again (no downtime)."""
    at: float
    slice_id: int


@dataclass(frozen=True)
class TrialHang:
    """The trial currently running on ``slice_id`` hangs: it will never
    produce its completion.  The device stays busy forever unless trial
    supervision (``timeout_factor``) rescues it — the failure mode the
    paper's always-returns assumption excludes."""
    at: float
    slice_id: int


@dataclass(frozen=True)
class TrialPoison:
    """The trial currently running on ``slice_id`` completes on schedule but
    returns a non-finite loss (NaN) — e.g. a diverged training run.  The
    engine's GP-ingest guard must reject it instead of corrupting the
    Cholesky."""
    at: float
    slice_id: int


@dataclass(frozen=True)
class MeshShrink:
    """The scoring mesh loses devices mid-run: re-shard resident posterior
    slots onto a ``num_shards``-device mesh through the checkpoint path
    (falling back to fused scoring at ``num_shards == 1``)."""
    at: float
    num_shards: int


Event = (TenantArrive | TenantDepart | SliceFail
         | DeviceJoin | DeviceLeave | DevicePreempt
         | TrialHang | TrialPoison | MeshShrink)

# event types a ChaosTrace's seeded overlay may inject (the .twin() filter)
CHAOS_EVENT_TYPES = (SliceFail, DeviceLeave, DevicePreempt,
                     TrialHang, TrialPoison, MeshShrink)


@dataclass(frozen=True)
class ChurnTrace:
    """Time-sorted external events plus bookkeeping for telemetry."""

    events: tuple[Event, ...]
    name: str = "trace"

    def __post_init__(self):
        ats = [e.at for e in self.events]
        if ats != sorted(ats):
            raise ValueError("trace events must be time-sorted")

    @property
    def num_sessions(self) -> int:
        return sum(1 for e in self.events if isinstance(e, TenantArrive))

    @property
    def num_events(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)


def zipf_candidate_sizes(
    rng: np.random.Generator, count: int, s: float = 1.6,
    m_min: int = 2, m_max: int = 50,
) -> np.ndarray:
    """Zipf-skewed candidate-set sizes: most tenants bring a few models, a
    heavy tail brings many (clipped to [m_min, m_max])."""
    if s <= 1.0:
        raise ValueError("zipf exponent must be > 1")
    raw = rng.zipf(s, size=count)
    return np.clip(m_min * raw, m_min, m_max).astype(int)


def poisson_churn_trace(
    num_sessions: int = 200,
    arrival_rate: float = 1.0,
    seed: int = 0,
    *,
    session_scale: float = 40.0,
    pareto_alpha: float = 1.5,
    zipf_s: float = 1.6,
    m_min: int = 2,
    m_max: int = 50,
    length_scale: float = 0.2,
    kernel_variance: float = 0.04,
    cost: str = "uniform",
    num_failure_slices: int = 0,
    failure_downtime: float = 5.0,
    name: str | None = None,
) -> ChurnTrace:
    """The service-provider workload: N ≫ M tenant sessions over time.

    Arrivals are Poisson(``arrival_rate``); session lengths are Pareto
    (heavy-tailed: ``(1 + pareto(alpha)) * session_scale``); candidate-set
    sizes are Zipf-skewed; each tenant's block is a Matérn-5/2 prior with a
    ground-truth sample drawn from it (the Fig-5 generative model, per
    tenant).  ``cost`` is ``"uniform"`` (all 1) or ``"lognormal"``.
    ``num_failure_slices > 0`` sprinkles that many SliceFail events over
    slices [0, num_failure_slices) across the arrival window.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / arrival_rate, size=num_sessions)
    arrive_at = np.cumsum(gaps)
    lengths = (1.0 + rng.pareto(pareto_alpha, size=num_sessions)) * session_scale
    sizes = zipf_candidate_sizes(rng, num_sessions, zipf_s, m_min, m_max)

    # one Cholesky per distinct block size (the expensive part is shared)
    chol_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    events: list[Event] = []
    for i in range(num_sessions):
        m = int(sizes[i])
        if m not in chol_cache:
            chol_cache[m] = _matern_block_chol(m, length_scale, kernel_variance)
        K_block, L = chol_cache[m]
        z = _matern_draw(rng, L)
        if cost == "uniform":
            c = np.ones(m)
        elif cost == "lognormal":
            c = rng.lognormal(mean=0.0, sigma=0.5, size=m)
        else:
            raise ValueError(cost)
        events.append(TenantArrive(
            at=float(arrive_at[i]), tenant_key=i, K_block=K_block,
            mu0=np.zeros(m), cost=c, z_true=z))
        events.append(TenantDepart(
            at=float(arrive_at[i] + lengths[i]), tenant_key=i))

    if num_failure_slices > 0:
        horizon = float(arrive_at[-1])
        for s in range(num_failure_slices):
            events.append(SliceFail(
                at=float(rng.uniform(0.0, horizon)), slice_id=s,
                downtime=failure_downtime))

    events.sort(key=lambda e: e.at)
    return ChurnTrace(
        events=tuple(events),
        name=name or f"poisson-{num_sessions}sessions-s{seed}")


def device_churn_trace(
    num_sessions: int = 200,
    arrival_rate: float = 1.0,
    seed: int = 0,
    *,
    initial_slices: int = 8,
    join_classes: tuple[tuple[str, int, float], ...] = (("base", 16, 1.0),),
    join_rate: float = 0.0,
    leave_rate: float = 0.0,
    preempt_rate: float = 0.0,
    device_seed: int | None = None,
    name: str | None = None,
    **tenant_kw,
) -> ChurnTrace:
    """Tenant churn *plus* device churn, both seeded (DESIGN.md §11).

    The tenant side is exactly :func:`poisson_churn_trace` (same seed =>
    bit-identical tenant events); the device side overlays three Poisson
    processes across the arrival window:

      * joins at ``join_rate`` — each draws a ``(cls, chips, speed)`` from
        ``join_classes`` uniformly; the k-th join will occupy slice id
        ``initial_slices + k`` (ids are append-only);
      * leaves at ``leave_rate`` — each picks a uniformly random slice that
        still exists (initial or joined, not yet left);
      * preempts at ``preempt_rate`` — each picks a uniformly random
        not-yet-left slice (the engine tolerates a preempt racing a leave).

    ``device_seed`` defaults to ``seed + 1`` so the device overlay never
    perturbs the tenant stream.
    """
    base = poisson_churn_trace(num_sessions, arrival_rate, seed, **tenant_kw)
    events: list[Event] = list(base.events)
    # span the overlay over the ARRIVAL window (same convention as the
    # SliceFail sprinkling), not the heavy-tailed depart horizon — Pareto
    # session tails would otherwise inflate device churn by orders of
    # magnitude after work has stopped arriving
    horizon = max((e.at for e in events if isinstance(e, TenantArrive)),
                  default=0.0)
    rng = np.random.default_rng(seed + 1 if device_seed is None else device_seed)

    dev_events: list[Event] = []
    for rate, kind in ((join_rate, "join"), (leave_rate, "leave"),
                       (preempt_rate, "preempt")):
        if rate <= 0:
            continue
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rate))
            if t >= horizon:
                break
            dev_events.append((t, kind))
    dev_events.sort(key=lambda e: e[0])

    # replay the device population to give leaves/preempts valid targets
    alive = list(range(initial_slices))
    next_id = initial_slices
    out: list[Event] = []
    for t, kind in dev_events:
        if kind == "join":
            cls, chips, speed = join_classes[int(rng.integers(len(join_classes)))]
            out.append(DeviceJoin(at=t, chips=chips, speed=float(speed),
                                  cls=cls))
            alive.append(next_id)
            next_id += 1
        elif kind == "leave":
            if len(alive) <= 1:
                continue            # never drain the fleet entirely
            sid = alive.pop(int(rng.integers(len(alive))))
            out.append(DeviceLeave(at=t, slice_id=sid))
        else:
            if not alive:
                continue
            sid = alive[int(rng.integers(len(alive)))]
            out.append(DevicePreempt(at=t, slice_id=sid))

    events.extend(out)
    events.sort(key=lambda e: e.at)
    return ChurnTrace(
        events=tuple(events),
        name=name or f"devchurn-{num_sessions}sessions-s{seed}")


@dataclass(frozen=True)
class ChaosTrace(ChurnTrace):
    """A churn trace with a seeded chaos overlay (hang / poison / flake /
    device-loss / mesh-shrink schedules).  ``twin()`` strips every
    chaos-class event, recovering the failure-free trace the benchmark's
    bounded-degradation claim is measured against."""

    def twin(self, name: str | None = None) -> ChurnTrace:
        keep = tuple(e for e in self.events
                     if not isinstance(e, CHAOS_EVENT_TYPES))
        return ChurnTrace(events=keep, name=name or f"{self.name}-twin")


def chaos_trace(
    num_sessions: int = 50,
    arrival_rate: float = 1.0,
    seed: int = 0,
    *,
    initial_slices: int = 4,
    hang_rate: float = 0.0,
    poison_rate: float = 0.0,
    flake_rate: float = 0.0,
    loss_rate: float = 0.0,
    flake_downtime: float = 5.0,
    shrink_at: float | None = None,
    shrink_shards: int | None = None,
    chaos_seed: int | None = None,
    name: str | None = None,
    **tenant_kw,
) -> ChaosTrace:
    """Tenant churn plus a seeded chaos overlay (DESIGN.md §16).

    The tenant side is exactly :func:`poisson_churn_trace` (same seed =>
    bit-identical tenant events); the chaos side overlays independent
    Poisson processes across the ARRIVAL window (the ``device_churn_trace``
    convention):

      * hangs at ``hang_rate``     — ``TrialHang`` on a random alive slice;
      * poisons at ``poison_rate`` — ``TrialPoison`` on a random alive slice;
      * flakes at ``flake_rate``   — ``SliceFail`` (self-healing after
        ``flake_downtime``) on a random alive slice;
      * losses at ``loss_rate``    — ``DeviceLeave`` (permanent) on a random
        alive slice, never draining the fleet below one device.

    ``shrink_at``/``shrink_shards`` optionally schedule one deterministic
    :class:`MeshShrink`.  ``chaos_seed`` defaults to ``seed + 2`` (distinct
    from ``device_churn_trace``'s ``seed + 1``) so the overlay never
    perturbs the tenant stream and composes with device churn.
    """
    base = poisson_churn_trace(num_sessions, arrival_rate, seed, **tenant_kw)
    events: list[Event] = list(base.events)
    horizon = max((e.at for e in events if isinstance(e, TenantArrive)),
                  default=0.0)
    rng = np.random.default_rng(seed + 2 if chaos_seed is None else chaos_seed)

    chaos: list[tuple[float, str]] = []
    for rate, kind in ((hang_rate, "hang"), (poison_rate, "poison"),
                       (flake_rate, "flake"), (loss_rate, "loss")):
        if rate <= 0:
            continue
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rate))
            if t >= horizon:
                break
            chaos.append((t, kind))
    chaos.sort(key=lambda e: e[0])

    # replay the device population so losses keep targeting slices that
    # still exist (and hangs/poisons/flakes aim at alive slices too)
    alive = list(range(initial_slices))
    out: list[Event] = []
    for t, kind in chaos:
        if not alive:
            break
        sid = alive[int(rng.integers(len(alive)))]
        if kind == "hang":
            out.append(TrialHang(at=t, slice_id=sid))
        elif kind == "poison":
            out.append(TrialPoison(at=t, slice_id=sid))
        elif kind == "flake":
            out.append(SliceFail(at=t, slice_id=sid,
                                 downtime=flake_downtime))
        else:
            if len(alive) <= 1:
                continue            # never drain the fleet entirely
            alive.remove(sid)
            out.append(DeviceLeave(at=t, slice_id=sid))
    if shrink_at is not None:
        if shrink_shards is None or shrink_shards < 1:
            raise ValueError("shrink_at requires shrink_shards >= 1")
        out.append(MeshShrink(at=float(shrink_at),
                              num_shards=int(shrink_shards)))

    events.extend(out)
    events.sort(key=lambda e: e.at)
    return ChaosTrace(
        events=tuple(events),
        name=name or f"chaos-{num_sessions}sessions-s{seed}")


def trace_from_problem(problem: Problem, at: float = 0.0) -> ChurnTrace:
    """Freeze an offline Problem into a churn-free trace: every tenant
    arrives at ``at`` in tenant order, nobody departs.  Requires disjoint
    candidate sets (every generator in ``tenancy.py`` qualifies).  Replaying
    this trace reproduces ``scheduler.simulate`` exactly (tests/test_torch_stream.py).
    """
    mem = np.asarray(problem.membership, bool)
    if (mem.sum(axis=0) != 1).any():
        raise ValueError("trace_from_problem requires disjoint candidate sets")
    events = []
    for u in range(problem.num_users):
        ids = np.nonzero(mem[u])[0]
        events.append(TenantArrive(
            at=at, tenant_key=u,
            K_block=problem.K[np.ix_(ids, ids)],
            mu0=problem.mu0[ids], cost=problem.cost[ids],
            z_true=problem.z_true[ids]))
    return ChurnTrace(events=tuple(events), name=f"{problem.name}-frozen")
