"""Batched synchronous-slot episode engine: many TSHB episodes in one call.

The event-driven simulator in ``scheduler.py`` runs one episode through a
host-Python heap loop, with a decision read back to the host at every
event.  This module steps a batch of B episodes together as tensors with a
leading episode axis: one step processes exactly one device *slot* per
episode (the next device to free), folds its observation into the
block-local GP, decides and launches, and the per-episode control flow is
masks (``torch.where``).  The loop runs exactly ``T = n + Mmax`` steps (the
static length of the reference's ``lax.scan``) and reads nothing back to
the host until it ends: on the card the whole sweep is one stream of
launches (steps 1 to T - 1 replayed from one CUDA graph), and results
reach the host once.  Each episode is a spec
(seed, policy, device count, device-speed vector, optional ``z_true``).

Exactness (DESIGN.md §6): for the deterministic policies (``mdmt``,
``round_robin``) the engine replays the port's event-driven simulator trial
for trial (same models, devices, hints and launch order; times in float32,
as the reference's), on the CPU and on the card, because each step does the
event engine's arithmetic in its order:

* the slot with the minimal (finish time, launch sequence) key is popped,
  the first index on ties (``argmin``);
* the fold is ``gp._append_step``'s, block-local.  That recurrence sums
  ``l . W[:k]`` and ``l . alpha[:k]`` over the observed rows in ascending
  order, one rounded product and one rounded sum at a time, and the readout
  (kernel 1 and ``ref.gp_readout_ref``) sums ``alpha[r] W[r]`` and
  ``W[r]^2`` the same way.  With ``l = W[:k, i]`` every one of those sums is
  a running sum of a product of two entries of the same row, so the engine
  keeps the running sums instead of W: ``P = sum_r W[r] (x) W[r]`` (so
  ``l . W = P[i]`` and ``diag(P)`` is ``diag_acc``) and ``dot = sum_r
  alpha[r] W[r]`` (so ``l . alpha = dot[i]`` and ``mu = mu0 + dot``), each
  updated by one elementwise multiply and one add a step: bit-equal to the
  row loop, no matrix product (whose order differs between devices);
* square roots are ``rn(torch.sqrt, .)`` and EI is ``ref.expected_improvement``,
  with disjoint candidate sets the multi-tenant EI sum (eq. 4) is the owner
  tenant's EI, so one pass serves the EIrate argmax of ``mdmt`` (cost
  divided by the freed device's speed, as ``ControlPlane.choose_mdmt``
  divides it) and the per-tenant baselines' argmaxes (first index).

The ``random`` baseline draws the reference's own stream: JAX's threefry2x32
``PRNGKey(spec.seed)``, one ``key, sub = split(key)`` a step, and
``categorical(sub, logits)`` with ``logits`` 0 where a tenant still has work
and -inf elsewhere, i.e. the first argmax of ``gumbel(sub)`` over those
tenants (``jax_threefry_partitionable``'s bit layout, JAX's float32 uniform
construction, ``-log(-log(u))`` with each log in float64 rounded once).  The
keys are chained on the host before the loop (integers, exact); the
uniforms and Gumbels are made on the device ``_GUMBEL_CHUNK`` steps at a
time, so no (B, T, N) buffer exists and nothing is read back.  It matches
the reference's trial sequences, and the card the CPU's; it matches the
event engine (another stream) in distribution only.  ``decisions`` keeps
the reference's formula (``active & ~use_pending``), which differs from the
event engine's count by O(M) at the end of an episode (DESIGN.md §6).  The
regret curves are integrated in the loop as in the reference; the sum over
tenants runs as a fixed pairwise tree, so it is equal on the CPU and the
card and within float32 rounding of the reference's.

Structural requirement: tenant candidate sets must be disjoint, equal-sized
and laid out tenant-major (model ``g`` belongs to tenant ``g // m``), with a
block-diagonal prior ``K``; ``simulate_batch`` raises ``ValueError``
otherwise.  Per-episode state is O(N m^2).  Not supported (use
``scheduler.simulate``): device failures, a finite ``horizon``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time as _time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from ..kernels.ref import expected_improvement, ftz, rn
from ..obs.trace import NULL_TRACER, Tracer
from .control_plane import no_obs_floor, warm_start_queue
from .gp import DEFAULT_JITTER
from .scheduler import POLICIES, SimResult, TrialRecord
from .tenancy import Problem

_IDLE_SEQ = np.iinfo(np.int32).max
_POLICY_ID = {p: i for i, p in enumerate(POLICIES)}  # mdmt=0, rr=1, random=2


@dataclass(frozen=True, eq=False)
class EpisodeSpec:
    """One episode of a batched sweep.

    ``device_speeds`` defaults to all-ones; ``z_true`` (length ``n``)
    overrides the problem's ground truth, which is how many-seed synthetic
    sweeps (fresh GP sample per seed, shared prior) batch into one call.
    (``eq=False``: the ndarray field would make the generated ``__eq__`` /
    ``__hash__`` raise; identity semantics are what callers need anyway.)
    """

    policy: str = "mdmt"
    num_devices: int = 1
    seed: int = 0
    device_speeds: tuple[float, ...] | None = None
    z_true: np.ndarray | None = None

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {self.policy!r}")
        if self.num_devices < 1:
            raise ValueError("num_devices must be >= 1")
        if self.device_speeds is not None and len(self.device_speeds) != self.num_devices:
            raise ValueError("device_speeds must have num_devices entries")


@dataclass
class BatchResult:
    """Per-episode trial logs + regret curves for a batch of B episodes.

    Trial arrays are in launch order (the same order ``scheduler.simulate``
    appends trials); step arrays are in event-time order (one row per step;
    ``obs_model < 0`` marks steps that observed nothing).
    """

    problem: Problem
    specs: tuple[EpisodeSpec, ...]
    warm_start: int
    # (B, n) launch-ordered trial logs
    trial_model: np.ndarray
    trial_user: np.ndarray      # user hint: -2 warm start, -1 mdmt global, else tenant
    trial_device: np.ndarray
    trial_start: np.ndarray
    trial_end: np.ndarray
    trial_z: np.ndarray
    # (B, T) event-ordered step logs
    obs_model: np.ndarray
    obs_time: np.ndarray
    inst_regret: np.ndarray     # mean per-user gap right after each step
    cum_regret: np.ndarray      # Regret_t at each observation step
    # (B,) accounting
    decisions: np.ndarray
    end_time: np.ndarray
    inst0: np.ndarray = None    # (B,) t=0 mean per-user gap (regret clamp)
    wall_seconds: float = 0.0   # the call's wall clock, see simulate_batch

    @property
    def num_episodes(self) -> int:
        return self.trial_model.shape[0]

    def episode_result(self, i: int) -> SimResult:
        """Convert episode ``i`` to a :class:`scheduler.SimResult` so the
        exact host-side metrics in ``regret.py`` apply unchanged.

        When the spec overrides ``z_true``, the returned result carries a
        problem rebuilt around that override, so ``regret.py``'s
        ``z_star``/``worst`` are consistent with the logged observations.
        """
        spec = self.specs[i]
        problem = self.problem
        if spec.z_true is not None:
            problem = dataclasses.replace(
                problem, z_true=np.asarray(spec.z_true, problem.z_true.dtype))
        trials = [
            TrialRecord(
                model=int(self.trial_model[i, j]),
                user_hint=int(self.trial_user[i, j]),
                device=int(self.trial_device[i, j]),
                start=float(self.trial_start[i, j]),
                end=float(self.trial_end[i, j]),
                z=float(self.trial_z[i, j]),
            )
            for j in range(self.trial_model.shape[1])
            if self.trial_model[i, j] >= 0
        ]
        return SimResult(
            problem=problem, policy=spec.policy,
            num_devices=spec.num_devices, trials=trials,
            end_time=float(self.end_time[i]), decisions=int(self.decisions[i]),
            decision_seconds=0.0)

    def time_to_instantaneous(self, threshold: float) -> np.ndarray:
        """(B,) first event time the mean per-user gap drops to <= threshold
        (matches ``RegretCurves.time_to_instantaneous``; inf if never)."""
        B = self.num_episodes
        out = np.full(B, np.inf)
        valid = self.obs_model >= 0
        hit = (self.inst_regret <= threshold) & valid
        for i in range(B):
            idx = np.nonzero(hit[i])[0]
            if idx.size:
                out[i] = float(self.obs_time[i, idx[0]])
        # the t=0 point (pre-observation gap) can already satisfy the bar
        out[self.inst0 <= threshold] = 0.0
        return out


# ---------------------------------------------------------------------------
# host-side structure checks
# ---------------------------------------------------------------------------

def _block_shape(problem: Problem) -> tuple[int, int]:
    """(N, m) if the problem is tenant-major block structured, else raise."""
    mem = np.asarray(problem.membership, bool)
    N, n = mem.shape
    if (mem.sum(axis=0) != 1).any():
        raise ValueError(
            "simulate_batch requires disjoint tenant candidate sets "
            "(every model owned by exactly one tenant)")
    sizes = mem.sum(axis=1)
    if (sizes != sizes[0]).any():
        raise ValueError("simulate_batch requires equal-sized candidate sets")
    m = int(sizes[0])
    for i in range(N):
        if not mem[i, i * m:(i + 1) * m].all():
            raise ValueError(
                "simulate_batch requires tenant-major model layout "
                "(model g owned by tenant g // m)")
    K = np.asarray(problem.K)
    off = K.copy()
    for i in range(N):
        off[i * m:(i + 1) * m, i * m:(i + 1) * m] = 0.0
    if np.abs(off).max(initial=0.0) != 0.0:
        raise ValueError("simulate_batch requires a block-diagonal prior K")
    return N, m


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two long) as a fixed pairwise
    tree of elementwise adds: the same rounding on every device."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


# ---------------------------------------------------------------------------
# the random baseline's stream: JAX's threefry2x32 (jax._src.prng), on int64
# arrays or tensors that hold uint32 values
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_GUMBEL_CHUNK = 32          # steps of Gumbels made at a time on the device
_TINY32 = float(np.finfo(np.float32).tiny)


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x1, x2) under
    the key (k1, k2), elementwise with broadcasting: JAX's
    ``threefry2x32_p``, on int64 numpy arrays or tensors holding uint32
    values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = x1 ^ (((x2 << r) & _M32) | (x2 >> (32 - r)))
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def prng_key(seed) -> tuple:
    """``jax.random.PRNGKey(seed)`` of a uint32 seed: the words (0, seed)."""
    seed = np.asarray(seed, np.int64) & _M32
    return np.zeros_like(seed), seed


def split(k1, k2) -> tuple:
    """``jax.random.split(key)`` (two keys, partitionable layout): the
    (k1, k2) words of the first and of the second new key."""
    b1, b2 = threefry2x32(np.asarray(k1)[..., None], np.asarray(k2)[..., None],
                          np.zeros(2, np.int64), np.arange(2, dtype=np.int64))
    return (b1[..., 0], b2[..., 0]), (b1[..., 1], b2[..., 1])


def random_bits(k1, k2, n: int):
    """``jax.random.bits(key, (n,))``'s 32-bit words, keys (k1, k2) tensors
    of any shape: (..., n) int64."""
    idx = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None], torch.zeros_like(idx), idx)
    return b1 ^ b2


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float32 ``uniform(minval=tiny, maxval=1)`` of 32-bit words:
    the top 23 bits as the mantissa of a float in [1, 2), minus 1, then
    ``f * (1 - tiny) + tiny`` (which is f, or tiny for f = 0)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.where(f == 0.0, _TINY32, f)


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float32 ``gumbel`` (mode "low") of 32-bit words:
    ``-log(-log(u))``, each log in float64 rounded once to float32."""
    return -rn(torch.log, -rn(torch.log, uniform(bits)))


def _sub_keys(specs, T: int) -> np.ndarray:
    """(2, B, T) int64: the words of ``sub`` at every step of each random
    episode's key chain (``key, sub = split(key)`` from ``PRNGKey(seed)``),
    zeros for the other policies."""
    rows = [i for i, s in enumerate(specs) if s.policy == "random"]
    out = np.zeros((2, len(specs), T), np.int64)
    if rows:
        k1, k2 = prng_key([specs[i].seed for i in rows])
        for t in range(T):
            (k1, k2), (out[0, rows, t], out[1, rows, t]) = split(k1, k2)
    return out


# ---------------------------------------------------------------------------
# the step loop
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _no_host_sync(dev: torch.device):
    """On the card, any operation that waits for it raises inside the
    block (``torch.cuda.set_sync_debug_mode("error")``); the previous mode
    is restored after.  Nothing on the CPU."""
    if dev.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _capture(body, dev: torch.device) -> torch.cuda.CUDAGraph:
    """``body`` captured once as a CUDA graph, on a side stream and in a
    private memory pool that is freed with the graph.  Capture executes
    nothing.  Not ``torch.cuda.graph``: its synchronize and cache emptying
    would wait on the card at every call."""
    graph = torch.cuda.CUDAGraph()
    main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        # checks this thread's CUDA calls only: another thread's (a
        # profiler's, a caller's) cannot invalidate the capture
        graph.capture_begin(capture_error_mode="thread_local")
        body()
        graph.capture_end()
    main.wait_stream(side)
    return graph


#: the per-step logs: one (B, T) tensor each, a step writes its column
_LOGS = (("obs_model", torch.int64), ("obs_time", torch.float32),
         ("inst", torch.float32), ("cum", torch.float32), ("launch", torch.bool),
         ("model", torch.int64), ("hint", torch.int64), ("device", torch.int64),
         ("start", torch.float32), ("end", torch.float32))


def _step_loop(c: dict, s: dict, T: int, graphed: bool,
               tracer: Tracer = NULL_TRACER) -> dict:
    """Runs the T steps on the tensors of ``c`` (constants, and the batch's
    policies and whether every speed is 1) and ``s`` (state, updated in
    place); returns the per-step logs as (B, T) tensors, and how many steps
    were replayed from the graph and how many ran eagerly (``graph_steps``,
    ``eager_steps``).  No operation here reads a value back to the host.

    A step reads and writes tensors at fixed addresses only: the state in
    place, its column of each log at a step count kept on the device, and
    the ``random`` Gumbels at that count's column of a chunk buffer that is
    refilled before every ``_GUMBEL_CHUNK``-th step.  So with ``graphed``
    (the card) step 0 runs eagerly, the step is then captured once as a
    CUDA graph (span ``capture``) and steps 1 to T - 1 replay it: the same
    kernels on the same tensors, none dispatched from Python.  Otherwise
    every step runs eagerly."""
    B = s["dev_end"].shape[0]
    N, m = c["mu0_b"].shape
    n = N * m
    dev = s["dev_end"].device
    ar = torch.arange(B, device=dev)
    arN = torch.arange(N, device=dev)
    Kb, mu0_b, kdiag_b, cost = c["Kb"], c["mu0_b"], c["kdiag_b"], c["cost"]
    jitter, floor, pending = c["jitter"], c["floor"], c["pending"]
    pid, speed, z_true, z_star = c["pid"], c["speed"], c["z_true"], c["z_star"]
    # by a tensor: CUDA divides by a host scalar through its reciprocal
    num_tenants = torch.full((B,), N, dtype=torch.float32, device=dev)
    is_mdmt = pid == _POLICY_ID["mdmt"]
    is_rr = pid == _POLICY_ID["round_robin"]
    has_mdmt, has_rr, has_random = (p in c["policies"] for p in POLICIES)
    unit_speed = c["unit_speed"]
    minus_one = torch.full((B,), -1, dtype=torch.int64, device=dev)
    warm_len = pending.shape[0]
    P, dot, postmu, postvar, ei = s["P"], s["dot"], s["postmu"], s["postvar"], s["ei"]
    best_raw, has_obs, best_true = s["best_raw"], s["has_obs"], s["best_true"]
    selected = s["selected"]
    dev_end, dev_model, dev_seq = s["dev_end"], s["dev_model"], s["dev_seq"]
    t_prev, cum, gsum = s["t_prev"], s["cum"], s["gsum"]
    rr_ptr, pend_ptr, counter, decisions = (
        s["rr_ptr"], s["pend_ptr"], s["counter"], s["decisions"])
    k = torch.zeros(1, dtype=torch.int64, device=dev)     # the step count
    logs = {key: torch.empty((B, T), dtype=dtype, device=dev) for key, dtype in _LOGS}
    if has_random:
        gumbels = torch.empty((B, _GUMBEL_CHUNK, N), dtype=torch.float32, device=dev)

    def step():
        # -- 1. pop the next event: min (finish time, launch seq) ------------
        emin = dev_end.amin(1)
        active = torch.isfinite(emin)
        tied = dev_end == emin[:, None]
        d = torch.where(tied, dev_seq, _IDLE_SEQ).argmin(1)
        t = torch.where(active, emin, t_prev)
        model = dev_model[ar, d]
        do_obs = active & (model >= 0)
        mi = model.clamp_min(0)
        b = torch.div(mi, m, rounding_mode="floor")
        li = mi - b * m
        z = z_true[ar, mi]

        # -- 2. regret integral up to t (integrand constant between obs) -----
        cum.add_(torch.where(active, gsum * (t - t_prev), 0.0))
        t_prev.copy_(t)

        # -- 3. fold the observation into the block-local GP -----------------
        Pb, dotb = P[ar, b], dot[ar, b]                 # (B, m, m), (B, m)
        K_row = Kb[b, li]                               # (B, m)
        lw = Pb[ar, li]                                 # l @ W[:k]
        la = dotb[ar, li]                               # l . alpha[:k]
        d2 = K_row[ar, li] + jitter - lw[ar, li]        # lw[li] = l . l
        dchol = rn(torch.sqrt, torch.maximum(d2, jitter))
        w_new = (K_row - lw) / dchol[:, None]
        a_new = (z - mu0_b[b, li] - la) / dchol
        P2 = Pb + w_new[:, :, None] * w_new[:, None, :]
        dot2 = dotb + a_new[:, None] * w_new
        obs2, obs3 = do_obs[:, None], do_obs[:, None, None]
        P[ar, b] = torch.where(obs3, P2, Pb)
        dot[ar, b] = torch.where(obs2, dot2, dotb)
        mu_b = torch.where(obs2, mu0_b[b] + dot2, postmu[ar, b])
        var_b = torch.where(
            obs2, torch.clamp_min(kdiag_b[b] - torch.diagonal(P2, dim1=1, dim2=2), 0.0),
            postvar[ar, b])
        postmu[ar, b] = mu_b
        postvar[ar, b] = var_b

        raw_b = best_raw[ar, b]
        raw_b = torch.where(do_obs, torch.maximum(raw_b, z), raw_b)
        best_raw[ar, b] = raw_b
        has_b = has_obs[ar, b] | do_obs
        has_obs[ar, b] = has_b
        true_b = best_true[ar, b]
        best_true[ar, b] = torch.where(do_obs, torch.maximum(true_b, z), true_b)
        gsum.copy_(_tree_sum(z_star - best_true))
        inst = gsum / num_tenants
        # the owner tenant's EI of block b (the only block that moved)
        ei[ar, b] = expected_improvement(
            mu_b, rn(torch.sqrt, var_b),
            torch.where(has_b, raw_b, floor)[:, None])

        # -- 4. decide what to launch on the freed device --------------------
        spd = speed[ar, d]
        any_left = ~selected.all(1)
        if warm_len > 0:
            use_pending = pend_ptr < warm_len
            pend_model = pending[pend_ptr.clamp_max(warm_len - 1)]
        else:
            use_pending = torch.zeros_like(active)
            pend_model = torch.zeros_like(model)
        # the batch's policies and speeds are known on the host: a policy no
        # episode runs takes no operation, and unit speeds no division
        # (cost / 1 is cost)
        if has_mdmt:
            # EIrate over the freed device's costs, by a tensor division as
            # ControlPlane.choose_mdmt divides
            cost_d = cost if unit_speed else cost[None, :] / spd[:, None]
            scores = ftz(ei.view(B, n) / cost_d)
            pick = torch.where(selected, float("-inf"), scores).argmax(1)
            hint = minus_one
        if has_rr or has_random:
            free = ~selected.view(B, N, m)
            has_work = free.any(2)
            if has_rr:
                order = (rr_ptr[:, None] + arN[None, :]) % N
                first = has_work.gather(1, order).to(torch.int32).argmax(1)
                u_rr = order[ar, first]
                u_sel = u_rr
            if has_random:
                # categorical(sub, logits): the first argmax of the Gumbels
                # of the tenants with work (tenant 0 when none has any)
                g = gumbels.index_select(1, k % _GUMBEL_CHUNK)[:, 0]
                u_rand = torch.where(has_work, g, float("-inf")).argmax(1)
                u_rand = torch.where(any_left, u_rand, 0)
                u_sel = torch.where(is_rr, u_rr, u_rand) if has_rr else u_rand
            ei_u = torch.where(free[ar, u_sel], ei[ar, u_sel], float("-inf"))
            pick_st = u_sel * m + ei_u.argmax(1)
            if has_mdmt:
                pick = torch.where(is_mdmt, pick, pick_st)
                hint = torch.where(is_mdmt, -1, u_sel)
            else:
                pick, hint = pick_st, u_sel
        model_next = torch.where(use_pending, pend_model, pick)
        hint = torch.where(use_pending, -2, hint)
        launch = active & any_left

        # -- 5. launch (or retire the device slot) ---------------------------
        t_end = t + (cost[model_next] if unit_speed else cost[model_next] / spd)
        dev_end[ar, d] = torch.where(
            launch, t_end, torch.where(active, float("inf"), dev_end[ar, d]))
        dev_model[ar, d] = torch.where(
            active, torch.where(launch, model_next, -1), dev_model[ar, d])
        dev_seq[ar, d] = torch.where(
            launch, counter, torch.where(active, _IDLE_SEQ, dev_seq[ar, d]))
        selected[ar, model_next] = selected[ar, model_next] | launch
        if has_rr:
            rr_ptr.copy_(torch.where(launch & ~use_pending & is_rr, (u_rr + 1) % N, rr_ptr))
        pend_ptr.add_(use_pending & launch)
        counter.add_(launch)
        decisions.add_(active & ~use_pending)

        for key, val in (("obs_model", torch.where(do_obs, model, -1)),
                         ("obs_time", t), ("inst", inst), ("cum", cum),
                         ("launch", launch), ("model", model_next),
                         ("hint", hint), ("device", d), ("start", t),
                         ("end", t_end)):
            logs[key].index_copy_(1, k, val[:, None])
        k.add_(1)

    graph, route = None, {"graph_steps": 0, "eager_steps": 0}
    for i in range(T):
        if has_random and i % _GUMBEL_CHUNK == 0:
            span = slice(i, i + _GUMBEL_CHUNK)
            fresh = gumbel(random_bits(c["sub"][0][:, span], c["sub"][1][:, span], N))
            gumbels[:, :fresh.shape[1]] = fresh
        if graph is not None:
            graph.replay()
            route["graph_steps"] += 1
            continue
        step()
        route["eager_steps"] += 1
        if graphed:
            with tracer.span("capture"):
                graph = _capture(step, dev)

    out = dict(logs)
    out["decisions"] = decisions
    out["end_time"] = t_prev
    return out, route


def _trial_logs(steps: dict, n: int) -> dict:
    """(B, n) launch-ordered trial logs from the per-step launch records:
    trial j of an episode is its j-th launching step."""
    launch = steps["launch"]
    order = np.argsort(~launch, axis=1, kind="stable")[:, :n]
    took = np.take_along_axis(launch, order, axis=1)
    fill = {"model": -1, "hint": -2, "device": -1, "start": 0.0, "end": 0.0}
    return {k: np.where(took, np.take_along_axis(steps[k], order, axis=1), v)
            for k, v in fill.items()}


def simulate_batch(
    problem: Problem,
    specs,
    warm_start: int = 2,
    jitter: float = DEFAULT_JITTER,
    *,
    device=None,
    tracer: Tracer = NULL_TRACER,
) -> BatchResult:
    """Run a batch of TSHB episodes as one stream of batched tensor steps.

    Args:
      problem: a tenant-major block-structured :class:`Problem` (all three
        generators in ``tenancy.py`` qualify).
      specs: sequence of :class:`EpisodeSpec`.
      warm_start: fastest-models-per-tenant warm start (Section 6.1; same
        semantics as ``scheduler.simulate``, shared by the whole batch).
      device: where the tensors live; ``None`` is the card (raises without
        one), ``"cpu"`` runs the same arithmetic on the CPU.
      tracer: an enabled :class:`~repro_torch.obs.Tracer` records the
        call's phases as spans; the default records nothing, waits for
        nothing and leaves the call's operations as they are.

    Returns:
      :class:`BatchResult` with launch-ordered trial logs, event-ordered
      regret curves, and per-episode accounting.  ``wall_seconds`` runs from
      the upload of the inputs to the logs on the host: the step loop and
      both copies, not the host-side checks before them.  On the card the
      first call of a process also carries CUDA's warm-up (context, the
      first launch of each operation), where the reference's carries its
      jit compile.

    Spans, in order, under the root ``simulate_batch`` (attrs ``episodes``
    B, ``models`` n, ``steps`` T, ``policies`` sorted): ``validate``,
    ``block_shape``, ``pack`` (the host arrays), ``sub_keys`` (the
    ``random`` key chains), ``upload`` (attr ``bytes_h2d``: the bytes sent
    to the device), ``loop`` (attrs ``steps``: the host's dispatch of the T
    steps; ``graph_steps``: those replayed from a CUDA graph, T - 1 on the
    card and 0 on the CPU; ``eager_steps``: those dispatched op by op; on
    the card its one child ``capture`` covers the graph's capture and
    instantiation), ``drain`` (``tracer.sync`` on the logs: how far the
    device lags the host), ``copy_back`` (attr ``bytes_d2h``),
    ``trial_logs`` and ``assemble``.  With tracing on, ``wall_seconds`` is
    ``upload`` + ``loop`` + ``drain`` + ``copy_back``.
    """
    specs = tuple(specs)
    if not specs:
        raise ValueError("specs must be non-empty")
    dev = resolve(device)
    n = problem.num_models
    B = len(specs)
    Mmax = max(s.num_devices for s in specs)
    T = n + Mmax
    with tracer.span("simulate_batch", episodes=B, models=n, steps=T,
                     policies=tuple(sorted({s.policy for s in specs}))):
        with tracer.span("validate"):
            problem.validate()
        with tracer.span("block_shape"):
            N, m = _block_shape(problem)

        with tracer.span("pack"):
            K = np.asarray(problem.K, np.float32)
            Kb = np.stack([K[i * m:(i + 1) * m, i * m:(i + 1) * m] for i in range(N)])
            kdiag_b = np.stack([np.diag(Kb[i]) for i in range(N)])
            mu0_b = np.asarray(problem.mu0, np.float32).reshape(N, m)
            cost = np.asarray(problem.cost, np.float32)
            pending = np.asarray(warm_start_queue(problem, warm_start), np.int64)
            floor = no_obs_floor(problem)

            policy_id = np.asarray([_POLICY_ID[s.policy] for s in specs], np.int64)
            num_devices = np.asarray([s.num_devices for s in specs], np.int64)
            speeds = np.ones((B, Mmax), np.float32)
            for i, s in enumerate(specs):
                if s.device_speeds is not None:
                    speeds[i, :s.num_devices] = np.asarray(s.device_speeds, np.float32)
            z_true_b = np.stack([
                np.asarray(s.z_true if s.z_true is not None else problem.z_true,
                           np.float32)
                for s in specs])
            if z_true_b.shape != (B, n):
                raise ValueError(f"per-episode z_true must have shape ({n},)")
            mem = np.asarray(problem.membership, bool)
            z_star_b = np.where(mem[None], z_true_b[:, None, :], -np.inf).max(-1)
            worst_b = np.where(mem[None], z_true_b[:, None, :], np.inf).min(-1)
            # device slots: finish time and launch-seq tiebreak; the t=0 fill
            # order is the free-stack pop order M-1, M-2, ..., 0
            dev_ids = np.arange(Mmax)
            alive = dev_ids[None, :] < num_devices[:, None]
            dev_end = np.where(alive, 0.0, np.inf).astype(np.float32)
            dev_seq = np.where(alive, -1 - dev_ids[None, :], _IDLE_SEQ).astype(np.int64)
            # tenants padded to a power of two for the pairwise sum (gap 0 there)
            Np = 1 << (N - 1).bit_length()
            pad = ((0, 0), (0, Np - N))
            z_star_p = np.pad(z_star_b.astype(np.float32), pad)
            worst_p = np.pad(worst_b.astype(np.float32), pad)
        with tracer.span("sub_keys"):
            sub_keys = _sub_keys(specs, T)

        t0 = _time.perf_counter()
        # the arrays below, and jitter and floor as float32 scalars
        sent = (Kb, mu0_b, kdiag_b, cost, pending, policy_id, speeds, z_true_b,
                z_star_p, sub_keys, dev_end, dev_seq, worst_p)
        with tracer.span("upload", bytes_h2d=sum(a.nbytes for a in sent) + 2 * 4):
            up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
            c = dict(Kb=up(Kb), mu0_b=up(mu0_b), kdiag_b=up(kdiag_b), cost=up(cost),
                     pending=up(pending), pid=up(policy_id), speed=up(speeds),
                     z_true=up(z_true_b), z_star=up(z_star_p), sub=up(sub_keys),
                     policies={s.policy for s in specs},
                     unit_speed=bool((speeds == 1).all()),
                     jitter=torch.tensor(jitter, dtype=torch.float32, device=dev),
                     floor=torch.tensor(floor, dtype=torch.float32, device=dev))
            mu0_t, var0 = c["mu0_b"], torch.clamp_min(c["kdiag_b"], 0.0)
            s = dict(
                # device slots: finish time, running model, launch-seq tiebreak
                dev_end=up(dev_end),
                dev_model=torch.full((B, Mmax), -1, dtype=torch.int64, device=dev),
                dev_seq=up(dev_seq),
                # the fold's running sums (see the module docstring) and posterior
                P=torch.zeros((B, N, m, m), dtype=torch.float32, device=dev),
                dot=torch.zeros((B, N, m), dtype=torch.float32, device=dev),
                postmu=mu0_t.expand(B, N, m).clone(),
                postvar=var0.expand(B, N, m).clone(),
                ei=expected_improvement(mu0_t, rn(torch.sqrt, var0),
                                        c["floor"]).expand(B, N, m).clone(),
                # policy state
                selected=torch.zeros((B, n), dtype=torch.bool, device=dev),
                best_raw=torch.full((B, N), float("-inf"), dtype=torch.float32, device=dev),
                has_obs=torch.zeros((B, N), dtype=torch.bool, device=dev),
                rr_ptr=torch.zeros(B, dtype=torch.int64, device=dev),
                pend_ptr=torch.zeros(B, dtype=torch.int64, device=dev),
                counter=torch.zeros(B, dtype=torch.int64, device=dev),
                decisions=torch.zeros(B, dtype=torch.int64, device=dev),
                # regret integration (regret.py convention: pre-observation best
                # clamped to the worst in-set value)
                best_true=up(worst_p),
                t_prev=torch.zeros(B, dtype=torch.float32, device=dev),
                cum=torch.zeros(B, dtype=torch.float32, device=dev),
            )
            s["gsum"] = _tree_sum(c["z_star"] - s["best_true"])
        with tracer.span("loop", steps=T) as loop, _no_host_sync(dev):
            steps, route = _step_loop(c, s, T, dev.type == "cuda", tracer)
            if tracer.enabled:
                loop.attrs.update(route)      # the route the steps took
        with tracer.span("drain"):
            tracer.sync(list(steps.values()))
        with tracer.span("copy_back", bytes_d2h=sum(v.nbytes for v in steps.values())):
            steps = {k: v.cpu().numpy() for k, v in steps.items()}
        wall = _time.perf_counter() - t0

        with tracer.span("trial_logs"):
            tr = _trial_logs(steps, n)
        with tracer.span("assemble"):
            tm = tr["model"].astype(np.int32)
            z_log = np.where(
                tm >= 0,
                np.take_along_axis(z_true_b, np.maximum(tm, 0), axis=1),
                np.nan)
            return BatchResult(
                problem=problem, specs=specs, warm_start=warm_start,
                trial_model=tm, trial_user=tr["hint"].astype(np.int32),
                trial_device=tr["device"].astype(np.int32),
                trial_start=tr["start"].astype(np.float32),
                trial_end=tr["end"].astype(np.float32), trial_z=z_log,
                obs_model=steps["obs_model"].astype(np.int32), obs_time=steps["obs_time"],
                inst_regret=steps["inst"], cum_regret=steps["cum"],
                decisions=steps["decisions"].astype(np.int32),
                end_time=steps["end_time"],
                inst0=(z_star_b - worst_b).mean(axis=1),
                wall_seconds=wall)
