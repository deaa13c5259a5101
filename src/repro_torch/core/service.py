"""Real-executor multi-tenant AutoML service: the paper's system, end to end.

Counterpart of ``repro.core.service``.  Unlike the simulator
(scheduler.py), here z(x) is genuinely unknown until a trial *actually
trains*: each model x = (tenant, architecture) is a reduced config from the
assigned pool trained on that tenant's synthetic dataset, and z is an
accuracy-like score exp(-val_loss).  The control plane is the same: GP
posterior + multi-tenant EIrate (Algorithm 1), with c(x) from the cost
model (Remark 1, on the H100's peaks), updated with measured durations.

The trials train on the device given (``device=None``: the card) through
``train.make_train_step``, on the configs' plain route, as the reference's
trials do.  The GP lives on the same device: every decision reads the
posterior through the readout kernel (``kernels.ops.gp_readout``) there.
The decision's inputs are cast to float32 where the reference's
``jnp.asarray`` casts them, and the argmax takes the first of equal maxima.

Fault tolerance: the service checkpoints its control state (observations,
in-flight set) as JSON after every event; on restart, in-flight trials are
re-queued (their models were never observed, so recovery is trivial).
Fleet slice failures likewise just return the model to the unselected pool.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..configs import get_smoke_config
from ..device import resolve
from .cost_model import CostModel
from .ei import choose_next, single_tenant_ei_scores
from .fleet import Fleet
from .gp import IncrementalGP


@dataclass(frozen=True)
class TenantSpec:
    tenant_id: int
    data_seed: int
    zipf_a: float            # dataset "difficulty" knob


@dataclass
class ServiceConfig:
    steps_per_trial: int = 30
    eval_steps: int = 4
    seq_len: int = 128
    batch: int = 8
    lr: float = 1e-3
    policy: str = "mdmt"     # mdmt | round_robin | random


class RealExecutor:
    """Trains a reduced-config model on the tenant's synthetic dataset, on
    ``device`` (None: the card).  ``init(cfg, seed)`` gives the initial
    parameters on that device; by default the port's ``init_params`` drawn
    on the CPU from a generator seeded with the tenant's data seed, then
    moved, so a trial starts from the same weights on every device."""

    def __init__(self, svc: ServiceConfig, device=None, init=None):
        self.svc = svc
        self.device = resolve(device)
        self.init = init or self._init_params

    def _init_params(self, cfg, seed: int):
        from ..models import init_params
        from ..models.spec import tree_map
        params = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
        return tree_map(lambda t: t.to(self.device), params,
                        lambda x: isinstance(x, torch.Tensor))

    def run(self, tenant: TenantSpec, arch: str) -> tuple[float, float]:
        from ..data.pipeline import DataConfig, SyntheticLMStream
        from ..models.model import forward_loss
        from ..train.optimizer import OptConfig, adamw_init
        from ..train.train_step import TrainState, make_train_step

        t0 = time.perf_counter()
        cfg = get_smoke_config(arch)
        svc = self.svc
        dcfg = DataConfig(seq_len=svc.seq_len, global_batch=svc.batch,
                          seed=tenant.data_seed, zipf_a=tenant.zipf_a)
        stream = SyntheticLMStream(dcfg, cfg)

        def batch_at(step: int) -> dict:
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in stream.batch_at(step).items()}

        params = self.init(cfg, tenant.data_seed)
        opt_cfg = OptConfig(lr=svc.lr, warmup_steps=5,
                            total_steps=svc.steps_per_trial, weight_decay=0.0)
        state = TrainState(params=params, opt=adamw_init(params, opt_cfg))
        step = make_train_step(cfg, opt_cfg)
        for s in range(svc.steps_per_trial):
            state, _ = step(state, batch_at(s))
        with torch.no_grad():
            losses = [float(forward_loss(state.params, batch_at(10_000 + s), cfg))
                      for s in range(svc.eval_steps)]
        val = float(np.mean(losses))
        z = float(np.exp(-val))                  # accuracy-like, in (0, 1]
        return z, time.perf_counter() - t0


@dataclass
class ServiceTrial:
    model: int
    tenant: int
    arch: str
    slice_id: int
    t_start: float
    t_end: float | None = None
    z: float | None = None


class AutoMLService:
    """Event-driven service over a Fleet, MM-GP-EI scheduled; the GP and
    the decisions on ``device`` (None: the card)."""

    def __init__(
        self,
        tenants: list[TenantSpec],
        archs: list[str],
        fleet: Fleet,
        executor,
        svc_cfg: ServiceConfig | None = None,
        prior: tuple[np.ndarray, np.ndarray] | None = None,
        cost_model: CostModel | None = None,
        checkpoint_path: str | None = None,
        seed: int = 0,
        device=None,
    ):
        self.tenants, self.archs, self.fleet = tenants, archs, fleet
        self.executor = executor
        self.svc = svc_cfg or ServiceConfig()
        self.cost_model = cost_model or CostModel()
        self.checkpoint_path = Path(checkpoint_path) if checkpoint_path else None
        self.rng = np.random.default_rng(seed)
        self.device = resolve(device)

        N, A = len(tenants), len(archs)
        self.n = N * A
        mu_a, K_a = prior if prior is not None else (
            np.full(A, 0.5), 0.05 * np.eye(A) + 0.01)
        self.mu0 = np.tile(mu_a, N)
        K = np.zeros((self.n, self.n))
        for i in range(N):
            K[i * A:(i + 1) * A, i * A:(i + 1) * A] = K_a
        self.K = K + 1e-8 * np.eye(self.n)
        self.membership = np.zeros((N, self.n), dtype=bool)
        for i in range(N):
            self.membership[i, i * A:(i + 1) * A] = True

        self.cost = np.array([
            self.cost_model.trial_seconds(
                archs[x % A], "train_4k",
                steps=self.svc.steps_per_trial,
                chips=fleet.slices[0].chips,
                cfg=get_smoke_config(archs[x % A]))
            for x in range(self.n)])

        self.gp = IncrementalGP(self.K, self.mu0, device=self.device)
        self.selected = np.zeros(self.n, bool)
        self.best = np.full(N, -np.inf)
        self.trials: list[ServiceTrial] = []
        self.rr_pointer = 0
        self.t = 0.0

    # -- policies (same math as scheduler.py, unknown z) ----------------------

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array as the reference's ``jnp.asarray`` has it (float64
        cast to float32, bools kept), on the service's device."""
        a = np.asarray(a)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(self.device)

    def _choose(self) -> int | None:
        if self.selected.all():
            return None
        mu, sd = self.gp.posterior_sd()
        best = np.where(np.isfinite(self.best), self.best, float(self.mu0.min()) - 1.0)
        selected = self._on_device(self.selected)
        if self.svc.policy == "mdmt":
            idx, score = choose_next(
                mu, sd, self._on_device(best), self._on_device(self.membership),
                self._on_device(self.cost), selected)
            return int(idx) if np.isfinite(float(score)) else None
        users = np.nonzero((self.membership & ~self.selected[None, :]).any(1))[0]
        if users.size == 0:
            return None
        if self.svc.policy == "random":
            u = int(self.rng.choice(users))
        else:  # round_robin
            u = int(users[np.searchsorted(users, self.rr_pointer % len(self.tenants)) % users.size])
            self.rr_pointer = u + 1
        scores = single_tenant_ei_scores(
            mu, sd, self._on_device(best[u]), self._on_device(self.membership[u]),
            selected)
        m = int(torch.argmax(scores))
        return m if np.isfinite(float(scores[m])) else None

    # -- event loop ------------------------------------------------------------

    def run(self, max_trials: int | None = None) -> list[ServiceTrial]:
        A = len(self.archs)
        budget = max_trials if max_trials is not None else self.n
        launched = 0
        inflight: list[ServiceTrial] = []
        while launched < budget or inflight:
            for s in self.fleet.free_at(self.t):
                if launched >= budget:
                    break
                m = self._choose()
                if m is None:
                    break
                tenant, arch = self.tenants[m // A], self.archs[m % A]
                z, wall = self.executor.run(tenant, arch)
                dur = wall / s.speed
                tr = ServiceTrial(m, tenant.tenant_id, arch, s.slice_id,
                                  self.t, self.t + dur, z)
                self.selected[m] = True
                s.current_trial = len(self.trials)
                s.busy_until = self.t + dur
                self.trials.append(tr)
                inflight.append(tr)
                launched += 1
                self.cost_model.observe(arch, "train_4k", s.chips, wall)
            if not inflight:
                break
            # advance to next completion
            inflight.sort(key=lambda tr: tr.t_end)
            tr = inflight.pop(0)
            self.t = tr.t_end
            self.gp.observe(tr.model, tr.z)
            u = tr.model // A
            self.best[u] = max(self.best[u], tr.z) if np.isfinite(self.best[u]) else tr.z
            self.fleet.slices[tr.slice_id].current_trial = None
            self._checkpoint()
        return self.trials

    # -- fault tolerance --------------------------------------------------------

    def _checkpoint(self):
        if self.checkpoint_path is None:
            return
        state = {
            "t": self.t,
            "observations": {str(i): self.gp._z[i] for i in self.gp.observed},
            "selected": self.selected.tolist(),
        }
        tmp = self.checkpoint_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(state))
        tmp.rename(self.checkpoint_path)

    def restore(self):
        """Re-apply observations; un-select in-flight (never-observed) models."""
        if self.checkpoint_path is None or not self.checkpoint_path.exists():
            return False
        state = json.loads(self.checkpoint_path.read_text())
        A = len(self.archs)
        self.t = state["t"]
        for k, z in state["observations"].items():
            m = int(k)
            self.gp.observe(m, z)
            self.selected[m] = True
            u = m // A
            self.best[u] = max(self.best[u], z) if np.isfinite(self.best[u]) else z
        # anything selected-but-not-observed was in flight during the crash
        observed = set(self.gp.observed)
        for m, was in enumerate(state["selected"]):
            if was and m not in observed:
                self.selected[m] = False   # re-queue
        return True


def estimate_prior(archs: list[str], prior_tenants: list[TenantSpec],
                   executor) -> tuple[np.ndarray, np.ndarray]:
    """The paper's protocol: isolate a few tenants, fit prior mean/cov."""
    rows = []
    for t in prior_tenants:
        rows.append([executor.run(t, a)[0] for a in archs])
    acc = np.asarray(rows)
    mu = acc.mean(axis=0)
    K = np.cov(acc, rowvar=False) if len(rows) > 1 else 0.05 * np.eye(len(archs))
    K = K + 1e-4 * np.eye(len(archs))
    return mu, K
