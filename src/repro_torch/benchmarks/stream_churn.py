"""Streaming control-plane benchmark: GP-EI under tenant churn.

The port of the JAX package's ``benchmarks/stream_churn.py``.  Two
measurements:

* ``stream_churn_end_to_end`` — 200 tenant sessions (N >> M) arriving over
  time onto M = 8 slices with admission control; the figure of merit is
  wall-clock µs per event and µs per scheduler decision, beside the
  service metrics (utilization, queue depth, p99 time to first
  observation) from the telemetry sink.  Each decision reads the posterior
  (kernel 1) and scores with kernel 2.

* ``stream_decision_{fused,ops,sharded}_L10000`` — decision latency at
  service scale: a dynamic ``ControlPlane`` holding |L| = 10k live models
  across 200 tenants, one decision on the hot loop, each call waited for.
  The reference's ``fused`` and ``ops`` scorers are both the port's
  ``"ops"``; so the ``fused`` row times the eager ``core.ei.choose_next``
  (plain PyTorch on the card), the ``ops`` row kernel 2 + argmax, and the
  ``sharded`` row ``ShardedScorer.decide_topk`` (kernel 3) on the host
  posterior the control plane hands it.
"""

from __future__ import annotations

import numpy as np

from ..core import ControlPlane, choose_next
from ..core.fleet import Fleet
from ..core.tenancy import _matern_block_chol
from ..device import resolve
from ..kernels import ops as kops
from ..stream import StreamEngine, poisson_churn_trace
from . import common
from .common import emit, time_us, timed


def bench_end_to_end(device=None) -> None:
    dev = resolve(device)
    sessions = 50 if common.FAST else 200
    trace = poisson_churn_trace(
        num_sessions=sessions, arrival_rate=1.0, seed=0,
        m_min=2, m_max=16, session_scale=25.0, num_failure_slices=2)
    eng = StreamEngine(Fleet.partition_pod(256, 8), "mdmt", seed=0,
                       max_live_models=120, device=dev)
    wall, res = timed(eng.run, trace)
    s = res.telemetry.summary()
    events = trace.num_events + s["trials"]
    emit(
        "stream_churn_end_to_end",
        wall / max(events, 1) * 1e6,
        sessions=sessions,
        slices=8,
        trials=s["trials"],
        decisions=res.decisions,
        us_per_decision=f"{1e6 * res.decision_seconds / max(res.decisions, 1):.0f}",
        admitted=s["sessions_admitted"],
        queue_depth_max=s["queue_depth_max"],
        utilization=f"{s['device_utilization']:.4f}",
        ttfo_p99=f"{s['ttfo_p99']:.1f}" if s["ttfo_p99"] is not None else "na",
        wall_s=f"{wall:.2f}",
    )


def bench_decision_at_scale(device=None) -> None:
    """One EIrate decision at |L| ~ 10k live models (the service-scale bar),
    each call waited for (``time_us(sync=True)``), after warm-up calls that
    keep the lazy kernel build and first library calls out of the loop."""
    dev = resolve(device)
    fast = common.FAST
    tenants = 40 if fast else 200
    m = 50
    K_block, L = _matern_block_chol(m, 0.2, 0.04)
    rng = np.random.default_rng(0)
    for name, scorer in (("fused", "ops"), ("ops", "ops"),
                         ("sharded", "sharded")):
        cp = ControlPlane(np.random.default_rng(0), scorer=scorer,
                          model_capacity=tenants * m, tenant_capacity=tenants,
                          device=dev)
        for _ in range(tenants):
            cp.add_tenant(K_block, np.zeros(m), np.ones(m))
        # a realistic posterior: a few observations per tenant
        for t in range(tenants):
            for li in rng.choice(m, size=3, replace=False):
                g = t * m + int(li)
                cp.record_start(g)
                cp.record_observation(g, float(rng.uniform(0.0, 1.0)))
        n_live = tenants * m

        if name == "fused":
            mu, sd = cp.gp.posterior_sd()

            def decide():
                return choose_next(mu, sd, cp._best_t, cp._membership_t,
                                   cp._cost_t, cp._selected_t)
        elif name == "ops":
            mu, sd = cp.gp.posterior_sd()

            def decide():
                return kops.eirate(mu, sd, cp._best_t, cp._membership_t,
                                   cp._cost_t, cp._selected_t).argmax()
        else:
            # the sharded scorer takes the host posterior, as the control
            # plane hands it over
            mu, sd = cp._posterior_host()

            def decide():
                return cp._sharded.decide_topk(mu, sd, cp._best_t,
                                               cp.selected)

        us = time_us(decide, iters=10 if fast else 30,
                     warmup=2 if fast else 5, sync=True)
        shards = cp._sharded.num_shards if scorer == "sharded" else 1
        emit(f"stream_decision_{name}_L{n_live}", us,
             tenants=tenants, live_models=n_live, shards=shards)


def main(device=None) -> None:
    bench_end_to_end(device)
    bench_decision_at_scale(device)


if __name__ == "__main__":
    common.run_standalone("torch_stream_churn", main, __doc__)
