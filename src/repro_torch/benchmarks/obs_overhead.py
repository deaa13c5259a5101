"""Live-health-plane overhead.

The port of the JAX package's ``benchmarks/obs_overhead.py``.  Two
measurements:

* ``obs_overhead_L{n}_S{s}`` — the engines' per-event live-plane site
  stack with EVERY plane disabled (exporter/health/forensics/metrics all
  ``None``: four attribute loads + ``is not None`` branches, the
  ``_drain`` hot-path sites), timed directly over thousands of iterations
  and expressed as a share of the bare |L| = n decision (kernels 1 and 3,
  each call waited for).  **< 1% at |L| = 100k**, asserted.  The site
  stack itself runs no device work and is timed without a wait.

* ``obs_enabled_*`` — the marginal per-call cost of each plane when it IS
  attached: a non-boundary ``MetricsExporter.tick`` (a window boundary
  pays one registry snapshot + JSON line), a ``HealthMonitor.on_event`` /
  ``on_observation`` detector pass, and a ``ForensicsRecorder.on_decision``
  over a k = 4 top-k.  Host work only.

The |L| sweep takes ``decision_trace``'s points and ``shard_scale``'s
state (every shard on one device).
"""

from __future__ import annotations

import numpy as np

from ..device import resolve
from . import common
from .common import emit, time_us
from .decision_trace import _mesh_sizes, _sizes
from .shard_scale import _setup


def _engine_all_planes_off(device):
    from ..core.fleet import Fleet
    from ..stream import StreamEngine

    eng = StreamEngine(Fleet.partition_pod(16, 1), "mdmt", seed=0,
                       device=device)
    assert (eng.exporter is None and eng.health is None
            and eng.forensics is None and eng.metrics is None)
    return eng


def bench_disabled_sites(device=None) -> None:
    dev = resolve(device)
    fast = common.FAST
    eng = _engine_all_planes_off(dev)

    def sites():
        # the per-event live-plane stack in StreamEngine._drain, all off
        if eng.forensics is not None:
            eng.forensics.begin_event(0.0, 0)
        if eng.metrics is not None:
            pass
        if eng.health is not None:
            eng._health_tick()
        if eng.exporter is not None:
            eng.exporter.tick(0.0, 0)

    iters = 10 if fast else 30
    site_us = time_us(sites, iters=300 if fast else 5000, warmup=50)
    for n in _sizes():
        for s in _mesh_sizes():
            sc, args = _setup(n, s, dev)
            bare_us = time_us(sc.readout_decide_topk, *args,
                              iters=iters, warmup=2, sync=True)
            overhead = 100.0 * site_us / bare_us
            emit(f"obs_overhead_L{n}_S{s}", site_us,
                 live_models=n, shards=s, bare_us=f"{bare_us:.1f}",
                 overhead_pct=f"{overhead:.4f}")
            assert fast or n < 100_000 or overhead < 1.0, (
                f"disabled live-plane stack is {overhead:.2f}% of the "
                f"L={n} S={s} decision (need < 1%)")


def bench_enabled_plane_costs() -> None:
    from ..obs import (ForensicsRecorder, HealthMonitor, MetricsExporter,
                       MetricsRegistry)

    iters = 300 if common.FAST else 5000

    reg = MetricsRegistry()
    reg.counter("engine.events").inc(10)
    reg.gauge("engine.queue_depth").set(3)
    reg.histogram("engine.decision_seconds").observe(1e-4)
    ex = MetricsExporter(reg, window=10.0)
    ex.tick(0.0, 0)                    # consume the first window boundary
    tick_us = time_us(lambda: ex.tick(1.0, 1), iters=iters, warmup=50)
    emit("obs_enabled_export_tick", tick_us, boundary="no")

    hm = HealthMonitor(slo={"device_utilization": 0.5}, window=1e12)
    summary = {"device_utilization": 0.4}
    ev_us = time_us(
        lambda: hm.on_event(1.0, 1, queue_depth=3, backlog=2,
                            free_classes=("base",),
                            summary_fn=lambda: summary),
        iters=iters, warmup=50)
    emit("obs_enabled_health_event", ev_us, detectors="queue+starve+burn")
    obs_us = time_us(
        lambda: hm.on_observation(1.0, 1, "t0", False, d2=1e-3,
                                  jitter=1e-6),
        iters=iters, warmup=50)
    emit("obs_enabled_health_observation", obs_us, detectors="stall+cond")

    fr = ForensicsRecorder()
    fr.begin_event(0.0, 0)
    vals = np.array([0.4, 0.3, 0.2, 0.1])
    gids = np.arange(4)
    costs = np.ones(4)
    mu = np.zeros(4)
    sd = np.ones(4)

    def decide():
        fr.on_decision(scorer="ops", values=vals, gids=gids,
                       eff_costs=costs, mu=mu, sd=sd)
        fr.records.clear()             # keep the bench allocation-flat

    dec_us = time_us(decide, iters=iters, warmup=50)
    emit("obs_enabled_forensics_decision", dec_us, topk=4)


def main(device=None) -> None:
    bench_disabled_sites(device)
    bench_enabled_plane_costs()


if __name__ == "__main__":
    common.run_standalone("torch_obs_overhead", main, __doc__)
