"""Event-sourced control plane costs.

The port of the JAX package's ``benchmarks/eventlog.py``.  Four
measurements:

* ``eventlog_compact_full`` vs ``eventlog_compact_incremental`` — the
  pause bound: one stop-the-world ``compact()`` rebalance on a churned
  128-tenant plane, against the same rebalance split into ``max_moves=1``
  passes.  The figure of merit is the MAX per-pass pause — the longest
  stall any single decision sees — which must sit strictly below the
  full-compaction pause (asserted at full shapes, as the reference does).

* ``eventlog_snapshot`` / ``eventlog_restore`` — the price of durability
  at a boundary: one full-state snapshot through ``checkpoint.store`` of a
  churned streaming engine, and one ``recover()`` (arrays + GP replay)
  from it.

* ``eventlog_append_processed`` — the per-event write-through cost of the
  durable log (vs the in-memory default, recorded in the same row).

* ``eventlog_end_to_end_overhead`` — everything together: the same churn
  trace replayed with durability off and with a durable log +
  every-32-events snapshots; the derived figure is the percent overhead.

The streaming engines score over 4 shard spans with kernel 2 and read the
posterior with kernel 1, all on one device.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np

from ..core import ControlPlane
from ..core.fleet import Fleet
from ..core.tenancy import _matern_block_chol
from ..device import resolve
from ..stream import EventLog, StreamEngine, poisson_churn_trace, recover
from . import common
from .common import emit, time_us, timed


def _churned_plane(tenants: int, m: int, shards: int, device) -> ControlPlane:
    """The shard_scale compaction scenario: every other tenant retired, so
    spans are skewed and many blocks are movable (and seeded, so the full
    and incremental modes start from identical layouts)."""
    K_block, _ = _matern_block_chol(m, 0.2, 0.04)
    cp = ControlPlane(np.random.default_rng(0), model_capacity=tenants * m,
                      tenant_capacity=tenants, num_shards=shards,
                      device=device)
    handles = [cp.add_tenant(K_block, np.zeros(m), np.ones(m))
               for _ in range(tenants)]
    rng = np.random.default_rng(1)
    for h in handles:
        g = int(h.models[rng.integers(m)])
        cp.record_start(g)
        cp.record_observation(g, float(rng.uniform()))
    for t in range(0, tenants, 2):
        cp.retire_tenant(t)
    return cp


def bench_compaction_modes(device=None) -> None:
    dev = resolve(device)
    fast = common.FAST
    tenants = 16 if fast else 128
    m, shards = 16, 8

    cp = _churned_plane(tenants, m, shards, dev)
    full_s, remap = timed(cp.compact, 1.05)
    full_us = full_s * 1e6

    cp2 = _churned_plane(tenants, m, shards, dev)
    pass_us: list[float] = []
    moves = 0
    while True:
        pass_s, r = timed(cp2.compact, 1.05, max_moves=1)
        if not r:
            break
        pass_us.append(pass_s * 1e6)
        moves += len(r)
        assert len(pass_us) < 10 * tenants, "incremental compaction diverged"
    inc_max = max(pass_us)

    emit("eventlog_compact_full", full_us, tenants_live=tenants // 2,
         moves=len(remap), shards=shards,
         imbalance_after=f"{cp._layout.imbalance():.2f}")
    emit("eventlog_compact_incremental", inc_max, tenants_live=tenants // 2,
         passes=len(pass_us), moves=moves,
         total_us=f"{sum(pass_us):.1f}",
         max_over_full=f"{inc_max / full_us:.3f}",
         imbalance_after=f"{cp2._layout.imbalance():.2f}")
    # the pause bound, at full shapes only (the reference's rule: a
    # 16-tenant pass moves too few blocks for the gap to clear timing noise)
    assert fast or inc_max < full_us, (
        f"incremental max pause {inc_max:.0f}us >= full pause {full_us:.0f}us")


def _trace_and_factory(device):
    sessions = 20 if common.FAST else 120
    trace = poisson_churn_trace(
        num_sessions=sessions, arrival_rate=1.0, seed=0,
        m_min=2, m_max=16, session_scale=25.0, num_failure_slices=2)

    def make(**kw):
        return StreamEngine(Fleet.partition_pod(256, 8), "mdmt", seed=0,
                            max_live_models=120, num_shards=4,
                            compact_every=4, device=device, **kw)
    return trace, make


def bench_snapshot_restore_append(device=None) -> None:
    trace, make = _trace_and_factory(resolve(device))
    with tempfile.TemporaryDirectory() as d:
        logdir, snapdir = Path(d) / "log", Path(d) / "snap"
        eng = make(log=EventLog(logdir))
        res = eng.run(trace)
        eng.snapshot_root = str(snapdir)

        iters = 3 if common.FAST else 10
        snap_us = time_us(eng.save_snapshot, iters=iters, warmup=1)
        eng.log.close()

        log = EventLog.load(logdir)
        restore_us = time_us(lambda: recover(make, str(snapdir), log),
                             iters=iters, warmup=1)
        live = int(np.count_nonzero(eng.cp.model_live))
        emit("eventlog_snapshot", snap_us, events=eng.event_index,
             trials=len(res.trials), live_models=live)
        emit("eventlog_restore", restore_us, from_step=eng.event_index,
             trials=len(res.trials), live_models=live)

        durable = EventLog(Path(d) / "bench_log")
        rec = (3, 12.5, "finish", [2, 57, 14])
        n = 200 if common.FAST else 2000
        us_durable = time_us(lambda: durable.append_processed(*rec),
                             iters=n, warmup=10)
        durable.close()
        mem = EventLog()
        us_mem = time_us(lambda: mem.append_processed(*rec),
                         iters=n, warmup=10)
        emit("eventlog_append_processed", us_durable,
             in_memory_us=f"{us_mem:.2f}")


def bench_end_to_end_overhead(device=None) -> None:
    trace, make = _trace_and_factory(resolve(device))
    plain_eng = make()
    plain_s, _ = timed(plain_eng.run, trace)

    with tempfile.TemporaryDirectory() as d:
        eng = make(log=EventLog(Path(d) / "log"),
                   snapshot_root=str(Path(d) / "snap"), snapshot_every=32)
        durable_s, _ = timed(eng.run, trace)
        eng.log.close()
        snapshots = len(list((Path(d) / "snap").glob("step_*")))

    events = eng.event_index
    emit("eventlog_end_to_end_overhead",
         (durable_s - plain_s) / max(events, 1) * 1e6,
         events=events, snapshots=snapshots,
         plain_s=f"{plain_s:.2f}", durable_s=f"{durable_s:.2f}",
         overhead_pct=f"{100 * (durable_s - plain_s) / plain_s:.1f}")


def main(device=None) -> None:
    bench_compaction_modes(device)
    bench_snapshot_restore_append(device)
    bench_end_to_end_overhead(device)


if __name__ == "__main__":
    common.run_standalone("torch_eventlog", main, __doc__)
