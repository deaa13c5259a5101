"""Observability of the port: the reference's planes (``repro.obs``), with
the same names, records and JSON.

  trace.py      :class:`Tracer` — nestable spans with deterministic ids,
                each record with its wall time and the thread's CPU time
                (``cpu_us``); ``sync`` waits for the card, and the
                profiler bridge is ``torch.profiler.record_function``.
                The batched sweep (``core.sim_batched.simulate_batch``)
                opens a span a phase of a call; under a profiler that
                records CPU activity the bridge puts them in its trace.
  metrics.py    :class:`MetricsRegistry` — counters, gauges and fixed-bucket
                histograms, labeled series.
  export.py     :class:`MetricsExporter` — sim-time-windowed registry
                snapshots to JSONL, and :func:`prometheus_text`.
  health.py     :class:`HealthMonitor` — SLO burn rate and the watchdogs,
                emitting :class:`Alert` records (``ALERT_KINDS``).
  forensics.py  :class:`ForensicsRecorder` — per-decision attribution from
                the top-k the decision already computed.
  accounting.py :class:`CapacityAccountant` — posterior bytes, shard
                occupancy, fleet composition and the projected-bytes feed
                of the memory watchdog.
  report.py     :func:`write_report` — one experiment directory per run.
  profile.py    ``torch.profiler`` capture windows, per-shard skew and the
                sharded launch loop's fixed cost.

Metrics, export, health, forensics, accounting and report are pure Python,
copies of the reference's.  Every plane is observation-only: an engine run
with any of them attached makes the decisions of a bare run, and their
cursors ride in the engine snapshot so a recovered run re-emits the same
suffix (tests/test_torch_obs.py).
"""

from .accounting import CapacityAccountant  # noqa: F401
from .export import MetricsExporter, prometheus_text  # noqa: F401
from .forensics import ForensicsRecorder  # noqa: F401
from .health import ALERT_KINDS, Alert, HealthMonitor  # noqa: F401
from .metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
from .profile import capture, profiler_available  # noqa: F401
from .report import aggregate_spans, write_report  # noqa: F401
from .trace import NULL_TRACER, Tracer  # noqa: F401
