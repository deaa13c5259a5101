"""Benchmark driver of the port: the JAX package's sections, on the card.

Prints ``name,us_per_call,derived`` CSV rows (``derived`` packs each
table's figure of merit as ``key=value`` pairs joined by ``;``), the JAX
package's rows.

  PYTHONPATH=src python -m repro_torch.benchmarks.run [section ...] [--smoke]

Sections (default: all):
  fig2      single-device policy comparison, Azure + DeepLearning
  fig3      device-count sweep for MM-GP-EI
  fig4      policy comparison on four devices
  fig5      synthetic Matérn near-linear-speedup sweep
  control   control-plane microbenchmarks: EIrate (kernel 2) and the GP
            readout (kernel 1) beside their plain versions, the
            incremental-GP engines (control_plane)
  stream    streaming control plane under tenant churn, decision latency at
            |L| = 10k (stream_churn)
  shard     sharded scoring plane: decision latency vs |L| x shard count
            (shard_scale)
  devchurn  elastic device plane: batched vs sequential assignment cost,
            device-aware vs speed-oblivious regret, autoscale (device_churn)
  eventlog  event-sourced durability: incremental vs full compaction pause,
            snapshot/restore/log-append cost (eventlog)
  dtrace    span-level cost attribution of one sharded decision + the
            disabled-tracer overhead bar (decision_trace)
  obs       the all-planes-disabled per-event site stack as a share of a
            decision (< 1% bar) + per-plane enabled costs (obs_overhead)
  capacity  weak-scaling-gap decomposition into per-shard skew / gather /
            dispatch (>= 80% attributed bar at S = 8), per-shard skew,
            accounting-sample cost (capacity)
  chaos     failure-domain hardening: hardened engine vs failure-free twin
            regret bound + unsupervised stranding baseline (chaos)
  roofline  the data-plane dry run's roofline, one row per probe record
            that ``python -m repro_torch.launch.dryrun --probe`` wrote
            (``roofline_missing`` without one); needs no card

The sharded sections (shard, dtrace, obs, capacity) put every logical
shard on the one card: they measure one controller walking S shard slices,
not an S-card mesh.

Each section also records its rows to ``BENCH_torch_<suite>.json`` in the
working directory (e.g. BENCH_torch_control_plane.json), stamped with the
card's name, count, CUDA version, and driver version and power limit;
``python -m repro_torch.benchmarks.regress`` compares two such runs.
Every section runs on the card; without one the sections fail (the
section functions take ``device="cpu"``).

Flags (forwarded to the figure modules):
  --engine {event,batched}   ``event`` is the host event loop; ``batched``
                             runs the episodes as batched tensor steps
                             (repro_torch.core.simulate_batch; rows tagged
                             engine=batched, us_per_call a batch's wall
                             per episode).
  --seeds S                  seeds (fig5: repeats) per configuration.

Set BENCH_FAST=1, or pass --smoke, for a quick pass (toy shapes, fewer
seeds and device counts).
"""

from __future__ import annotations

import argparse
import importlib
import sys
import traceback

from . import common
from .common import positive_int

# section -> module of this package
MODULES = {
    "fig2": "fig2_single_device", "fig3": "fig3_multi_device",
    "fig4": "fig4_four_devices", "fig5": "fig5_synthetic_speedup",
    "control": "control_plane", "stream": "stream_churn",
    "shard": "shard_scale", "devchurn": "device_churn",
    "eventlog": "eventlog", "dtrace": "decision_trace",
    "obs": "obs_overhead", "capacity": "capacity", "chaos": "chaos",
    "roofline": "roofline",
}

SECTIONS = tuple(MODULES)

# section -> BENCH_<suite>.json written next to the CSV: the JAX package's
# suite name with ``torch_`` in front, so the two never share a file
SUITE_NAMES = {s: "torch_" + (s if s.startswith("fig") else m)
               for s, m in MODULES.items()}

#: derived keys that are host-clock times, or ratios of them, by section.
#: They differ from run to run and between the card and the CPU; every
#: other derived key is a count, a shape or a value the decisions fix,
#: equal on either device and to the JAX package's on the same inputs.
HOST_TIME_KEYS = {
    "control": (),
    "stream": ("us_per_decision", "wall_s"),
    "shard": ("speedup", "eff"),
    "devchurn": ("wall_s",),
    "eventlog": ("total_us", "max_over_full", "in_memory_us", "plain_s",
                 "durable_s", "overhead_pct"),
    "chaos": ("wall_s",),
    "dtrace": ("readout_us", "score_topk_us", "gather_pick_us", "fused_us",
               "attributed_pct", "bare_us", "wrapped_us", "paired_delta_pct",
               "overhead_pct"),
    "obs": ("bare_us", "overhead_pct"),
    "capacity": ("readout_us", "score_us", "gather_us", "dispatch_us",
                 "base_us", "gap_us", "skew_us", "allgather_us",
                 "attributed_pct", "max_us", "min_us", "skew",
                 "per_shard_us"),
    "roofline": (),
}


def comparable(section: str, rows) -> list[tuple[str, list]]:
    """``common.capture_rows``'s rows without what a clock decides: each
    row's name and its derived pairs, in order, less ``us_per_call`` and
    the section's :data:`HOST_TIME_KEYS`."""
    host = set(HOST_TIME_KEYS[section])
    return [(name, [(k, v) for k, v in pairs if k not in host])
            for name, _, pairs in rows]


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.run",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("sections", nargs="*", metavar="section",
                   help=f"sections to run: {', '.join(SECTIONS)} "
                        "(default: all)")
    p.add_argument("--engine", choices=("event", "batched"), default="event",
                   help="episode engine for fig2-5 (default: event)")
    p.add_argument("--seeds", type=positive_int, default=None,
                   help="seeds per configuration for fig2-5")
    p.add_argument("--smoke", action="store_true",
                   help="toy shapes for every section (sets BENCH_FAST=1 "
                        "before the sections run)")
    # strict parse: run declares every flag the figure modules accept, so a
    # typo'd flag fails here instead of silently running defaults
    args = p.parse_args(argv)
    bad = [s for s in args.sections if s not in SECTIONS]
    if bad:
        p.error(f"unknown section(s) {bad}; choose from {', '.join(SECTIONS)}")
    return args


def main() -> None:
    args = _parse_args()
    if args.smoke:
        # must precede the figure modules' import: they bind common.FAST then
        common.set_fast(True)
    want = list(args.sections) or list(MODULES)
    print("name,us_per_call,derived")
    failures = []
    for section in want:
        try:
            m = importlib.import_module(f"{__package__}.{MODULES[section]}")
            common.begin_suite(SUITE_NAMES[section])
            m.main()
            path = common.end_suite()
            if path is not None:
                print(f"# wrote {path}", file=sys.stderr)
        except Exception:
            common.abort_suite()   # partial rows are not written
            failures.append(section)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"benchmark sections failed: {failures}")


if __name__ == "__main__":
    main()
