#!/usr/bin/env python3
"""How the service suites' two timing bars read on one CUDA card's host.

    python3 tools/bar_noise.py [REPEATS]

``decision_trace``'s disabled-tracer bar (the span-site stack under 1% of
a decision at |L| 100k, S = 1) and ``capacity``'s weak-gap bar (at least
80% of the S = 8 gap attributed) each hold two host-clock timings against
each other.  This script shows why the port interleaves their loops
(``repro_torch.benchmarks.common.interleaved``):

1. Before importing torch, it times the disabled span-site stack
   (``decision_trace``'s, ``repro_torch.benchmarks.sites``, which imports
   nothing, on a plain-Python null tracer) in 40 windows of
   2,000 calls, back to back: the host's own spread, with no card work in
   the process.
2. Then, REPEATS times (default 6), both bars' inputs at full shapes, taken
   two ways in turn: with the loops one after another, as the reference's
   benchmark runs them, and interleaved in rounds, as the port's does.
   Each line gives the bar's value both ways.

It builds the kernels, prints one JSON line per repeat, a summary, and the
card's name and power limit as ``nvidia-smi`` reports them.  About 35 s
of command time for 16 repeats on an H100.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.benchmarks.sites import decision_sites  # noqa: E402  (imports nothing)


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


class _PlainTracer:
    """A disabled tracer in plain Python, so step 1 imports no torch."""

    enabled = False

    def __init__(self):
        self._null = _Null()

    def begin_trace(self, trace_id):
        return None

    def span(self, name, **attrs):
        return self._null

    def sync(self, x):
        return x


def nothing():
    return None


def window_us(nt, calls=2000, warmup=50):
    for _ in range(warmup):
        decision_sites(nt, nothing)
    t0 = time.perf_counter()
    for _ in range(calls):
        decision_sites(nt, nothing)
    return (time.perf_counter() - t0) / calls * 1e6


def main() -> int:
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    host = [window_us(_PlainTracer()) for _ in range(40)]
    print(json.dumps(dict(step="host_before_torch", windows_us=host,
                          min_us=min(host), median_us=statistics.median(host),
                          max_us=max(host))), flush=True)

    import torch

    from repro_torch import _build
    from repro_torch.benchmarks.common import ROUNDS, interleaved, time_us
    from repro_torch.benchmarks.shard_scale import _setup
    from repro_torch.obs import Tracer
    from repro_torch.obs.profile import dispatch_overhead_us

    if not torch.cuda.is_available():
        print("bar_noise: no CUDA device is available", file=sys.stderr)
        return 2
    _build.build()
    dev = torch.device("cuda")
    sc1, args1 = _setup(100_000, 1, dev)
    gap = {s: _setup(25_000 * s, s, dev) for s in (1, 8)}
    nt = Tracer(enabled=False)

    def overhead_loops():
        return {"bare": (lambda k: time_us(sc1.readout_decide_topk, *args1, iters=k,
                                           warmup=2, sync=True), 30),
                "site": (lambda k: time_us(decision_sites, nt, nothing, 1,
                                           sc1.kernel, iters=k, warmup=50), 2000)}

    def gap_loops():
        loops = {}
        for s, (sc, args) in gap.items():
            loops[(s, "fused")] = (lambda k, sc=sc, args=args: time_us(
                sc.readout_decide_topk, *args, iters=k, warmup=2, sync=True), 20)
            loops[(s, "phases")] = (lambda k, sc=sc, args=args: sc.phase_times(
                *args, iters=k, warmup=2), 20)
            loops[(s, "dispatch")] = (lambda k, sc=sc: dispatch_overhead_us(
                sc.mesh, iters=k), 50)
        return loops

    def bars(us):
        out = ({"overhead_pct": 100.0 * us["site"] / us["bare"],
                "site_us": us["site"], "bare_us": us["bare"]}
               if "bare" in us else {})
        if (1, "fused") in us:
            p1, p8 = us[(1, "phases")], us[(8, "phases")]
            gap_us = us[(8, "fused")] - us[(1, "fused")]
            terms = ((p8["readout_us"] + p8["score_us"] - p1["readout_us"] - p1["score_us"])
                     + (p8["gather_us"] - p1["gather_us"])
                     + (us[(8, "dispatch")] - us[(1, "dispatch")]))
            out["gap_us"] = gap_us
            out["attributed_pct"] = 100.0 * terms / gap_us if gap_us > 0 else 0.0
        return out

    rows = []
    for rep in range(repeats):
        row = {"repeat": rep}
        for order, rounds in (("sequential", 1), ("interleaved", ROUNDS)):
            for what, make in (("overhead", overhead_loops), ("gap", gap_loops)):
                row[f"{what}_{order}"] = bars(interleaved(make(), rounds=rounds))
        rows.append(row)
        print(json.dumps(row), flush=True)

    def fails(key, field, bad):
        return sum(bad(r[key][field]) for r in rows)

    summary = {"repeats": repeats}
    for order in ("sequential", "interleaved"):
        summary[order] = dict(
            overhead_ge_1pct=fails(f"overhead_{order}", "overhead_pct",
                                   lambda v: v >= 1.0),
            overhead_ge_0p5pct=fails(f"overhead_{order}", "overhead_pct",
                                     lambda v: v >= 0.5),
            attributed_lt_80pct=fails(f"gap_{order}", "attributed_pct", lambda v: v < 80.0),
            overhead_pct=[r[f"overhead_{order}"]["overhead_pct"] for r in rows],
            attributed_pct=[r[f"gap_{order}"]["attributed_pct"] for r in rows])
    print(json.dumps(dict(step="summary", **summary)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
