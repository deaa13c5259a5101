#!/usr/bin/env python3
"""Counts the device records that ``torch.profiler`` keeps at the edges of
traced calls of a benchmark cell's sweep, on one CUDA card.

    python3 tools/profiler_edges.py WORKLOAD [--sessions N] [--seed S]
        [--variant graph|keep|eager]

Run from the root of a checkout: the cell, the harness and the program are
read from the working directory, so a copy of an older commit runs its own
program.  The script builds the cell's call as ``bench/systems/sweep.py``
does, makes the warm call under the harness's dispatch counter and three
calls untraced, then traces N calls in profiler sessions of their own, as
``bench/devtrace.py::profile_call`` does: a fill before and after the call
marks its extent on the device.  For each session it prints one JSON line:
the device records and kernels (``devtrace.summarize``), the device
records named ``FillFunctor``, and the first and last device record, each
with its start (end) less the start (end) of the session's first (last)
kernel launch on the host, in microseconds (``lead_us``, ``tail_us``): a
kept marker reads a few microseconds there, a lost one the distance to the
call's first or last own record.  A summary line follows, with the card's
name and power limit as ``nvidia-smi`` reports them.

``--variant`` changes only the step loop's route on the card: ``graph``
(the program as it is), ``keep`` (each call's graph is destroyed after
the card has finished the call, not when the loop returns) and ``eager``
(every step dispatched op by op, as on the CPU).  The two last need a
program whose ``repro_torch.core.sim_batched._step_loop`` captures a
graph.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path.cwd()
LAUNCH = "cudaLaunchKernel"


def edges(events) -> dict:
    """The first and last device record of a session against its first and
    last kernel launch on the host."""
    import torch

    dev, launches = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.name() != "sweep_call":
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif e.name().startswith(LAUNCH):
            launches.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    dev.sort()
    launches.sort()
    last = max(dev, key=lambda r: r[1])
    return {"first": dev[0][2][:60], "lead_us": (dev[0][0] - launches[0][0]) / 1e3,
            "last": last[2][:60], "tail_us": (last[1] - launches[-1][1]) / 1e3,
            "fills": sum("FillFunctor" in r[2] for r in dev)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("workload")
    p.add_argument("--sessions", type=int, default=10)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--variant", choices=("graph", "keep", "eager"), default="graph")
    args = p.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from bench import devtrace
    from bench.run import load_cell
    from bench.systems import sweep
    from repro_torch.core import sim_batched
    from repro_torch.core.sim_batched import EpisodeSpec, simulate_batch
    from repro_torch.core.tenancy import Problem

    held = []
    if args.variant == "keep":
        capture = sim_batched._capture

        def held_capture(body, dev):
            held.append(capture(body, dev))
            return held[-1]
        sim_batched._capture = held_capture
    elif args.variant == "eager":
        loop = sim_batched._step_loop

        def eager_loop(c, s, T, graphed, *rest):
            return loop(c, s, T, False, *rest)
        sim_batched._step_loop = eager_loop

    dev = torch.device("cuda")
    cell = load_cell(ROOT, args.workload)
    cfg, traffic = cell["config"], cell["traffic"]
    gen = sweep.generator(ROOT, cfg)
    inputs = gen.build(cfg, args.seed)
    truth = gen.draw_truth(cfg, inputs, traffic["draws"], args.seed, dev)
    specs = [EpisodeSpec(pol, M, seed=s, z_true=truth[k])
             for pol, M, k, s in sweep.episodes(traffic, args.seed)]
    problem = Problem(K=inputs["K"], mu0=inputs["mu0"], z_true=inputs["z_true"],
                      cost=inputs["cost"], membership=inputs["membership"])

    def call():
        out = simulate_batch(problem, specs, cfg["warm_start"], cfg["jitter"], device=dev)
        if held:            # ``keep``: the card has finished (the copies back waited)
            held.clear()
        return out

    devtrace.count_ops(call, dev.type)
    for _ in range(3):
        call()
    rows = []
    for i in range(args.sessions):
        t0 = time.perf_counter()
        # devtrace.profile_call, with the events kept for ``edges``
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with record_function("sweep_call"):
                mark = torch.zeros(1, device="cuda")
                w0 = time.perf_counter()
                out = call()
                torch.cuda.synchronize()
                window_s = time.perf_counter() - w0
                mark.zero_()
                torch.cuda.synchronize()
        del out
        events = prof.profiler.kineto_results.events()
        s = devtrace.summarize(events, window_s, "sweep_call")
        row = {"session": i, "records": s["records"], "kernels": s["kernels"],
               "launches": s["launches"], **edges(events),
               "host_s": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    counts = [r["records"] for r in rows]
    most = max(set(counts), key=counts.count)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"workload": args.workload, "variant": args.variant,
                      "sessions": len(rows), "records_most": most,
                      "short": [r["session"] for r in rows if r["records"] < most],
                      "long": [r["session"] for r in rows if r["records"] > most],
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
