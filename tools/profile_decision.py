#!/usr/bin/env python3
"""Where the time of one Algorithm-1 decision goes on the card.

    python3 tools/profile_decision.py [--users 50] [--models 50] [--steps 300]
                                      [--open-world] [--scorer ops|sharded]
                                      [--shards S]

Builds the port's closed-world plane for the Fig-5 problem on the card (or,
with ``--open-world``, an open-world plane that admits the same tenants one
by one with ``add_tenant``; ``--scorer sharded --shards S`` scores over S
logical shards on the card), folds the warm start, and then repeats the
scheduler's steady-state step —
one mdmt decision, then the fold of the chosen model's observation — for
``--steps`` steps (after 50 warm-up steps), twice:

  * under ``torch.profiler``: wall time and device-busy time per step (the
    kernels' and copies' own durations on the card), the card's idle share,
    device operations and copies per step, and the operations that take the
    most device time and host time;
  * with a host clock and a synchronize around each part of the step:
    posterior readout, EIrate scoring with its argmax, and the fold.

Prints one JSON line.  Needs one CUDA card; fails without one, or if the
trace holds no device activity.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--users", type=int, default=50)
    ap.add_argument("--models", type=int, default=50)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--open-world", action="store_true")
    ap.add_argument("--scorer", default="ops", choices=("ops", "sharded"))
    ap.add_argument("--shards", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_decision: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import ControlPlane, synthetic_matern_problem, warm_start_queue
    from repro_torch.kernels import ops

    prob = synthetic_matern_problem(args.users, args.models, seed=0)
    if args.open_world:
        plane = ControlPlane(np.random.default_rng(0), scorer=args.scorer,
                             num_shards=args.shards, device="cuda")
        to_prob = {}             # the plane's global id -> problem index
        for u in range(prob.num_users):
            idx = np.nonzero(prob.membership[u])[0]
            h = plane.add_tenant(prob.K[np.ix_(idx, idx)], prob.mu0[idx],
                                 prob.cost[idx])
            to_prob.update(zip(h.models.tolist(), idx.tolist()))
        to_plane = {v: k for k, v in to_prob.items()}
    else:
        plane = ControlPlane.from_problem(
            prob, np.random.default_rng(0), scorer=args.scorer,
            num_shards=args.shards, device="cuda")
        to_prob = to_plane = {m: m for m in range(prob.num_models)}

    def fold(m: int) -> None:
        plane.record_start(m)
        plane.record_observation(m, float(prob.z_true[to_prob[m]]))

    for m in warm_start_queue(prob, 2):
        fold(to_plane[m])

    def step() -> None:
        fold(plane.choose_mdmt()[0])

    for _ in range(50):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        raise RuntimeError("the trace holds no device activity")
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    by_name, count = Counter(), Counter()
    for e in device:
        by_name[e.name] += e.time_range.elapsed_us()
        count[e.name] += 1
    copies = sum(n for name, n in count.items() if name.startswith("Memcpy"))
    host = Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            host[e.key] += e.self_cpu_time_total

    # the same step, its parts timed on the host clock
    parts = Counter()
    for _ in range(args.steps):
        t0 = time.perf_counter()
        if plane.scorer == "sharded":       # the host cache, as choose_mdmt
            mu, var = plane.gp.posterior_host()
            sd = np.sqrt(var)
        else:
            mu, sd = plane.gp.posterior_sd()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if plane.scorer == "sharded":
            m, _ = plane._sharded.decide(mu, sd, plane._best_t, plane.selected)
        else:
            scores = ops.eirate(mu, sd, plane._best_t, plane._membership_t,
                                plane._cost_t, plane._selected_t)
            m = int(torch.argmax(scores))
        t2 = time.perf_counter()
        fold(m)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        parts["posterior"] += t1 - t0
        parts["score"] += t2 - t1
        parts["fold"] += t3 - t2

    s = args.steps
    print(json.dumps({
        "problem": prob.name, "steps": s, "open_world": args.open_world,
        "scorer": plane.scorer, "shards": args.shards,
        "wall_ms_per_step": wall / s * 1e3,
        "device_busy_ms_per_step": busy_us / s / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_ops_per_step": len(device) / s,
        "copies_per_step": copies / s,
        "top_device_us_per_step": [[k, v / s, count[k] / s]
                                   for k, v in by_name.most_common(8)],
        "top_host_self_us_per_step": [[k, v / s] for k, v in host.most_common(10)],
        "host_clock_ms_per_step": {k: v / s * 1e3 for k, v in parts.items()},
        "card": torch.cuda.get_device_name(0),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
