#!/usr/bin/env python3
"""Counts the torch.profiler windows that keep no record of a kernel, on one
CUDA card.

    python3 tools/profiler_drops.py [ROUNDS] [--retry]

``chip_smoke.py`` times each kernel alone from the profiler's records of
its launches (``chip_smoke.device_ms``).  This script opens ROUNDS x 3
profiler windows in turn, as ``device_ms`` does, over three of the port's
kernels: the bf16 flash route at qwen3-4b's shape (B 2), the EIrate kernel
at the Fig-5 shape and the SSD tensor-core route at mamba2-1.3b's (B 2),
inputs made from a seed.  It prints one JSON line for each window that
kept no record of its kernel (the round, the kernel, how many distinct
event names the window kept, how many of them carry device time), then a
summary line and the card's name and power limit as ``nvidia-smi`` reports
them.  With ``--retry`` it takes the same windows through
``chip_smoke.device_ms`` instead, and the summary lists the windows that
function took again (``chip_smoke.PROFILER_RETRIES``).  The drops depend
on the windows a process has opened before, so each mode runs in a
process of its own.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.kernels import ei_score  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402


def window(fn, name: str, iters: int) -> dict:
    """One profiler window over ``iters`` calls, as ``device_ms`` opens it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    rows = [e for e in averages if name in e.key]
    return dict(kept=len(rows) == 1 and 0 < rows[0].count <= iters
                and rows[0].device_time_total > 0.0,
                counts=[e.count for e in rows], names=len(averages),
                device_names=sum(e.device_time_total > 0.0 for e in averages))


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_drops: no CUDA device is available", file=sys.stderr)
        return 2
    args = [a for a in sys.argv[1:] if a != "--retry"]
    retry = "--retry" in sys.argv[1:]
    rounds = int(args[0]) if args else 50
    _build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((2, 2048, h, 128), generator=gen, device=dev).bfloat16()
               for h in (32, 8, 8))
    ei_args = chip_smoke.ei_inputs(50, 2500, "disjoint", np.random.default_rng(0), dev)
    B, S, H, P, N = 2, 2048, 64, 64, 128
    x = torch.randn((B, S, H, P), generator=gen, device=dev).bfloat16()
    dt = torch.rand((B, S, H), generator=gen, device=dev) * 0.099 + 0.001
    la = -dt * (torch.rand((H,), generator=gen, device=dev) * 1.5 + 0.5)
    b, c = (torch.randn((B, S, N), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    jobs = (("flash_sm90_kernel", lambda: flash_mod.flash_attention(q, k, v), 10),
            ("eirate_kernel", lambda: ei_score.eirate(*ei_args), 200),
            ("ssd_chunk_state_kernel",
             lambda: ssd_mod.ssd_mix(x, dt, la, b, c, chunk=256), 10))
    dropped = {name: 0 for name, _, _ in jobs}
    t0 = time.perf_counter()
    for r in range(rounds):
        for name, fn, iters in jobs:
            if retry:
                chip_smoke.device_ms(fn, name, iters)
                continue
            w = window(fn, name, iters)
            if not w["kept"]:
                dropped[name] += 1
                print(json.dumps(dict(round=r, kernel=name, **w)), flush=True)
    summary = dict(mode="device_ms" if retry else "raw", windows=rounds * len(jobs),
                   seconds=time.perf_counter() - t0, torch=torch.__version__)
    if retry:
        summary["windows_retried"] = chip_smoke.PROFILER_RETRIES
    else:
        summary["windows_without_record"] = dropped
    print(json.dumps(summary), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
