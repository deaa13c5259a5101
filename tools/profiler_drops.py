#!/usr/bin/env python3
"""Counts the torch.profiler windows that keep no record of a kernel, on one
CUDA card.

    python3 tools/profiler_drops.py [ROUNDS] [--retry]
    python3 tools/profiler_drops.py --skew SECONDS

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

With ``--skew SECONDS`` it opens windows over the bf16 flash route alone
for that long, without ``device_ms``'s idle ends, and reads where the
card's records fall against the host's events of the same window: the
first kernel's start less the first launch call's start (``lead_us``,
positive when the card starts after the host asks it to), and the last
kernel's end less the end of the closing ``cudaDeviceSynchronize``
(``tail_us``, negative when the kernel ends before the host sees it
end).  Kineto keeps only records inside the window, so a lead below
zero or a tail above it shows the card's mapped timestamps off the
host's clock.  It prints one line for each ten seconds (windows, drops,
and the least, median and largest lead and tail) and a summary.
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


def skew_window(fn, name: str, iters: int) -> dict:
    """One window as ``window`` opens it, with where the card's records of
    ``name`` fall against the host's launch and synchronize events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events
               if name in e.name and e.device_type != torch.autograd.DeviceType.CPU]
    launches = [e for e in events if e.name.startswith(("cudaLaunch", "cuLaunch"))]
    syncs = [e for e in events if e.name == "cudaDeviceSynchronize"]
    out = dict(kept=0 < len(kernels) <= iters)
    if out["kept"] and launches and syncs:
        out.update(lead_us=min(e.time_range.start for e in kernels)
                   - min(e.time_range.start for e in launches),
                   tail_us=max(e.time_range.end for e in kernels)
                   - max(e.time_range.end for e in syncs))
    return out


def quantiles(xs: list) -> list | None:
    return [min(xs), float(np.median(xs)), max(xs)] if xs else None


def skew(seconds: float) -> None:
    """``--skew``: windows over the bf16 flash route for ``seconds``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((2, 2048, h, 128), generator=gen, device=dev).bfloat16()
               for h in (32, 8, 8))
    name = "flash_sm90_kernel"
    t0 = time.perf_counter()
    total = dict(windows=0, dropped=0, lead_us=[], tail_us=[])
    while time.perf_counter() - t0 < seconds:
        bucket = dict(windows=0, dropped=0, lead_us=[], tail_us=[])
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < 10.0 and time.perf_counter() - t0 < seconds:
            w = skew_window(lambda: flash_mod.flash_attention(q, k, v), name, 10)
            for acc in (bucket, total):
                acc["windows"] += 1
                acc["dropped"] += not w["kept"]
                for key in ("lead_us", "tail_us"):
                    if key in w:
                        acc[key].append(w[key])
        print(json.dumps(dict(at_s=time.perf_counter() - t0, windows=bucket["windows"],
                              dropped=bucket["dropped"],
                              lead_us=quantiles(bucket["lead_us"]),
                              tail_us=quantiles(bucket["tail_us"]))), flush=True)
    print(json.dumps(dict(mode="skew", kernel=name, seconds=time.perf_counter() - t0,
                          windows=total["windows"], dropped=total["dropped"],
                          lead_us=quantiles(total["lead_us"]),
                          tail_us=quantiles(total["tail_us"]),
                          torch=torch.__version__)), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_drops: no CUDA device is available", file=sys.stderr)
        return 2
    args = [a for a in sys.argv[1:] if a != "--retry"]
    retry = "--retry" in sys.argv[1:]
    _build.build()
    if args[:1] == ["--skew"]:
        skew(float(args[1]))
        print(nvidia_smi(), flush=True)
        return 0
    rounds = int(args[0]) if args else 50
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
    print(nvidia_smi(), flush=True)
    return 0


def nvidia_smi() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


if __name__ == "__main__":
    sys.exit(main())
