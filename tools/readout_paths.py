#!/usr/bin/env python3
"""Times the GP readout's kernels against each other on the same inputs,
on one card.

    python3 tools/readout_paths.py [ROUNDS]

Each shape (k, n, S) is a W of k rows and S n columns read as S column
slices of n columns (row stride S n), as the sharded scorer's
``readout_decide_topk`` reads its shards: the timed launches take the S
slices in turn, so for S > 1 no slice is still in L2 from its last
launch.  S = 1 is a packed W.  The shapes: the Fig-5 episode's
per-tenant blocks (50, 50) and (20, 50); the dense episode's (200,
2,048) and (512, 2,500); the sharded scorer's slices at k 1,024 of an
8,192- to 100,000-column W over 4 and 2 shards; k 64 to 1,024 at n
40,000 and 100,000, service size (1,024, 100,000) among them.

Every path whose layout rule the inputs meet (slab: k n + k + 2n <=
12,288 floats; bulk and bulk_deep: 16-byte aligned rows, n a multiple of
4; column: any) is launched through the C interface with that path
forced, checked bit-equal to
``ref.gp_readout_ref`` on every slice, and timed alone (device time under
torch.profiler, the mean a launch), the paths in turns (in order, then
reversed) over ``ROUNDS`` rounds (default 3).  Prints one JSON line per
shape with each path's median, the path the wrapper takes
(``gp_readout.path`` with this card's SM count) and the fastest, then the
empty kernel's device time (the launch floor,
``chip_smoke.launch_floor_ms``) and the card's name and power limit as
``nvidia-smi`` reports them.  For a packed W of 10^7 floats or more, the
line also holds ``read_ms``: CUDA-event times (``chip_smoke.cuda_ms``,
back-to-back calls, so the host's dispatch hides behind the card) of the
path the wrapper takes and of two PyTorch calls that read the same W once,
``torch.mv(W.T, alpha)`` and ``W.sum(0)``: what the card's own libraries
reach on those bytes.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.kernels import gp_readout, ref  # noqa: E402

# (k, n, S): S column slices of n columns
SHAPES = ((50, 50, 1), (20, 50, 1), (200, 2048, 1), (512, 2500, 1), (512, 2500, 4),
          (1024, 2048, 4), (1024, 4096, 4), (1024, 8192, 4), (1024, 16_384, 4),
          (1024, 25_000, 4), (1024, 32_768, 2), (1024, 50_000, 2),
          (64, 40_000, 1), (128, 40_000, 1), (256, 40_000, 1), (1024, 40_000, 1),
          (64, 100_000, 1), (256, 100_000, 1), (1024, 100_000, 1))


def allowed(k: int, n: int, ldw: int, base: int) -> list[str]:
    """The paths the layout lets the C interface take."""
    paths = []
    if k * n + k + 2 * n <= gp_readout.SLAB_FLOATS:
        paths.append("slab")
    if n % 4 == 0 and ldw % 4 == 0 and base % 16 == 0:
        paths += ["bulk", "bulk_deep"]
    return paths + ["column"]


def main() -> int:
    if not torch.cuda.is_available():
        print("readout_paths: no CUDA device is available", file=sys.stderr)
        return 2
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = gp_readout._launcher()
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for k, n, S in SHAPES:
        full = torch.randn((k, S * n), generator=gen, device=dev) * 0.3
        slices = []
        for s in range(S):
            W = full[:, s * n:(s + 1) * n]
            alpha = torch.randn(k, generator=gen, device=dev)
            mu0 = torch.randn(n, generator=gen, device=dev)
            kd = (W * W).sum(0) + 1.0
            slices.append((W, alpha, mu0, kd, torch.empty_like(mu0), torch.empty_like(mu0),
                           ref.gp_readout_ref(W, alpha, mu0, kd)))
        ldw = S * n

        turn = [0]

        def launch_one(p: str) -> None:
            """The next slice in turn."""
            W, alpha, mu0, kd, mu, var, _ = slices[turn[0] % S]
            turn[0] += 1
            err = fn(W.data_ptr(), alpha.data_ptr(), mu0.data_ptr(), kd.data_ptr(),
                     mu.data_ptr(), var.data_ptr(), k, n, ldw, 0,
                     gp_readout.PATHS.index(p), stream)
            cs.check(err == 0, f"readout ({k}, {n}, {S}) path {p}: cudaError {err}")

        paths = allowed(k, n, ldw, full.data_ptr())
        for p in paths:
            for _ in range(S):
                launch_one(p)
            torch.cuda.synchronize()
            cs.check(all(torch.equal(mu, want[0]) and torch.equal(var, want[1])
                         for *_, mu, var, want in slices),
                     f"readout ({k}, {n}, {S}) path {p} differs from the plain version")
        times = {p: [] for p in paths}
        iters = 200 if k * n <= 10**6 else 20
        for r in range(rounds):
            for p in (paths if r % 2 == 0 else paths[::-1]):
                times[p].append(cs.device_ms(lambda: launch_one(p), "gp_readout_kernel",
                                             iters * S))
        med = {p: statistics.median(t) for p, t in times.items()}
        picked = gp_readout.path(k, n, ldw, full.data_ptr(), sms=sms)
        line = dict(k=k, n=n, slices=S, alone_ms=times, median_ms=med, picked=picked,
                    fastest=min(med, key=med.get),
                    bytes_bound_ms=k * n * 4 / cs.HBM_BYTES_PER_S * 1e3)
        if S == 1 and k * n >= 10**7:
            W, alpha = slices[0][:2]
            line["read_ms"] = {picked: cs.cuda_ms(lambda: launch_one(picked), 50),
                               "torch.mv": cs.cuda_ms(lambda: torch.mv(W.T, alpha), 50),
                               "sum": cs.cuda_ms(lambda: W.sum(0), 50)}
        print(json.dumps(line), flush=True)
    cs.empty_probe(_build)
    print(json.dumps(dict(sms=sms, launch_floor_ms=cs.launch_floor_ms())), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
